"""PyTorch port, ``--plan`` on the trainers (``train/composed.py``, ``train/lm.py``) against
the JAX package's planner.

- World 1 on the CPU: ``--plan auto`` picks a layout, saves ``plan_<run_type>.json``, emits
  the ``plan`` telemetry event beside the manifest of the planned mesh, and its plan is the
  JAX planner's on the same scenario and the recorded topology; replaying the file trains
  bitwise as the planned run; a plan pinning a layout trains bitwise as the plan-less run
  with that layout given by hand; ``--plan tune`` records a measured step for each of the
  top three candidates (the trainer's own step) with their ``autotune`` events; the LM
  trainer plans (auto and tune) at a tiny width.
- A gloo world of 2 on the CPU (the port's launcher): ``--plan auto`` under
  ``PLAN_HBM_BYTES`` (a tight budget, so the composed trainer's pick shards: TP with
  gradient accumulation) trains bitwise as the same run with the plan's mesh pinned, its
  plan is the JAX planner's on the recorded topology, and ``--plan tune`` degrades to
  ``auto`` with the JAX package's warning.

Tiny widths: the composed trainer at seq 16 (embed 64, 2 layers), the LM at embed 16 with
one layer; 64 synthetic training examples. Comparisons are exact.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from csed_514_project_distributed_training_using_pytorch_tpu import plan as jax_plan
from csed_514_project_distributed_training_using_pytorch_tpu.utils import (
    config as jax_config,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch import plan
from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import mnist
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import composed
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import lm as lm_train
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import config
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.jsonl import (
    read_jsonl,
)

import torch_port_fleet as fleet

N_TRAIN, N_TEST = 64, 16
KW = dict(batch_size=16, batch_size_test=16, seq_len=16, epochs=1, seed=3,
          learning_rate=0.05)
LM_KW = dict(epochs=1, batch_size=8, max_train_examples=32, max_test_examples=10,
             eval_batch=10, embed_dim=16, num_layers=1, num_heads=2, generate=0)
COMPOSED_HBM = 1_500_000      # world 2: TP with grad accumulation is the pick

CHILD_2 = """
from {pkg} import plan
from {pkg}.parallel import mesh
from {pkg}.train import composed
from {pkg}.utils import config
base = {base!r}
saved = {{}}
with mesh.cluster("cpu"):            # one group for every run
    os.environ["PLAN_HBM_BYTES"] = "{composed_hbm}"
    state, hist = composed.main(config.ComposedConfig(
        device="cpu", plan="auto", results_dir=base + "/auto", **{kw!r}),
        datasets=splits({n_train}, {n_test}))
    p = plan.Plan.load(base + "/auto/plan_composed.json")
    pinned, hist2 = composed.main(config.ComposedConfig(
        device="cpu", mesh=p.mesh, fsdp=p.fsdp, grad_accum=p.grad_accum,
        pipeline_microbatches=p.pipeline_microbatches, results_dir="", **{kw!r}),
        datasets=splits({n_train}, {n_test}))
    for name, st, h in (("auto", state, hist), ("pinned", pinned, hist2)):
        saved[name + "/train"] = np.array(h.train_losses)
        for k, v in st.params.items():
            saved[name + "/p/" + k] = v.numpy()
    composed.main(config.ComposedConfig(
        device="cpu", plan="tune", results_dir=base + "/tune", **{kw!r}),
        datasets=splits({n_train}, {n_test}))
if RANK == 0:
    np.savez(base + "/w2.npz", **saved)
"""


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The gloo world of 2, started before the file's first test, waited for by the one
    test that reads it."""
    base = tmp_path_factory.mktemp("plan_w2")
    f = fleet.Fleets(base, {"w2": (CHILD_2.format(
        pkg=fleet.PKG, base=str(base), kw=KW, n_train=N_TRAIN, n_test=N_TEST,
        composed_hbm=COMPOSED_HBM), 2)})
    yield f
    f.close()


@pytest.fixture(autouse=True)
def _started(world2, monkeypatch):
    monkeypatch.delenv("PLAN_HBM_BYTES", raising=False)


def _splits(n_train=N_TRAIN, n_test=N_TEST):
    out = []
    for n, seed in ((n_train, 200), (n_test, 201)):
        x, y = mnist._synthesize_split(n, seed)
        out.append(mnist.Dataset(mnist._normalize(x), y.astype(np.int32), "synthetic"))
    return tuple(out)


def _same_params(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _jax_plan(run_type: str, kw: dict, saved: plan.Plan) -> dict:
    """The JAX planner's ``auto`` plan for the same config on the topology the port's run
    recorded."""
    cls = "ComposedConfig" if run_type == "composed" else "LMConfig"
    make = getattr(jax_plan.scenarios, f"for_{run_type}")
    scenario = make(getattr(jax_config, cls)(**kw), jax_plan.Topology(**saved.topology))
    return jax_plan.resolve("auto", scenario).to_dict()


def test_auto_plan_is_the_jax_plan_and_replays_bitwise(tmp_path):
    cfg = config.ComposedConfig(device="cpu", plan="auto", results_dir=str(tmp_path / "a"),
                                telemetry=str(tmp_path / "a.jsonl"), **KW)
    state, hist = composed.main(cfg, datasets=_splits())
    path = tmp_path / "a" / "plan_composed.json"
    saved = plan.Plan.load(str(path))
    assert (saved.source, saved.device_count, saved.mesh) == ("auto", 1, "data=1")
    assert saved.topology["device_kind"] == "cpu" and saved.topology["num_slices"] == 1
    assert saved.predicted["fits"] is True
    assert saved.to_dict() == _jax_plan("composed", KW, saved)
    rows = read_jsonl(str(tmp_path / "a.jsonl"))
    assert [r["event"] for r in rows[:2]] == ["manifest", "plan"]
    assert rows[1]["mesh"] == saved.mesh and rows[1]["source"] == "auto"
    assert rows[0]["config"]["mesh"] == saved.mesh          # the planned mesh ran
    replay, hist2 = composed.main(
        dataclasses.replace(cfg, plan=str(path), results_dir="", telemetry=""),
        datasets=_splits())
    _same_params(replay.params, state.params)
    assert hist2.train_losses == hist.train_losses
    assert hist2.test_losses == hist.test_losses


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_pinned_plan_trains_bitwise_as_the_planless_run(tmp_path, grad_accum):
    base = config.ComposedConfig(device="cpu", mesh="data=1", grad_accum=grad_accum,
                                 results_dir="", **KW)
    off, hist_off = composed.main(base, datasets=_splits())
    path = str(tmp_path / "pinned.json")
    plan.Plan(run_type="composed", device_count=1, mesh="data=1",
              axes={"data": 1, "model": 1, "stage": 1}, grad_accum=grad_accum).save(path)
    on, hist_on = composed.main(
        dataclasses.replace(base, plan=path, mesh="data=2,seq=2,model=2", grad_accum=1),
        datasets=_splits())
    _same_params(on.params, off.params)
    assert hist_on.train_losses == hist_off.train_losses


def test_a_plan_for_more_devices_is_refused(tmp_path):
    path = str(tmp_path / "p8.json")
    plan.Plan(run_type="composed", device_count=8, mesh="data=8",
              axes={"data": 8, "model": 1, "stage": 1}).save(path)
    with pytest.raises(ValueError, match="targets 8 devices but only 1 are addressable"):
        composed.main(config.ComposedConfig(device="cpu", plan=path, **KW),
                      datasets=_splits())


def test_tune_measures_the_top_three(tmp_path):
    cfg = config.ComposedConfig(device="cpu", plan="tune", results_dir=str(tmp_path / "t"),
                                telemetry=str(tmp_path / "t.jsonl"), **KW)
    composed.main(cfg, datasets=_splits())
    saved = plan.Plan.load(str(tmp_path / "t" / "plan_composed.json"))
    assert saved.source == "tune"
    measured = [r for r in saved.candidates if r["measured_step_s"] is not None]
    assert len(measured) == plan.AUTOTUNE_TOP_K == 3
    assert all(r["measured_step_s"] > 0 and r["compile_s"] > 0
               and r["measured_flops_per_step"] > 0 for r in measured)
    assert saved.candidates[:3] == measured          # measured rows lead, fastest first
    assert saved.measured_step_s == min(r["measured_step_s"] for r in measured)
    assert [r["measured_step_s"] for r in measured] == sorted(
        r["measured_step_s"] for r in measured)
    events = [r for r in read_jsonl(str(tmp_path / "t.jsonl")) if r["event"] == "autotune"]
    assert [e["rank"] for e in events] == [0, 1, 2]
    assert sorted(e["measured_step_s"] for e in events) == [
        r["measured_step_s"] for r in measured]
    assert {e["grad_accum"] for e in events} == {1, 2, 4}


@pytest.mark.parametrize("mode", ["auto", "tune"])
def test_lm_plans_and_trains(tmp_path, mode):
    cfg = config.LMConfig(device="cpu", plan=mode, results_dir=str(tmp_path / "lm"),
                          images_dir=str(tmp_path / "img"),
                          telemetry=str(tmp_path / "lm.jsonl"), **LM_KW)
    state, hist = lm_train.main(cfg, datasets=_splits(32, 10))
    saved = plan.Plan.load(str(tmp_path / "lm" / "plan_lm.json"))
    assert (saved.run_type, saved.source, saved.mesh) == ("lm", mode, "data=1")
    assert saved.predicted["fits"] is True
    assert all(np.isfinite(hist.train_losses))
    kinds = [r["event"] for r in read_jsonl(str(tmp_path / "lm.jsonl"))]
    assert kinds[:2] == ["manifest", "plan"]
    if mode == "auto":
        assert saved.to_dict() == _jax_plan("lm", {k: v for k, v in LM_KW.items()
                                                   if not k.startswith("max_")}, saved)
    else:
        assert kinds.count("autotune") == 3
        assert sum(r["measured_step_s"] is not None for r in saved.candidates) == 3


def test_world_of_two_plans_shards_and_matches_the_pinned_mesh(world2):
    """The gloo world of 2: the planned runs equal the pinned runs bitwise, the plans are
    the JAX planner's on the recorded topology, and tune degrades to auto."""
    base = world2.get("w2")
    got = np.load(base / "w2.npz")
    np.testing.assert_array_equal(got["auto/train"], got["pinned/train"])
    keys = [k for k in got.files if k.startswith("auto/p/")]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(got[k], got["pinned" + k[len("auto"):]], err_msg=k)
    saved = plan.Plan.load(str(base / "auto" / "plan_composed.json"))
    assert (saved.mesh, saved.grad_accum) == ("data=1,model=2", 2)
    assert saved.topology["hbm_source"] == "env" and saved.topology["num_devices"] == 2
    assert saved.topology["num_slices"] == 1              # one host
    assert saved.to_dict() == _jax_plan("composed", KW, saved)
    tuned = plan.Plan.load(str(base / "tune" / "plan_composed.json"))
    assert tuned.source == "auto" and tuned.measured_step_s is None
    assert "--plan tune on a multi-process fleet would rank by per-host wall clocks; " \
        "degrading to the analytical 'auto' ranking" in world2.out["w2"]
    assert json.loads(json.dumps(tuned.to_dict()))["mesh"] == saved.mesh
