"""PyTorch port, the parallelism planner (``plan/``, ``plan_report``, the topology helpers of
``parallel/mesh.py``) against the JAX package's ``plan/`` and ``tools/plan_report.py``.

Every comparison is exact (``==`` on floats): the cost model's arithmetic is copied, and the
same stubbed inputs must give the same candidates, the same order, every ``CostBreakdown``
and ``ServeCostBreakdown`` field, the same ``ModelStats``/``ServeStats`` (counted from
flax's abstract init in JAX, from the port's modules' parameter shapes and ``init_cache``'s
meta planes here), the same ``Plan`` JSON, the same folded config, the same errors and the
same report text. No live device is consulted: the topologies are stubs, and the
topology helpers are read on the CPU (``"cuda"`` raises without a card).
"""

import dataclasses
import io
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import pytest
import torch

from csed_514_project_distributed_training_using_pytorch_tpu import plan as jax_plan
from csed_514_project_distributed_training_using_pytorch_tpu.models import lm as jax_lm
from csed_514_project_distributed_training_using_pytorch_tpu.plan.search import (
    Ranked as JaxRanked,
)
from csed_514_project_distributed_training_using_pytorch_tpu.plan.search import (
    _sort_key as jax_sort_key,
)
from csed_514_project_distributed_training_using_pytorch_tpu.utils import (
    config as jax_config,
)
from csed_514_project_distributed_training_using_pytorch_tpu.utils import (
    telemetry as jax_telemetry,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch import plan
from csed_514_project_distributed_training_using_pytorch_tpu_torch import plan_report
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import lm
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import mesh
from csed_514_project_distributed_training_using_pytorch_tpu_torch.plan import costs
from csed_514_project_distributed_training_using_pytorch_tpu_torch.plan.search import (
    MAX_GRAD_ACCUM,
    MAX_MICROBATCHES,
    Ranked,
    _sort_key,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import config
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
    telemetry as T,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "csed_514_project_distributed_training_using_pytorch_tpu_torch"
sys.path.insert(0, os.path.join(ROOT, "tools"))
import plan_report as jax_plan_report  # noqa: E402  (tools/plan_report.py)

sys.path.pop(0)


def _stub(pkg, *, num_devices=8, hbm_bytes=16 << 30, ici=1e10, dcn=1e9, num_slices=1,
          global_batch=64, param_mb=4.0, layers=4, heads=8, seq=256, embed=128,
          axes=("data", "model", "stage"), test_batch=0):
    """``tests/test_plan.py``'s synthetic scenario, built in ``pkg`` (either package)."""
    stats = pkg.ModelStats(
        name="stub", param_bytes=param_mb * 1e6,
        flops_per_example=6 * param_mb * 1e6 / 4 * seq,
        num_layers=layers, num_heads=heads, seq_len=seq, embed_dim=embed,
        dtype_bytes=4, act_bytes_per_layer_per_example=seq * embed * 4 * 14,
        score_bytes_per_example=heads * seq * seq * 4.0,
        optimizer_mult=2.0, shardable_fraction=0.9)
    topo = pkg.Topology(num_devices=num_devices, device_kind="stub", hbm_bytes=hbm_bytes,
                        peak_flops=1e12, ici_bytes=ici, dcn_bytes=dcn,
                        num_slices=num_slices)
    return pkg.Scenario(run_type="composed", stats=stats, topo=topo,
                        global_batch=global_batch, axes=axes, allow_fsdp=True,
                        allow_grad_accum=True, test_batch=test_batch)


def _rows(ranked) -> list[dict]:
    return [r.to_dict() for r in ranked]


# -- the search ------------------------------------------------------------------------------

SEARCH_CASES = {
    # tests/test_plan.py's two ranking scenarios
    "bandwidth-poor": dict(ici=2e9, dcn=2e8, param_mb=64.0, global_batch=256),
    "two-granules": dict(ici=1e11, dcn=1e9, num_slices=2, param_mb=16.0, global_batch=128),
    # its memory pressure: a ~130 MB device forces sharded state
    "memory-pressure": dict(param_mb=64.0, hbm_bytes=130 << 20),
    # the eval batch a stage split must divide
    "test-batch": dict(test_batch=1000),
    # nothing fits
    "nothing-fits": dict(param_mb=64.0, hbm_bytes=1 << 20),
}


@pytest.mark.parametrize("case", list(SEARCH_CASES))
def test_search_is_the_jax_search(case):
    """The enumeration, the ranking and every priced field equal the JAX package's, and
    the ranking is brute force over ``predict`` with the tie-break; where nothing fits both
    raise the same error."""
    kw = SEARCH_CASES[case]
    ours, theirs = _stub(plan, **kw), _stub(jax_plan, **kw)
    cands = plan.enumerate_candidates(ours)
    assert [c.to_dict() for c in cands] == [
        c.to_dict() for c in jax_plan.enumerate_candidates(theirs)]
    assert len(set(cands)) == len(cands)
    if case == "nothing-fits":
        with pytest.raises(ValueError, match="no layout fits") as got:
            plan.search(ours)
        with pytest.raises(ValueError) as want:
            jax_plan.search(theirs)
        assert str(got.value) == str(want.value)
        return
    ranked = plan.search(ours, top=10_000)
    assert _rows(ranked) == _rows(jax_plan.search(theirs, top=10_000))
    assert [r.to_dict() for r in plan.search(ours)] == _rows(jax_plan.search(theirs))
    brute = [Ranked(c, plan.predict(ours.stats, ours.topo, c,
                                    global_batch=ours.global_batch,
                                    hbm_fraction=ours.hbm_fraction)) for c in cands]
    brute.sort(key=_sort_key)
    assert [r.candidate for r in ranked] == [r.candidate for r in brute]
    jbrute = [JaxRanked(c, jax_plan.predict(theirs.stats, theirs.topo, c,
                                            global_batch=theirs.global_batch))
              for c in jax_plan.enumerate_candidates(theirs)]
    assert _rows(brute) == _rows(sorted(jbrute, key=jax_sort_key))
    head = ranked[0]
    assert head.costs.fits and head.costs.step_s == min(
        r.costs.step_s for r in brute if r.costs.fits)
    if case == "memory-pressure":
        c = head.candidate
        assert c.fsdp or c.model > 1 or c.stage > 1


@pytest.mark.parametrize("kv_layout,context", [("contiguous", None), ("paged", 300)])
def test_serve_search_is_the_jax_search(kv_layout, context):
    """``predict_serve`` (both layouts) and ``search_serve`` with a measure hook equal the
    JAX package's on a stubbed 8-device topology."""
    stats = dict(name="s", param_bytes=5e8, kv_bytes_per_slot=4e6,
                 prompt_bytes_per_slot=3136.0, flops_per_token=1e9, num_layers=4,
                 num_heads=8, num_kv_heads=4, seq_len=784, embed_dim=256, dtype_bytes=2,
                 shardable_fraction=0.8)
    topo = dict(num_devices=8, device_kind="stub", hbm_bytes=2 << 30)
    ours = plan.ServeScenario(stats=plan.ServeStats(**stats), topo=plan.Topology(**topo),
                              num_slots=16, prompt_len=128, ttft_slo_s=0.05,
                              measure=lambda tp, dp: 1000.0 / tp + dp)
    theirs = jax_plan.ServeScenario(
        stats=jax_plan.ServeStats(**stats), topo=jax_plan.Topology(**topo), num_slots=16,
        prompt_len=128, ttft_slo_s=0.05, measure=lambda tp, dp: 1000.0 / tp + dp)
    assert plan.enumerate_serve_candidates(ours) == jax_plan.enumerate_serve_candidates(
        theirs)
    assert _rows(plan.search_serve(ours)) == _rows(jax_plan.search_serve(theirs))
    for tp, dp in plan.enumerate_serve_candidates(ours):
        kw = dict(tp=tp, dp=dp, num_slots=16, prompt_len=128, kv_layout=kv_layout,
                  context_tokens=context)
        assert plan.predict_serve(ours.stats, ours.topo, **kw).to_dict() == \
            jax_plan.predict_serve(theirs.stats, theirs.topo, **kw).to_dict()


def test_h100_tables_and_the_shared_defaults():
    """The port's per-kind rows are the H100's nominal figures; unknown kinds and the CPU
    keep the JAX package's defaults, so stubs price alike in both."""
    kind = "NVIDIA H100 80GB HBM3"
    assert costs.ici_bytes_per_s(kind) == 4.5e11          # NVLink 4, one way
    assert costs.dcn_bytes_per_s(kind) == 5.0e10          # one 400 Gb/s NDR port
    assert costs.hbm_bytes_per_s(kind) == 3.35e12
    from csed_514_project_distributed_training_using_pytorch_tpu.plan import (
        costs as jax_costs,
    )
    for name in ("DEFAULT_ICI_BYTES", "DEFAULT_DCN_BYTES", "DEFAULT_HBM_BYTES",
                 "MICROBATCH_OVERHEAD_S"):
        assert getattr(costs, name) == getattr(jax_costs, name), name
    for k in ("cpu", "stub"):
        assert costs.ici_bytes_per_s(k) == jax_costs.ici_bytes_per_s(k)
        assert costs.hbm_bytes_per_s(k) == jax_costs.hbm_bytes_per_s(k)
    assert plan.Topology(num_devices=1) == plan.Topology(
        **jax_plan.Topology(num_devices=1).to_dict())
    assert (MAX_GRAD_ACCUM, MAX_MICROBATCHES) == (8, 16)
    assert plan.AUTOTUNE_TOP_K == jax_plan.AUTOTUNE_TOP_K == 3


# -- the scenarios' stats ---------------------------------------------------------------------

STUB_TOPO = dict(num_devices=8, device_kind="stub")

TRAINER_STATS = {
    "composed-f32": ("composed", dict()),
    "composed-bf16": ("composed", dict(bf16=True)),
    "composed-remat-adamw-ema": ("composed", dict(remat=True, optimizer="adamw",
                                                  ema_decay=0.99)),
    "composed-flash": ("composed", dict(flash_attention=True, seq_len=2048)),
    "lm": ("lm", dict()),
    "lm-kv-heads-bf16": ("lm", dict(kv_heads=2, bf16=True, embed_dim=32, num_layers=3)),
}


@pytest.mark.parametrize("case", list(TRAINER_STATS))
def test_trainer_scenarios_equal_jax(case):
    """``for_composed``/``for_lm``: the stats, the axes and every knob of the scenario."""
    kind, kw = TRAINER_STATS[case]
    cls = "ComposedConfig" if kind == "composed" else "LMConfig"
    ours = getattr(plan.scenarios, f"for_{kind}")(getattr(config, cls)(**kw),
                                                  plan.Topology(**STUB_TOPO))
    theirs = getattr(jax_plan.scenarios, f"for_{kind}")(getattr(jax_config, cls)(**kw),
                                                        jax_plan.Topology(**STUB_TOPO))
    assert ours.stats.to_dict() == theirs.stats.to_dict()
    for field in ("run_type", "global_batch", "axes", "allow_fsdp", "allow_grad_accum",
                  "fixed_grad_accum", "test_batch", "hbm_fraction"):
        assert getattr(ours, field) == getattr(theirs, field), field
    assert _rows(plan.search(ours)) == _rows(jax_plan.search(theirs))


def test_cnn_scenario_equals_jax():
    ours = plan.scenarios.for_cnn(64, plan.Topology(**STUB_TOPO))
    theirs = jax_plan.scenarios.for_cnn(64, jax_plan.Topology(**STUB_TOPO))
    assert ours.stats.to_dict() == theirs.stats.to_dict()
    assert (ours.axes, ours.allow_fsdp, ours.allow_grad_accum) == (
        theirs.axes, theirs.allow_fsdp, theirs.allow_grad_accum)
    assert _rows(plan.search(ours)) == _rows(jax_plan.search(theirs))


@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8"])
@pytest.mark.parametrize("width", ["loadgen", "gqa-bf16"])
def test_serve_scenario_equals_jax(kv_dtype, width):
    """``for_serve``: the parameter bytes, the TP-shardable fraction, one slot's KV bytes
    (scale planes included) and every other field, at the loadgen widths (f32) and a GQA
    bf16 model."""
    kw = (dict() if width == "loadgen"
          else dict(embed_dim=32, num_layers=3, num_heads=4, num_kv_heads=2))
    ours_m = lm.TransformerLM(**kw, dtype=torch.bfloat16 if width != "loadgen"
                              else torch.float32)
    jax_m = jax_lm.TransformerLM(**kw, dtype=jnp.bfloat16 if width != "loadgen"
                                 else jnp.float32)
    ours = plan.scenarios.for_serve(ours_m, num_slots=8, prompt_len=392, kv_dtype=kv_dtype,
                                    topo=plan.Topology(**STUB_TOPO))
    theirs = jax_plan.scenarios.for_serve(jax_m, num_slots=8, prompt_len=392,
                                          kv_dtype=kv_dtype,
                                          topo=jax_plan.Topology(**STUB_TOPO))
    assert ours.stats.to_dict() == theirs.stats.to_dict()
    assert _rows(plan.search_serve(ours)) == _rows(jax_plan.search_serve(theirs))


def test_serve_slot_bytes_are_the_engines():
    """One slot's KV bytes are what the contiguous engine's ``byte_accounting`` reports
    for a slot, for each kv_dtype (the smoke checks the same on the card)."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch import serving

    model = lm.TransformerLM(seq_len=64, embed_dim=32, num_layers=1, num_heads=2)
    params = model.init(torch.Generator().manual_seed(0))
    for kv in ("model", "int8", "fp8"):
        engine = serving.ContinuousBatchingEngine(model, params, num_slots=4,
                                                  kv_dtype=kv, device="cpu")
        sc = plan.scenarios.for_serve(model, num_slots=4, prompt_len=8, kv_dtype=kv,
                                      topo=plan.Topology(num_devices=1))
        assert sc.stats.kv_bytes_per_slot == engine.byte_accounting()["kv_bytes_per_slot"]


# -- the artifact, resolve and apply_plan ------------------------------------------------------


def test_plan_json_round_trips_across_the_packages(tmp_path):
    ours = plan.resolve("auto", _stub(plan))
    theirs = jax_plan.resolve("auto", _stub(jax_plan))
    assert ours.to_json() == theirs.to_json()
    ours.save(str(tmp_path / "port.json"))
    theirs.save(str(tmp_path / "jax.json"))
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert plan.Plan.load(str(tmp_path / "jax.json")) == ours
    assert jax_plan.Plan.load(str(tmp_path / "port.json")) == theirs
    assert plan.Plan.from_json(ours.to_json()).candidate == ours.candidate


def _corrupt(d: dict, case: str) -> dict:
    d = dict(d)
    if case == "product":
        d["device_count"] = 5
    elif case == "missing-keys":
        d = {"hello": 1}
    elif case == "unknown-key":
        d["wat"] = 1
    elif case == "missing-field":
        del d["run_type"]
    elif case == "newer-schema":
        d["schema_version"] = 99
        d["future_field"] = 1
    return d


@pytest.mark.parametrize("case", ["product", "missing-keys", "unknown-key", "missing-field",
                                  "newer-schema"])
def test_corrupt_artifacts_are_refused_alike(case):
    base = plan.resolve("auto", _stub(plan)).to_dict()
    d = _corrupt(base, case)
    if case == "newer-schema":                  # forward-compatible: loads in both
        assert plan.Plan.from_dict(d).to_dict() == jax_plan.Plan.from_dict(d).to_dict()
        return
    with pytest.raises(ValueError) as ours:
        plan.Plan.from_dict(d)
    with pytest.raises(ValueError) as theirs:
        jax_plan.Plan.from_dict(d)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("case", ["run-type", "devices", "ok"])
def test_resolve_file_validates_alike(tmp_path, case):
    path = str(tmp_path / "p.json")
    plan.resolve("auto", _stub(plan)).save(path)
    ours, theirs = _stub(plan), _stub(jax_plan)
    if case == "run-type":
        ours, theirs = (dataclasses.replace(s, run_type="lm") for s in (ours, theirs))
    elif case == "devices":
        ours, theirs = (dataclasses.replace(s, topo=dataclasses.replace(s.topo,
                                                                        num_devices=4))
                        for s in (ours, theirs))
    if case == "ok":
        got, want = plan.resolve(path, ours), jax_plan.resolve(path, theirs)
        assert got.source == "file" and got.to_dict() == want.to_dict()
        return
    with pytest.raises(ValueError) as got:
        plan.resolve(path, ours)
    with pytest.raises(ValueError) as want:
        jax_plan.resolve(path, theirs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("run_type,kw", [
    ("composed", dict(batch_size=64, batch_size_test=1000)),
    ("composed", dict(hbm_bytes=40 << 20, batch_size=32, batch_size_test=96)),
    ("lm", dict(batch_size=16, hbm_bytes=8 << 20)),
], ids=["composed", "composed-tight", "lm-tight"])
def test_apply_plan_folds_the_same_config(tmp_path, run_type, kw):
    """``apply_plan(config, run_type, topo=stub)``: the same folded config and the same
    saved plan JSON, byte for byte, in both packages."""
    kw = dict(kw)
    hbm = kw.pop("hbm_bytes", 16 << 30)
    cls = "ComposedConfig" if run_type == "composed" else "LMConfig"
    out = {}
    for name, pkg, cfgs in (("port", plan, config), ("jax", jax_plan, jax_config)):
        cfg = getattr(cfgs, cls)(plan="auto", results_dir=str(tmp_path / name), **kw)
        folded, p = pkg.apply_plan(cfg, run_type, topo=pkg.Topology(
            num_devices=8, device_kind="stub", hbm_bytes=hbm))
        fields = ("mesh", "grad_accum") + (("fsdp", "pipeline_microbatches")
                                           if run_type == "composed" else ())
        out[name] = ({f: getattr(folded, f) for f in fields},
                     (tmp_path / name / f"plan_{run_type}.json").read_bytes(), p.source)
    assert out["port"] == out["jax"]


def test_apply_plan_returns_the_config_untouched_when_off():
    cfg = config.ComposedConfig()
    assert plan.apply_plan(cfg, "composed") == (cfg, None)
    with pytest.raises(ValueError, match="no planning scenario"):
        plan.apply_plan(dataclasses.replace(cfg, plan="auto"), "cnn",
                        topo=plan.Topology(num_devices=1))


# -- autotune ---------------------------------------------------------------------------------


def test_refine_orders_and_emits_as_jax():
    """``refine`` with stubbed trials (the analytical order reversed, one candidate
    unbuildable): the same order, measurements and autotune events as the JAX package's."""
    out = {}
    for name, pkg in (("port", plan), ("jax", jax_plan)):
        sc = _stub(pkg)
        ranked = pkg.search(sc, top=5)
        measured = {ranked[0].candidate: 3e-3, ranked[1].candidate: 1e-3,
                    ranked[3].candidate: 2e-3}

        def trial(cand, ranked=ranked, measured=measured):
            if cand == ranked[2].candidate:
                return None
            return {"step_s": measured[cand], "compile_s": 0.5, "flops_per_step": 1e9}

        events = []
        got = pkg.autotune.refine(dataclasses.replace(sc, trial=trial), ranked, top_k=3,
                                  emit=events.append)
        out[name] = (_rows(got), events)
    assert out["port"] == out["jax"]
    rows, events = out["port"]
    assert rows[0]["measured_step_s"] == 1e-3 and rows[1]["measured_step_s"] == 3e-3
    assert [e["event"] for e in events] == ["autotune"] * 3
    assert events[2]["measured_step_s"] is None        # the unbuildable one


def test_plan_and_autotune_events_are_the_jax_events():
    p = plan.resolve("auto", _stub(plan))
    assert T.plan_event(p) == jax_telemetry.plan_event(
        jax_plan.resolve("auto", _stub(jax_plan)))
    kw = dict(mesh="data=8", fsdp=False, grad_accum=1, microbatches=1, rank=0,
              predicted_step_s=float("inf"))
    assert T.autotune_event(**kw) == jax_telemetry.autotune_event(**kw)


# -- plan_report ------------------------------------------------------------------------------


def _telemetry(path, p):
    w = T.TelemetryWriter(str(path))
    w.emit({"event": "epoch", "epoch": 0, "execute_s": 2.0, "steps": 100})
    w.emit({"event": "epoch", "epoch": 1, "execute_s": 1.5, "steps": 100})
    w.emit(T.autotune_event(mesh=p.mesh, fsdp=p.fsdp, grad_accum=p.grad_accum,
                            microbatches=1, rank=0, predicted_step_s=p.predicted["step_s"],
                            measured_step_s=0.02, compile_s=1.0))
    w.close()


@pytest.mark.parametrize("with_telemetry", [False, True], ids=["plan", "telemetry"])
def test_plan_report_renders_as_the_jax_tool(tmp_path, with_telemetry):
    """The report's text equals ``tools/plan_report.py``'s on the same plan (and
    telemetry); ``python -m <port>.plan_report`` prints it."""
    p = plan.resolve("tune", dataclasses.replace(
        _stub(plan), trial=lambda c: {"step_s": 1e-3 * (1 + c.grad_accum),
                                      "compile_s": 0.1, "flops_per_step": None}))
    path = str(tmp_path / "p.json")
    p.save(path)
    argv = [path]
    rows = None
    if with_telemetry:
        _telemetry(tmp_path / "run.jsonl", p)
        argv += ["--telemetry", str(tmp_path / "run.jsonl")]
        from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.metrics import (
            load_metrics_jsonl,
        )
        rows = load_metrics_jsonl(argv[-1])
    ours, theirs = io.StringIO(), io.StringIO()
    plan_report.render(plan.Plan.load(path), rows, out=ours)
    jax_plan_report.render(jax_plan.Plan.load(path), rows, out=theirs)
    assert ours.getvalue() == theirs.getvalue()
    assert "chosen: mesh" in ours.getvalue() and "pred_ms" in ours.getvalue()
    if with_telemetry:
        assert "run measured (telemetry): best step 15.000 ms" in ours.getvalue()
        done = subprocess.run([sys.executable, "-m", f"{PKG}.plan_report", *argv],
                              capture_output=True, text=True, cwd=ROOT,
                              env={**os.environ, "PYTHONPATH": ROOT})
        assert done.returncode == 0, done.stderr
        assert done.stdout == ours.getvalue()


# -- the topology helpers -----------------------------------------------------------------------


def test_topology_on_the_cpu_and_the_budget_sources(monkeypatch):
    monkeypatch.delenv("PLAN_HBM_BYTES", raising=False)
    assert mesh.device_memory_budget("cpu") == (16 << 30, "nominal")
    assert mesh.DEFAULT_DEVICE_MEMORY == 16 << 30
    t = mesh.topology_summary("cpu")
    assert t == {"platform": "cpu", "device_kind": "cpu", "device_count": 1,
                 "process_count": 1, "hbm_bytes": 16 << 30, "hbm_source": "nominal",
                 "num_granules": 1}
    from csed_514_project_distributed_training_using_pytorch_tpu.parallel.mesh import (
        topology_summary as jax_summary,
    )
    assert set(t) == set(jax_summary())
    assert plan.Topology.detect("cpu") == plan.Topology(num_devices=1, hbm_source="nominal")
    monkeypatch.setenv("PLAN_HBM_BYTES", str(123 << 20))
    assert mesh.device_memory_budget("cpu") == (123 << 20, "env")
    assert mesh.device_memory_budget("cuda") == (123 << 20, "env")   # env first, as JAX
    assert plan.Topology.detect("cpu").hbm_bytes == float(123 << 20)


def test_topology_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.delenv("PLAN_HBM_BYTES", raising=False)
    with pytest.raises((RuntimeError, AssertionError)):
        plan.Topology.detect("cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        plan.scenarios.for_composed(config.ComposedConfig(plan="auto"))
