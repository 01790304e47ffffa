"""PyTorch port, the telemetry stream (``utils/telemetry.py``, ``utils/telemetry_events.py``,
``utils/jsonl.py``; ``--telemetry`` and ``--health-stats`` on the trainers; the
``Server``'s stream), against the JAX package's.

(a) every event function returns the JAX function's event for the same inputs, key for key
    and value for value; the registry and the JSONL reader are the JAX package's;
(b) ``train.single --telemetry --health-stats`` writes the JAX stream's kinds with the JAX
    stream's keys (the JAX ``test_single_trainer_telemetry_acceptance_schema`` mirrored,
    and the JAX trainer's own stream on the same split as the reference of the keys);
(c) the health accumulators change nothing: each trainer's parameters with
    ``--health-stats`` are bitwise those without it (``train.single``, the LM and the
    composed trainer in process; ``train.distributed``, the LM and the composed trainer in
    a gloo world of 2 on the CPU, whose rank 0 alone writes the stream);
(d) the refusals are the JAX package's (``--health-stats`` without ``--telemetry``, on the
    host-fed path);
(e) ``tools/telemetry_report.py`` renders the port's trainer and server streams, alone and
    as an A-vs-B pair;
(f) the ``Server``'s serve, prefill, shed, tenant-summary, kv-pages and summary events
    carry the JAX event functions' keys (mirroring the JAX ``test_serve_event_and_summary_schema``).
"""

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

from csed_514_project_distributed_training_using_pytorch_tpu.train import single as jax_single
from csed_514_project_distributed_training_using_pytorch_tpu.utils import jsonl as jax_jsonl
from csed_514_project_distributed_training_using_pytorch_tpu.utils import (
    telemetry as jax_T,
)
from csed_514_project_distributed_training_using_pytorch_tpu.utils import (
    telemetry_events as jax_events,
)
from csed_514_project_distributed_training_using_pytorch_tpu.utils.config import (
    SingleProcessConfig as JaxSingleConfig,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import mnist
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import lm as lm_mod
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving import (
    ContinuousBatchingEngine,
    Server,
    parse_tenants,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import (
    composed,
    single,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import lm as lm_train
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import config, jsonl
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
    telemetry as T,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
    telemetry_events,
)

import torch_port_fleet as fleet

# the keys the port's manifest adds beside the JAX ones (the JAX versions are null there)
PORT_MANIFEST_EXTRAS = {"torch_version", "cuda_version"}
LM_KW = dict(epochs=1, batch_size=8, max_train_examples=32, max_test_examples=10,
             eval_batch=10, embed_dim=16, num_layers=1, num_heads=2, generate=0)
COMPOSED_KW = dict(epochs=1, batch_size=8, batch_size_test=16, seq_len=16, momentum=0.5,
                   learning_rate=0.05)

CHILD_2 = """
from {pkg}.parallel import mesh
from {pkg}.train import composed, distributed, lm
from {pkg}.utils import config
base = {base!r}
saved = {{}}
with mesh.cluster("cpu"):            # one group for every run
    for flag in ("off", "on"):
        tele = dict(telemetry=base + "/" + flag + "_{{}}.jsonl", health_stats=True)
        kw = lambda name: {{k: v.format(name) if isinstance(v, str) else v
                           for k, v in tele.items()}} if flag == "on" else {{}}
        state, _ = distributed.main(config.DistributedConfig(
            device="cpu", epochs=1, global_batch_size=32, batch_size_test=20,
            results_dir=base + "/d" + flag,
            images_dir=base + "/img", **kw("distributed")), datasets=splits(128, 20))
        saved[flag + "/distributed"] = state.params
        state, _ = lm.main(config.LMConfig(
            device="cpu", results_dir=base + "/l" + flag, images_dir=base + "/img",
            **{lm_kw!r}, **kw("lm")), datasets=splits(32, 10))
        saved[flag + "/lm"] = state.params
        state, _ = composed.main(config.ComposedConfig(
            device="cpu", mesh="data=2", results_dir="", **{composed_kw!r},
            **kw("composed")), datasets=splits(32, 16))
        saved[flag + "/composed"] = state.params
if RANK == 0:
    np.savez(base + "/w2.npz", **{{f"{{k}}/{{n}}": p.numpy()
                                  for k, ps in saved.items() for n, p in ps.items()}})
"""


def _split(n, seed):
    x, y = mnist._synthesize_split(n, seed)
    return mnist.Dataset(mnist._normalize(x), y.astype(np.int32), "synthetic")


@pytest.fixture(scope="module", autouse=True)
def fleets(tmp_path_factory):
    """The file's gloo world of 2, started before its first test."""
    base = tmp_path_factory.mktemp("telemetry")
    f = fleet.Fleets(base, {"w2": (CHILD_2.format(pkg=fleet.PKG, base=str(base), lm_kw=LM_KW,
                                                  composed_kw=COMPOSED_KW), 2)})
    yield f
    f.close()


@pytest.fixture(scope="module")
def micro():
    """The JAX telemetry test's micro split (192 / 64 synthetic examples)."""
    return _split(192, 400), _split(64, 401)


@pytest.fixture(scope="module")
def single_streams(tmp_path_factory, micro):
    """``train.single --telemetry --health-stats`` in both packages, the JAX acceptance
    run's configuration: (port rows, JAX rows, port params with and without the flags)."""
    base = tmp_path_factory.mktemp("single_telemetry")
    cfg = dict(n_epochs=2, batch_size_train=64, batch_size_test=64, log_interval=2)
    state, _ = single.main(config.SingleProcessConfig(
        **cfg, device="cpu", telemetry=str(base / "port.jsonl"), health_stats=True,
        results_dir=str(base / "r1"), images_dir=str(base / "i")), datasets=micro)
    plain, _ = single.main(config.SingleProcessConfig(
        **cfg, device="cpu", results_dir=str(base / "r2"), images_dir=str(base / "i")),
        datasets=micro)
    from csed_514_project_distributed_training_using_pytorch_tpu.data import mnist as jm
    jds = tuple(jm.Dataset(d.images, d.labels, d.source) for d in micro)
    jax_single.main(JaxSingleConfig(**cfg, telemetry=str(base / "jax.jsonl"),
                                    health_stats=True, results_dir=str(base / "r3"),
                                    images_dir=str(base / "i")), datasets=jds)
    return (jsonl.read_jsonl(str(base / "port.jsonl")),
            jax_jsonl.read_jsonl(str(base / "jax.jsonl")), state.params, plain.params,
            base)


# -- (a) the event functions, the registry, the reader ------------------------------------

_HEALTH = types.SimpleNamespace(loss_min=0.5, loss_max=2.5, loss_sum=6.0, grad_norm_sum=3.0,
                                grad_norm_max=float("inf"))
_GUARD = types.SimpleNamespace(ema_mean=1.5, ema_sq=2.5, anomalies=2, nonfinite=1, spikes=1,
                               skipped=1, count=40, first_anomaly_step=7,
                               last_anomaly_step=19)
_PLAN = types.SimpleNamespace(predicted={"step_s": 0.25, "total_bytes_per_chip": 1e9},
                              run_type="composed", source="auto", mesh="data=2,model=2",
                              axes={"data": 2, "model": 2}, fsdp=False, grad_accum=1,
                              pipeline_microbatches=4, device_count=4, global_batch=64,
                              measured_step_s=None, candidates=[1, 2, 3])
EVENT_CALLS = {
    "compile_event": (("epoch_segment", {"lower_s": 0.1, "compile_s": 0.9, "flops": 1e9,
                                         "bytes_accessed": 4e8}), {"steps_per_call": 10}),
    "epoch_event": ((3,), dict(examples=60000, steps=938, wall_s=5.0, execute_s=4.0,
                               eval_s=0.5, data_s=0.1, compile_s=1.0, flops_per_step=2e8,
                               train_loss=float("nan"), val_loss=0.3, mfu=0.01)),
    "data_event": ((1,), dict(batches=10, sequences=640, wait_s=0.2, throttle_s=0.01,
                              cursor={"epoch": 2}, stream_digest=123)),
    "health_event": ((2, _HEALTH, 3), {"param_norm": 5.0}),
    "anomaly_event": ((2, _GUARD, 40), {"fingerprint": 12.5, "skip": "4:6"}),
    "checkpoint_event": ((), dict(op="save", path="a.ckpt", nbytes=100, wall_s=0.5, step=9,
                                  coalesced=2, background=True)),
    "preempt_event": ((), dict(epoch=1, step=938, checkpoint="a.ckpt")),
    "plan_event": ((_PLAN,), {}),
    "autotune_event": ((), dict(mesh="data=4", fsdp=True, grad_accum=2, microbatches=1,
                                rank=0, predicted_step_s=0.1, measured_step_s=0.12,
                                compile_s=3.0, flops_per_step=1e9)),
    "serve_event": ((), dict(request_id=3, prompt_len=4, new_tokens=8, finish="ok",
                             queue_wait_s=0.1, ttft_s=0.2, tpot_s=0.01, e2e_s=0.5,
                             tenant="paid", preemptions=1)),
    "shed_event": ((), dict(tenant="free", reason="displaced", request_id=4, priority=0)),
    "tenant_summary_event": ((), dict(tenant="paid", requests=4, ok=3, timeout=1,
                                      new_tokens=30, ttft_s={"p50": 0.1})),
    "prefill_event": ((), dict(request_id=1, prompt_len=40, chunks=2, tokens=40,
                               cache_hit_len=0, wall_s=None, latency_s=0.05)),
    "spec_event": ((), dict(step=3, active=4, proposed=12, accepted=7, emitted=11,
                            draft_wall_s=0.001, verify_wall_s=0.004)),
    "serve_summary_event": ((), dict(
        requests=4, ok=3, timeout=1, new_tokens=30, wall_s=2.0, steps=40,
        decode_invocations=40, generated_tokens=30, slot_occupancy=0.75,
        prefill_tokens=100, prefill_chunks=5, ttft_s=[0.1, 0.2, 0.3, None],
        tpot_s=[0.01] * 4, e2e_s=[0.5] * 4, queue_wait_s=[0.0] * 4)),
    "kv_pages_event": ((), dict(stats={"num_pages": 105, "in_use": 3})),
    "promote_event": ((), dict(action="gate_pass", candidate="b.ckpt", step=5, nll=0.7,
                               incumbent_nll=0.71)),
    "canary_event": ((), dict(candidate="b.ckpt", replica=1, verdict="pass", window_s=30.0,
                              canary_attainment=0.99, fleet_attainment=0.98)),
}


@pytest.mark.parametrize("name", sorted(EVENT_CALLS))
def test_event_functions_equal_the_jax_ones(name):
    args, kwargs = EVENT_CALLS[name]
    assert getattr(T, name)(*args, **kwargs) == getattr(jax_T, name)(*args, **kwargs)


def test_serve_event_and_summary_schema():
    """The JAX test of the same name, on the port's event functions."""
    ev = T.serve_event(request_id=3, prompt_len=4, new_tokens=8, finish="ok",
                       queue_wait_s=0.1, ttft_s=0.2, tpot_s=0.01, e2e_s=0.5)
    assert ev["event"] == "serve" and ev["finish"] == "ok"
    assert ev["tokens_per_s"] == pytest.approx(8 / 0.4)
    summ = T.serve_summary_event(
        requests=4, ok=3, timeout=1, new_tokens=30, wall_s=2.0, steps=40,
        slot_occupancy=0.75, ttft_s=[0.1, 0.2, 0.3, None], tpot_s=[0.01] * 4,
        e2e_s=[0.5] * 4, queue_wait_s=[0.0] * 4)
    assert summ["tokens_per_s"] == pytest.approx(15.0)
    assert summ["ttft_s"] == {"p50": 0.2, "p95": 0.3, "p99": 0.3}
    assert T.percentiles([]) is None


def test_registry_and_reader_are_the_jax_packages(tmp_path):
    assert telemetry_events.EVENT_KINDS == jax_events.EVENT_KINDS
    assert telemetry_events.KNOWN_EVENTS == jax_events.KNOWN_EVENTS
    assert telemetry_events.describe("serve") == jax_events.describe("serve")
    assert telemetry_events.describe("nope") is None
    path = tmp_path / "torn.jsonl"
    path.write_text('{"event": "a"}\n\n{"event": "b"}\n{"event": "c", "x": ')
    assert jsonl.read_jsonl(str(path)) == jax_jsonl.read_jsonl(str(path)) == [
        {"event": "a"}, {"event": "b"}]
    path.write_text('{"event": "a"}\n{"bad\n{"event": "b"}\n')
    with pytest.raises(json.JSONDecodeError):
        jsonl.read_jsonl(str(path))


def test_writer_rewrites_atomically_appends_in_stream_mode_and_is_rank_gated(tmp_path,
                                                                             monkeypatch):
    path = tmp_path / "t.jsonl"
    w = T.TelemetryWriter(str(path))
    w.emit({"event": "epoch", "loss": float("inf")})
    w.emit({"event": "epoch", "loss": 1.0})
    rows = jsonl.read_jsonl(str(path))
    assert [r["loss"] for r in rows] == [None, 1.0] and all("t_s" in r for r in rows)
    with pytest.raises(ValueError, match="'event'"):
        w.emit({"loss": 1.0})
    T.TelemetryWriter(str(path), preserve=True).emit({"event": "manifest"})
    assert [r["event"] for r in jsonl.read_jsonl(str(path))] == ["epoch", "epoch",
                                                                 "manifest"]
    T.TelemetryWriter(str(path)).emit({"event": "manifest"})          # a fresh run truncates
    assert len(jsonl.read_jsonl(str(path))) == 1
    s = T.TelemetryWriter(str(tmp_path / "s.jsonl"), stream=True)
    s.emit({"event": "serve"})
    s.close()
    s.emit({"event": "serve"})                                        # reopens to append
    s.close()
    assert len(jsonl.read_jsonl(str(tmp_path / "s.jsonl"))) == 2
    monkeypatch.setenv("RANK", "1")
    off = T.TelemetryWriter(str(tmp_path / "r1.jsonl"))
    assert not off.enabled
    off.emit({"event": "epoch"})
    assert not (tmp_path / "r1.jsonl").exists()
    assert not T.TelemetryWriter("").enabled


# -- (b) train.single's stream ------------------------------------------------------------


def test_single_trainer_telemetry_acceptance_schema(single_streams):
    """The JAX acceptance test mirrored: a manifest, two epoch and two health events,
    compile and mfu; compile_s / execute_s / examples_per_s / flops_per_step positive."""
    rows = single_streams[0]
    events = [r["event"] for r in rows]
    assert events[0] == "manifest"
    assert events.count("epoch") == 2 and events.count("health") == 2
    assert "compile" in events and "mfu" in events
    man = rows[0]
    assert man["config"]["n_epochs"] == 2 and man["device_count"] >= 1
    for ep in (r for r in rows if r["event"] == "epoch"):
        assert ep["compile_s"] > 0 and ep["execute_s"] > 0
        assert ep["examples_per_s"] > 0 and ep["flops_per_step"] > 0
        assert ep["steps"] == 3            # 192 examples / batch 64
    for h in (r for r in rows if r["event"] == "health"):
        assert h["grad_norm"] > 0 and h["param_norm"] > 0
        assert h["loss_min"] <= h["loss_mean"] <= h["loss_max"]


def test_single_stream_has_the_jax_streams_kinds_and_keys(single_streams):
    ours, theirs = single_streams[:2]
    assert [r["event"] for r in ours] == [r["event"] for r in theirs]
    for a, b in zip(ours, theirs):
        extra = PORT_MANIFEST_EXTRAS if a["event"] == "manifest" else set()
        assert set(a) == set(b) | extra, a["event"]
        if a["event"] == "manifest":
            assert set(a["config"]) >= set(b["config"]) - {"data_dir"}
            assert set(a["precision"]) >= set(b["precision"])
        if a["event"] == "epoch":
            assert (a["epoch"], a["examples"], a["steps"]) == (
                b["epoch"], b["examples"], b["steps"])


# -- (c) health stats change nothing ------------------------------------------------------


def test_health_stats_epoch_equals_the_unmetered_epoch_bitwise(single_streams):
    on, off = single_streams[2], single_streams[3]
    assert all(torch.equal(on[k], off[k]) for k in off)


@pytest.mark.parametrize("trainer", ["lm", "composed"])
def test_health_stats_leave_the_trainer_bitwise_unchanged(trainer, tmp_path):
    runs = {}
    for flag in ("off", "on"):
        kw = (dict(telemetry=str(tmp_path / f"{trainer}.jsonl"), health_stats=True)
              if flag == "on" else {})
        if trainer == "lm":
            state, _ = lm_train.main(config.LMConfig(
                device="cpu", results_dir=str(tmp_path / flag),
                images_dir=str(tmp_path / "img"), **LM_KW,
                **kw), datasets=(_split(32, 1), _split(10, 2)))
        else:
            state, _ = composed.main(config.ComposedConfig(
                device="cpu", mesh="data=1", results_dir="", **COMPOSED_KW, **kw),
                datasets=(_split(32, 1), _split(16, 2)))
        runs[flag] = state.params
    assert all(torch.equal(runs["on"][k], runs["off"][k]) for k in runs["off"])
    kinds = [r["event"] for r in jsonl.read_jsonl(str(tmp_path / f"{trainer}.jsonl"))]
    assert [k for k in kinds if k != "checkpoint"] == [
        "manifest", "compile", "epoch", "health", "mfu"]
    assert ("checkpoint" in kinds) == (trainer == "lm")      # the LM writes model_lm.ckpt


def test_world_2_trainers_health_bitwise_and_rank_0_streams(fleets):
    base = fleets.get("w2")
    saved = np.load(base / "w2.npz")
    for trainer in ("distributed", "lm", "composed"):
        names = [k.split("/", 2)[2] for k in saved.files if k.startswith(f"on/{trainer}/")]
        assert names
        for n in names:
            assert np.array_equal(saved[f"on/{trainer}/{n}"], saved[f"off/{trainer}/{n}"])
        rows = jsonl.read_jsonl(str(base / f"on_{trainer}.jsonl"))
        kinds = [r["event"] for r in rows]
        assert [k for k in kinds if k != "checkpoint"] == [
            "manifest", "compile", "epoch", "health", "mfu"]
        assert ("checkpoint" in kinds) == (trainer != "composed")   # composed: no results
        assert rows[0]["process_count"] == 2 and rows[0]["mesh"]["shape"]["data"] == 2


# -- (d) the refusals ---------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(health_stats=True),
                                dict(health_stats=True, use_host_pipeline=True)],
                         ids=["no-telemetry", "host-pipeline"])
def test_health_stats_refusals_are_the_jax_packages(kw, tmp_path, micro):
    if "use_host_pipeline" in kw:
        kw = dict(kw, telemetry=str(tmp_path / "t.jsonl"))
    with pytest.raises(ValueError) as ours:
        single.main(config.SingleProcessConfig(device="cpu", results_dir=str(tmp_path),
                                               images_dir=str(tmp_path), **kw),
                    datasets=micro)
    from csed_514_project_distributed_training_using_pytorch_tpu.data import mnist as jm
    jds = tuple(jm.Dataset(d.images, d.labels, d.source) for d in micro)
    with pytest.raises(ValueError) as theirs:
        jax_single.main(JaxSingleConfig(results_dir=str(tmp_path), images_dir=str(tmp_path),
                                        **kw), datasets=jds)
    assert str(ours.value) == str(theirs.value)


# -- (e) the report CLI -------------------------------------------------------------------


def _report(*paths) -> str:
    import contextlib
    import importlib.util
    import io

    spec = importlib.util.spec_from_file_location("telemetry_report",
                                                  fleet.ROOT / "tools" / "telemetry_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert mod.main([str(p) for p in paths]) == 0
    return out.getvalue()


def test_telemetry_report_renders_the_port_streams(single_streams, server_stream):
    base = single_streams[4]
    text = _report(base / "port.jsonl")
    assert "single" in text and "grad" in text.lower()
    both = _report(base / "jax.jsonl", base / "port.jsonl")
    assert "examples/s" in both or "execute_s" in both
    served = _report(server_stream)
    assert "ttft_s" in served and "kv pages" in served


# -- (f) the Server's stream --------------------------------------------------------------


@pytest.fixture(scope="module")
def server_stream(tmp_path_factory):
    """A paged engine behind ``Server(telemetry=...)``: two tenants, a shed at submit."""
    path = tmp_path_factory.mktemp("server") / "serve.jsonl"
    model = lm_mod.TransformerLM(vocab_size=9, seq_len=16, embed_dim=32, num_layers=1,
                                 num_heads=2)
    engine = ContinuousBatchingEngine(model, model.init(torch.Generator().manual_seed(0)),
                                      num_slots=2, kv_layout="paged", page_size=4,
                                      prefill_chunk_sizes=(4, 8), device="cpu")
    server = Server(engine, telemetry=str(path), tenants=parse_tenants("paid:prio=2;free"))
    futs = [server.submit(np.arange(n, dtype=np.int32) % 8, max_new_tokens=4,
                          tenant="paid" if n % 2 else "free") for n in range(1, 7)]
    server.start()
    for f in futs:
        assert f.result(timeout=120).ok
    server.stop(timeout=120)
    return path


def test_server_stream_has_the_jax_event_keys(server_stream):
    rows = jsonl.read_jsonl(str(server_stream))
    kinds = [r["event"] for r in rows]
    assert kinds[:2] == ["manifest", "serve_config"] and kinds[-1] == "serve_summary"
    assert kinds.count("serve") == 6 and kinds.count("prefill") == 6
    assert kinds.count("tenant_summary") == 2 and kinds.count("kv_pages") == 1
    assert {k for k in kinds} <= set(jax_events.EVENT_KINDS)
    reference = {name[:-len("_event")]: getattr(jax_T, name)(*a, **k)
                 for name, (a, k) in EVENT_CALLS.items()}
    for row in rows:
        kind = row["event"]
        if kind in ("serve", "prefill", "tenant_summary", "serve_summary"):
            assert set(row) - {"t_s"} == set(reference[kind]), kind
    summary = rows[-1]
    assert summary["requests"] == 6 and len(summary["bytes"]["per_chip"]) == 1
    assert summary["kv_pages"]["num_pages"] == summary["bytes"]["num_pages"]


def test_manifest_names_the_grid_and_the_device():
    ev = T.manifest_event(config.ComposedConfig(), axes={"data": 2, "model": 2},
                          run_type="composed", device="cpu")
    assert ev["mesh"] == {"axis_names": ["data", "model"], "shape": {"data": 2, "model": 2}}
    assert ev["platform"] == "cpu" and ev["jax_version"] is None
    assert ev["config"] == dataclasses.asdict(config.ComposedConfig())
    assert set(ev) >= set(jax_T.manifest_event(run_type="x")) - {"mesh", "config",
                                                                 "precision"}


def test_step_flops_counts_the_step_and_restores_the_launch_counters():
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import cnn
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import (
        fused_kernels,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import step

    model = cnn.Net()
    state = step.create_train_state(model, torch.Generator().manual_seed(0))
    fn = step.make_train_step(model, learning_rate=0.01, momentum=0.5, use_pallas=True)
    x, y = torch.randn(64, 28, 28, 1), torch.randint(0, 10, (64,))
    before = {k: v.clone() for k, v in state.params.items()}
    counts = fused_kernels.launch_counts()
    flops = T.train_step_flops(fn, state, x, y, 0)
    # the CNN's convs and denses, forward and backward (as FlopCounterMode counts them)
    assert 1.0e8 < flops < 2.5e8
    assert all(torch.equal(before[k], state.params[k]) for k in before)
    assert fused_kernels.launch_counts() == counts


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module's torch work: the suite runs several workers
    on the host's cores, and torch's default of one thread a core each oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
