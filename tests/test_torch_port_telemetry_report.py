"""PyTorch port, the telemetry reader (``<port>/telemetry_report.py``) against the JAX
package's ``tools/telemetry_report.py``, on streams written by each package.

The JAX-written streams are the JAX package's committed run artifacts under
``bench_results/`` (trainer, supervisor, router, chaos, elastic, tiered, tenant, trace and
promotion-loop streams, and bench lines). The port-written ones are made here from numpy
and torch seeds: the port's LM trainer on the corpus fixture (``--telemetry
--health-stats``, the guard, the versioned store, a throttled loader), the port's router
over two ``--echo`` replicas (routes, replicas, snapshots, SLO windows) and the port's
promoter over the trainer's store.

(a) ``summarize`` returns equal dicts, and ``print_summary`` prints equal text, for every
    stream of either package;
(b) the A-vs-B table is equal text for a port stream beside a JAX one;
(c) ``--goodput`` prints equal text (one run, and the A-vs-B table) and ``--emit`` writes
    equal lines;
(d) no stream the port wrote holds an event kind the registry lacks, and the footer counts
    a made-up kind alike in both readers.
"""

import importlib.util
import json
import os
import pathlib

import numpy as np
import pytest

from csed_514_project_distributed_training_using_pytorch_tpu_torch import telemetry_report
from csed_514_project_distributed_training_using_pytorch_tpu_torch.deploy import Promoter
from csed_514_project_distributed_training_using_pytorch_tpu_torch.obs.slo import SLOSpec
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.router import (
    Router,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import lm as lm_train
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
    checkpoint,
    config,
)

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = "csed_514_project_distributed_training_using_pytorch_tpu_torch"
FIXTURE = ROOT / "tests" / "fixtures" / "corpus_tiny"
JAX_STREAMS = sorted(p for p in (ROOT / "bench_results").rglob("*.jsonl")
                     if p.stat().st_size > 0)
PORT_STREAMS = ("trainer", "router", "promoter")


def _jax_report():
    spec = importlib.util.spec_from_file_location(
        "jax_telemetry_report", ROOT / "tools" / "telemetry_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_report():
    return _jax_report()


@pytest.fixture(scope="module")
def port_streams(tmp_path_factory):
    """The three port-written streams, made once: ``{name: path}``."""
    tmp = tmp_path_factory.mktemp("port_streams")
    paths = {name: str(tmp / f"{name}.jsonl") for name in PORT_STREAMS}
    cfg = config.LMConfig(
        corpus=str(FIXTURE), epochs=2, batch_size=16, embed_dim=16, num_layers=1,
        num_heads=2, generate=0, device="cpu", results_dir=str(tmp / "results"),
        images_dir=str(tmp / "images"), keep_checkpoints=2, guard=True,
        data_throttle_s=0.002, telemetry=paths["trainer"], health_stats=True)
    lm_train.main(cfg)

    env_path = os.environ.get("PYTHONPATH", "")
    os.environ["PYTHONPATH"] = f"{ROOT}:{env_path}" if env_path else str(ROOT)
    try:
        router = Router(
            ["-m", f"{PKG}.serving.replica", "--echo", "--num-levels", "8", "--seq-len",
             "32", "--num-slots", "4", "--max-pending", "8", "--echo-delay-s", "0.01"],
            num_replicas=2, heartbeat_dir=str(tmp / "hb"), heartbeat_timeout_s=30.0,
            backoff_s=0.2, telemetry=paths["router"], snapshot_interval_s=0.1,
            slo=SLOSpec.parse("ttft=5,e2e=10,window=30")).start()
        try:
            assert router.wait_ready(60.0)
            rng = np.random.default_rng(7)
            futs = [router.submit(rng.integers(0, 8, 1 + i % 6).astype(np.int32),
                                  max_new_tokens=4 + i % 3) for i in range(12)]
            assert all(f.result(60.0).ok for f in futs)
        finally:
            router.stop()
    finally:
        if env_path:
            os.environ["PYTHONPATH"] = env_path
        else:
            del os.environ["PYTHONPATH"]

    store = str(tmp / "results" / "checkpoints")
    first = checkpoint.load_manifest(store)["entries"][0]["file"]
    nlls = iter([2.0, 1.9])                # the incumbent's, then the candidate's
    prom = Promoter(store, nll_fn=lambda path: next(nlls), telemetry=paths["promoter"],
                    ledger_path=str(tmp / "ledger.jsonl"),
                    incumbent=os.path.join(store, first))
    assert prom.run_once() == ["promoted"]
    prom.close()
    return paths


def _canonical(summary: dict) -> str:
    return json.dumps(summary, sort_keys=True, default=repr)


def _both_print(capsys, jax_report, fn_name, *args) -> tuple[str, str]:
    getattr(jax_report, fn_name)(*args)
    want = capsys.readouterr().out
    getattr(telemetry_report, fn_name)(*args)
    return want, capsys.readouterr().out


@pytest.mark.parametrize("path", JAX_STREAMS,
                         ids=lambda p: str(p.relative_to(ROOT / "bench_results")))
def test_jax_written_stream_summarized_and_printed_alike(capsys, jax_report, path):
    want = jax_report.summarize(str(path))
    got = telemetry_report.summarize(str(path))
    assert _canonical(got) == _canonical(want)
    printed_jax, printed_port = _both_print(capsys, jax_report, "print_summary", want)
    assert printed_port == printed_jax and printed_port


@pytest.mark.parametrize("name", PORT_STREAMS)
def test_port_written_stream_summarized_and_printed_alike(capsys, jax_report,
                                                          port_streams, name):
    path = port_streams[name]
    want = jax_report.summarize(path)
    got = telemetry_report.summarize(path)
    assert _canonical(got) == _canonical(want)
    assert "unknown_events" not in got, got.get("unknown_kinds")
    printed_jax, printed_port = _both_print(capsys, jax_report, "print_summary", want)
    assert printed_port == printed_jax
    expect = {"trainer": ("epochs", "grad_norm_trajectory", "ckpt_saves", "data_wait_s",
                          "stream_digests"),
              "router": ("router_replicas", "snapshots", "replica_table"),
              "promoter": ("promotions",)}[name]
    for key in expect:
        assert got.get(key), (key, sorted(got))


@pytest.mark.parametrize("pair", [
    ("port:trainer", "promote_loop_cpu/train_throttled.jsonl"),
    ("chaos_fleet_cpu/router_oracle.jsonl", "port:router"),
    ("port:promoter", "promote_loop_cpu/promote_telemetry.jsonl"),
], ids=["trainers", "routers", "promoters"])
def test_a_vs_b_table_printed_alike(capsys, jax_report, port_streams, pair):
    files = [port_streams[p[5:]] if p.startswith("port:") else
             str(ROOT / "bench_results" / p) for p in pair]
    assert jax_report.main(files) == 0
    want = capsys.readouterr().out
    assert telemetry_report.main(files) == 0
    got = capsys.readouterr().out
    assert got == want and "B/A" in got


def test_goodput_ledgers_printed_and_emitted_alike(capsys, tmp_path, jax_report,
                                                   port_streams):
    runs = [port_streams["trainer"],
            str(ROOT / "bench_results" / "promote_loop_cpu" / "train_throttled.jsonl"),
            str(ROOT / "bench_results" / "anomaly_train_cpu")]
    for r in runs:
        assert jax_report.main(["--goodput", r, "--emit", str(tmp_path / "jax.jsonl")]) == 0
        want = capsys.readouterr().out
        assert telemetry_report.main(
            ["--goodput", r, "--emit", str(tmp_path / "port.jsonl")]) == 0
        assert capsys.readouterr().out == want and "goodput ledger" in want
    assert jax_report.main(["--goodput", *runs]) == 0
    want = capsys.readouterr().out
    assert telemetry_report.main(["--goodput", *runs]) == 0
    got = capsys.readouterr().out
    assert got == want and "data wait s" in got
    strip = lambda rows: [{k: v for k, v in r.items() if k != "t_s"} for r in rows]
    emitted = [[json.loads(line) for line in open(tmp_path / f"{who}.jsonl")]
               for who in ("jax", "port")]
    assert strip(emitted[1]) == strip(emitted[0]) and len(emitted[0]) == len(runs)


def test_unknown_kinds_counted_alike(capsys, tmp_path, jax_report, port_streams):
    path = tmp_path / "drift.jsonl"
    rows = [json.loads(line) for line in open(port_streams["trainer"])]
    rows[1:1] = [{"event": "not_a_kind", "x": 1}, {"event": "not_a_kind"},
                 {"event": "other_new"}]
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    want, got = jax_report.summarize(str(path)), telemetry_report.summarize(str(path))
    assert _canonical(got) == _canonical(want)
    assert (got["unknown_events"], got["unknown_kinds"]) == (3, ["not_a_kind", "other_new"])
    printed_jax, printed_port = _both_print(capsys, jax_report, "print_summary", want)
    assert printed_port == printed_jax and "not_a_kind" in printed_port


def test_registry_is_the_jax_packages():
    from csed_514_project_distributed_training_using_pytorch_tpu.utils import (
        telemetry_events as jax_events,
    )

    assert telemetry_report.KNOWN_EVENTS == jax_events.KNOWN_EVENTS
