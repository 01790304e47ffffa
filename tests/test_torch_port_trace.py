"""PyTorch port, request tracing (``utils/trace.py``, ``trace_report``, ``Server(trace=)``),
against the JAX package.

Span files written by the JAX package's ``Tracer`` (a fleet-shaped trace with a drained
hop, a hedge, speculative draft/verify spans and a lifecycle span, and plain server traces)
give equal ``trace_breakdown``, ``summarize_traces``, ``reconcile_ttft``, ``chrome_trace``
and ``validate_chrome`` results in both packages, and the two ``trace_report`` CLIs print
the same report. A port ``Server`` and a JAX ``Server`` over the same model and requests
write the same span trees: per request the same span names in order, on the same track,
with the same slots, chunks, cache hits, finishes and token counts (times aside).
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from csed_514_project_distributed_training_using_pytorch_tpu.models import lm as jax_lm
from csed_514_project_distributed_training_using_pytorch_tpu.serving.engine import (
    ContinuousBatchingEngine as JaxEngine,
)
from csed_514_project_distributed_training_using_pytorch_tpu.serving.server import (
    Server as JaxServer,
)
from csed_514_project_distributed_training_using_pytorch_tpu.utils import trace as jax_trace
from csed_514_project_distributed_training_using_pytorch_tpu_torch import trace_report
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import lm
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models.lm import (
    params_from_jax,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving import (
    ContinuousBatchingEngine,
    Server,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import trace
from tools import trace_report as jax_trace_report

SMALL = dict(vocab_size=9, seq_len=64, embed_dim=32, num_layers=2, num_heads=4)
RESULT_TIMEOUT = 120.0


def _write_jax_spans(d):
    """A fleet-shaped trace and two server traces, through the JAX package's Tracers."""
    router = jax_trace.Tracer(str(d / "router.jsonl"), proc="router")
    rep0 = jax_trace.Tracer(str(d / "replica0.jsonl"), proc="replica0")
    rep1 = jax_trace.Tracer(str(d / "replica1.jsonl"), proc="replica1")
    client = jax_trace.Tracer(str(d / "loadgen.jsonl"), proc="loadgen")
    t = time.monotonic()
    tid = "fleet-1"
    client.span("client", tid, t, t + 0.9, finish="ok")
    router.span("queue_wait", tid, t + 0.01, t + 0.02, request_id=1)
    router.span("route", tid, t + 0.02, t + 0.021, replica=0, affinity="miss")
    router.span("dispatch", tid, t + 0.021, t + 0.3, replica=0, outcome="drained")
    rep0.span("queue_wait", tid, t + 0.03, t + 0.04, request_id=7, slot=1)
    rep0.span("decode", tid, t + 0.05, t + 0.2, request_id=7, first_token_s=0.01,
              first_token_ts=t + 0.06)
    router.span("redispatch", tid, t + 0.3, None, hop=2, cause="crash")
    router.span("hedge", tid, t + 0.31, None, replica=1)
    router.span("dispatch", tid, t + 0.31, t + 0.8, replica=1, outcome="ok")
    rep1.span("queue_wait", tid, t + 0.32, t + 0.33, request_id=3, slot=0)
    rep1.span("prefill", tid, t + 0.33, t + 0.4, request_id=3, chunk=32, start=0,
              length=20, cache_hit_len=0)
    rep1.span("decode", tid, t + 0.4, t + 0.78, request_id=3, finish="ok", new_tokens=9,
              first_token_s=0.02, first_token_ts=t + 0.42)
    rep1.span("draft", tid, t + 0.45, t + 0.47, request_id=3, k=4, proposed=4)
    rep1.span("verify", tid, t + 0.47, t + 0.5, request_id=3, accepted=2, emitted=3)
    router.span("resolve", tid, t + 0.8, t + 0.81, request_id=1, finish="ok")
    router.span("scale", "fleet-lifecycle", t + 0.5, None, action="up", replica=2)
    server = jax_trace.Tracer(str(d / "server.jsonl"), proc="server")
    for i, tid in enumerate(("srv-a", "srv-b")):
        server.span("queue_wait", tid, t + i, t + i + 0.01, request_id=i, slot=i)
        server.span("decode", tid, t + i + 0.01, t + i + 0.1, request_id=i, slot=i,
                    finish="ok", new_tokens=4, first_token_s=0.003,
                    first_token_ts=t + i + 0.013)
        server.span("resolve", tid, t + i + 0.1, t + i + 0.101, request_id=i,
                    finish="ok", new_tokens=4)
    server.span("queue_wait", "orphan", t + 3, t + 3.1, request_id=9)
    for tracer in (router, rep0, rep1, client, server):
        tracer.close()
    (d / "serve.jsonl").write_text("".join(
        json.dumps({"event": "serve", "request_id": i, "ttft_s": 0.012 + i / 1000}) + "\n"
        for i in range(2)))


def test_reading_and_accounting_match_jax_on_jax_written_spans(tmp_path):
    _write_jax_spans(tmp_path)
    spans, events = trace.read_spans([str(tmp_path)])
    assert (spans, events) == jax_trace.read_spans([str(tmp_path)])
    assert trace.span_files([str(tmp_path)]) == jax_trace.span_files([str(tmp_path)])
    assert trace.assemble(spans) == jax_trace.assemble(spans)
    for tid, tree in trace.assemble(spans).items():
        assert trace.trace_breakdown(tree) == jax_trace.trace_breakdown(tree), tid
    ours = trace.summarize_traces(spans)
    assert ours == jax_trace.summarize_traces(spans)
    assert ours["orphans"] == 1 and ours["redispatched"] == 1 and ours["hedged"] == 1
    fleet = ours["by_trace"]["fleet-1"]
    assert fleet["segments"]["failed_dispatch"] > 0 and fleet["hops"] == 2
    assert abs(sum(fleet["segments"].values()) - fleet["e2e_s"]) < 1e-9
    assert trace.reconcile_ttft(ours, events) == jax_trace.reconcile_ttft(ours, events)
    assert trace.lifecycle_timeline(spans) == jax_trace.lifecycle_timeline(spans)
    doc = trace.chrome_trace(spans)
    assert doc == jax_trace.chrome_trace(spans)
    assert trace.validate_chrome(doc) == jax_trace.validate_chrome(doc) == []
    bad = {"traceEvents": doc["traceEvents"] + [{"ph": "X", "name": "x", "pid": 99,
                                                 "tid": 1, "ts": -1.0, "dur": 1.0,
                                                 "args": {}}]}
    assert trace.validate_chrome(bad) == jax_trace.validate_chrome(bad) != []
    assert (trace.SEGMENTS, trace.TERMINAL_SPANS, trace.LIFECYCLE_SPANS) == (
        jax_trace.SEGMENTS, jax_trace.TERMINAL_SPANS, jax_trace.LIFECYCLE_SPANS)


def test_trace_report_prints_what_the_jax_tool_prints(tmp_path, capsys):
    _write_jax_spans(tmp_path)
    outs = []
    for mod, chrome in ((trace_report, "ours.json"), (jax_trace_report, "theirs.json")):
        rc = mod.main([str(tmp_path), "--slowest", "2", "--validate",
                       "--chrome", str(tmp_path / chrome)])
        outs.append((rc, capsys.readouterr().out.replace(chrome, "C")))
    assert outs[0] == outs[1] and outs[0][0] == 1          # the orphan fails --validate
    assert "1 orphan(s)" in outs[0][1]
    assert json.load(open(tmp_path / "ours.json")) == json.load(open(tmp_path / "theirs.json"))


def test_tracer_writes_the_jax_span_schema(tmp_path):
    """The same calls through both ``Tracer``s give the same rows up to the anchor (taken
    once per tracer, so two tracers' stamps differ by their anchors' difference)."""
    rows = []
    for mod in (trace, jax_trace):
        tr = mod.Tracer(str(tmp_path / f"{mod.__name__}.jsonl"), proc="server")
        assert tr.enabled and not mod.Tracer("", proc="x").enabled
        t = 100.0
        tr.span("decode", "t1", t, t + 0.5, request_id=3, first_token_ts=t + 0.1,
                first_token_s=0.1, skipped=None)
        tr.span("resolve", None, t, t + 1)                  # untraced: nothing written
        tr.span("hedge", "t1", t)
        tr.close()
        rows.append([json.loads(x) for x in open(tmp_path / f"{mod.__name__}.jsonl")])
    for a, b in zip(*rows):
        assert list(a) == list(b)
        assert {k: v for k, v in a.items() if not k.endswith("ts") and k != "t_s"} == {
            k: v for k, v in b.items() if not k.endswith("ts") and k != "t_s"}
        assert abs((a["ts"] - b["ts"]) - (rows[0][0]["ts"] - rows[1][0]["ts"])) < 1e-5
    assert [r["dur_s"] for r in rows[0]] == [0.5, 0.0]
    assert len({trace.new_trace_id() for _ in range(100)}) == 100


def _trees(path) -> dict[int, list[tuple]]:
    """The span trees of a server's span file, keyed by request id, times dropped."""
    keep = ("name", "proc", "slot", "chunk", "start", "length", "cache_hit_len",
            "finish", "new_tokens")
    spans, _ = trace.read_spans([path])
    trees = {}
    for tid, tree in trace.assemble(spans).items():
        rid = next(s["request_id"] for s in tree if "request_id" in s)
        assert all(s.get("request_id") == rid for s in tree)
        trees[rid] = [tuple(s.get(k) for k in keep) for s in tree]
    return trees


def test_port_server_spans_match_the_jax_server(tmp_path):
    jm = jax_lm.TransformerLM(**SMALL)
    jp = jm.init({"params": jax.random.PRNGKey(0)},
                 jnp.zeros((1, SMALL["seq_len"]), jnp.int32))["params"]
    rng = np.random.default_rng(9)
    reqs = [(rng.integers(0, 8, size=n).astype(np.int32), m)
            for n, m in ((3, 6), (20, 5), (0, 4), (40, 7))]
    kw = dict(num_slots=4, prefill_chunk_sizes=(8, 16), kv_layout="paged", page_size=8)
    runs = {}
    for name, server in (
            ("jax", JaxServer(JaxEngine(jm, jp, **kw), trace=str(tmp_path / "jax.jsonl"))),
            ("port", Server(ContinuousBatchingEngine(lm.TransformerLM(**SMALL),
                                                     params_from_jax(jp), device="cpu",
                                                     **kw),
                            trace=str(tmp_path / "port.jsonl")))):
        futs = [server.submit(p, max_new_tokens=m) for p, m in reqs]
        server.start()
        comps = [f.result(timeout=RESULT_TIMEOUT) for f in futs]
        server.stop(timeout=RESULT_TIMEOUT)
        runs[name] = ([c.tokens.tolist() for c in comps], _trees(str(tmp_path /
                                                                    f"{name}.jsonl")))
    assert runs["port"] == runs["jax"]
    trees = runs["port"][1]
    assert len(trees) == 4
    assert [s[0] for s in trees[1]] == ["queue_wait", "prefill", "prefill", "decode",
                                        "resolve"]
    spans, _ = trace.read_spans([str(tmp_path / "port.jsonl")])
    summary = trace.summarize_traces(spans)
    assert summary["orphans"] == 0 and summary["traces"] == 4
    assert trace.validate_chrome(trace.chrome_trace(spans)) == []


def test_untraced_server_writes_nothing_and_keeps_requests_untraced(tmp_path):
    server = Server(ContinuousBatchingEngine(lm.TransformerLM(**SMALL),
                                             lm.TransformerLM(**SMALL).init(
                                                 __import__("torch").Generator()),
                                             num_slots=2, device="cpu"))
    assert not server.tracer.enabled and server.engine.tracer is None
    fut = server.submit(np.arange(3, dtype=np.int32), max_new_tokens=2)
    server.start()
    assert fut.result(timeout=RESULT_TIMEOUT).request.trace_id is None
    server.stop(timeout=RESULT_TIMEOUT)
    assert list(tmp_path.iterdir()) == []
    traced = Server(ContinuousBatchingEngine(lm.TransformerLM(**SMALL),
                                             lm.TransformerLM(**SMALL).init(
                                                 __import__("torch").Generator()),
                                             num_slots=2, device="cpu"),
                    trace=str(tmp_path / "s.jsonl"))
    f1 = traced.submit(np.arange(3, dtype=np.int32), max_new_tokens=2, trace_id="given")
    f2 = traced.submit(np.arange(3, dtype=np.int32), max_new_tokens=2, traced=False)
    traced.start()
    assert f1.result(timeout=RESULT_TIMEOUT).request.trace_id == "given"
    assert f2.result(timeout=RESULT_TIMEOUT).request.trace_id is None
    traced.stop(timeout=RESULT_TIMEOUT)
    spans, _ = trace.read_spans([str(tmp_path / "s.jsonl")])
    assert {s["trace_id"] for s in spans} == {"given"}


@pytest.mark.parametrize("what", ["empty-dir", "events-only"])
def test_trace_report_without_spans_exits_1(what, tmp_path, capsys):
    target = tmp_path / what
    if what == "empty-dir":
        target.mkdir()
    else:
        target.write_text(json.dumps({"event": "serve", "ttft_s": 0.1}) + "\n")
    assert trace_report.main([str(target)]) == 1
    assert "no spans found" in capsys.readouterr().out
