"""PyTorch port, the serving load generator and the speculative A/B bench against the JAX
package's tools.

- ``serve_loadgen --summary-json`` writes the JAX tool's single-server keys (read off
  ``tools/serve_loadgen.py``'s source: the summary dict, the chat update and the
  in-process update), for the open loop and the chat scenario with the draft LM;
- the seeded workload and the chat scenario's traffic are the JAX tool's, request for
  request, and two runs of the port offer byte-identical traffic;
- every fleet and tier flag of the JAX tool does what it does there: ``--replicas N``
  runs the port's ``Router`` over N replica processes (the summary has the JAX tool's
  fleet keys), ``--echo`` model-free replicas, ``--tiers`` the prefill/decode handoff, and
  the affinity, autoscale, hedge, chaos, framed-wire and snapshot flags reach the router
  (telemetry, trace and shard are served too);
- ``bench_spec_ab``'s JSON document has ``tools/bench_spec_ab.py``'s keys, with
  ``--fleet`` its two fleet summaries; ``percentiles`` is the JAX package's.

The engines here run a 32-position LM on the CPU; the summary's numbers are not compared
(they are timings), its keys are.
"""

import ast
import concurrent.futures
import importlib.util
import json
import pathlib
import threading

import numpy as np
import pytest
import torch

from csed_514_project_distributed_training_using_pytorch_tpu.utils import jsonl as jax_jsonl
from csed_514_project_distributed_training_using_pytorch_tpu_torch import (
    bench_spec_ab,
    serve_loadgen,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import lm
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import checkpoint

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = ["--device", "cpu", "--seq-len", "32", "--embed-dim", "32", "--num-layers", "1",
        "--num-heads", "2", "--prefill-chunks", "4,8", "--num-slots", "3"]


def _jax_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _main_of(path: pathlib.Path) -> ast.FunctionDef:
    tree = ast.parse(path.read_text(encoding="utf-8"))
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")


def _dict_keys(node: ast.Dict) -> set[str]:
    return {k.value for k in node.keys if isinstance(k, ast.Constant)}


def jax_summary_keys(scenario: str) -> set[str]:
    """The keys ``tools/serve_loadgen.py`` writes for one in-process server: its
    ``doc = {...}``, the chat scenario's ``doc.update`` and the single-server branch's
    ``doc.update`` (the one that writes ``bytes``)."""
    main = _main_of(ROOT / "tools" / "serve_loadgen.py")
    keys: set[str] = set()
    updates = []
    for node in ast.walk(main):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "doc" for t in node.targets)):
            keys |= _dict_keys(node.value)
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "update" and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "doc"):
            updates.append({kw.arg for kw in node.keywords})
    keys |= next(u for u in updates if "bytes" in u)
    if scenario == "chat":
        keys |= next(u for u in updates if "sessions" in u)
    return keys


@pytest.mark.parametrize("scenario", ["batch", "chat"])
def test_summary_has_the_jax_single_server_keys(scenario, tmp_path):
    out = tmp_path / "summary.json"
    load = (["--requests", "6", "--max-new-tokens", "6", "--prompt-lens", "0,4,12",
             "--rate", "200"] if scenario == "batch" else
            ["--scenario", "chat", "--sessions", "2", "--turns", "2", "--max-new-tokens",
             "5", "--prompt-lens", "4,8", "--spec", "draft-lm", "--spec-k", "2"])
    assert serve_loadgen.main(TINY + load + ["--summary-json", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert set(doc) == jax_summary_keys(scenario)
    assert doc["ok"] == doc["requests"] > 0 and doc["new_tokens"] > 0
    if scenario == "chat":
        assert doc["spec"] == "draft-lm" and doc["spec_stats"]["mode"] == "draft-lm"
        assert doc["sessions_done"] == 2
    else:
        assert doc["spec_stats"] is None and doc["decode_invocations"] > 0


def _args(**kw):
    p = serve_loadgen.build_parser()
    return p.parse_args(sum(([f"--{k.replace('_', '-')}", str(v)] for k, v in kw.items()),
                            []))


def test_workload_matches_jax():
    jax_loadgen = _jax_tool("serve_loadgen")
    args = _args(requests=12, prompt_lens="0,5,9", max_new_tokens=7, seed=3,
                 shared_prefix_len=4, temperature=0.5, top_k=3,
                 tenants="paid:prio=2,share=0.25;free:preempt=1")
    ours, theirs = serve_loadgen.make_workload(args, 17), jax_loadgen.make_workload(args, 17)
    assert len(ours) == len(theirs) == 12
    for (p, n, s, t), (jp, jn, js, jt) in zip(ours, theirs):
        np.testing.assert_array_equal(p, jp)
        assert (n, t, s.temperature, s.top_k, s.top_p) == (jn, jt, js.temperature,
                                                            js.top_k, js.top_p)
    assert serve_loadgen.tenant_shares(args.tenants) == jax_loadgen.tenant_shares(
        args.tenants)
    args = _args(prompt_dist="long", seq_len=784)
    assert serve_loadgen.prompt_len_mix(args) == jax_loadgen.prompt_len_mix(args)


class _EchoFront:
    """A front end that answers at once: the reply is the prompt and ``new`` tokens
    that are a function of the prompt; it records every submission."""

    def __init__(self):
        self.lock = threading.Lock()
        self.seen = []

    def submit(self, prompt, *, max_new_tokens, sampling, **kw):
        prompt = np.asarray(prompt, np.int32)
        with self.lock:
            self.seen.append((tuple(prompt.tolist()), max_new_tokens, kw.get("tenant")))
        tail = (int(prompt.sum()) + np.arange(max_new_tokens)) % 16
        comp = type("Comp", (), {"tokens": np.concatenate([prompt, tail]).astype(np.int32),
                                 "ok": True, "new_tokens": max_new_tokens})()
        fut = concurrent.futures.Future()
        fut.set_result(comp)
        return fut


def test_chat_traffic_is_byte_identical_and_the_jax_tools():
    jax_loadgen = _jax_tool("serve_loadgen")
    args = _args(sessions=4, turns=3, max_new_tokens=9, prompt_lens="3,7", seq_len=64,
                 seed=5, tenants="a:share=0.5;b")
    runs = []
    for module in (serve_loadgen, serve_loadgen, jax_loadgen):
        front = _EchoFront()
        comps, rejections, done = module.run_chat(front, args, 17)
        runs.append((sorted(front.seen), len(comps), done, rejections["rejected"]))
    assert runs[0] == runs[1] == runs[2]
    assert runs[0][1] == 12 and runs[0][2] == 4


def jax_fleet_summary_keys() -> set[str]:
    """The keys ``tools/serve_loadgen.py`` writes for a fleet run: its ``doc = {...}`` and
    the fleet branch's ``doc.update`` (the one that writes ``replicas``)."""
    main = _main_of(ROOT / "tools" / "serve_loadgen.py")
    keys: set[str] = set()
    for node in ast.walk(main):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "doc" for t in node.targets)):
            keys |= _dict_keys(node.value)
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "update" and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "doc"):
            if "replicas" in {kw.arg for kw in node.keywords}:
                keys |= {kw.arg for kw in node.keywords}
    return keys


ECHO_FLEET = ["--replicas", "2", "--echo", "--seq-len", "32", "--num-levels", "8",
              "--num-slots", "2", "--max-pending", "4", "--requests", "6",
              "--max-new-tokens", "5", "--prompt-lens", "4,8", "--rate", "200",
              "--summary-json", "s.json", "--telemetry", "t.jsonl"]


def _fleet_run(argv: list[str]) -> tuple[dict, list[dict]]:
    """``serve_loadgen.main(argv)`` in the working directory: its summary and telemetry."""
    assert serve_loadgen.main(argv) == 0
    doc = json.loads(pathlib.Path("s.json").read_text())
    rows = [json.loads(line) for line in open("t.jsonl")] if pathlib.Path(
        "t.jsonl").exists() else []
    assert doc["ok"] == doc["requests"] > 0
    return doc, rows


def _ported_fleet_flag(flag: str, argv: list[str]) -> None:
    """What each fleet flag of the JAX tool does in the port's load generator (run in a
    scratch working directory; the echo fleets start in a fraction of a second)."""
    if flag == "--replicas" and "--shard" in argv:
        doc, rows = _fleet_run(TINY + ["--requests", "6", "--max-new-tokens", "5",
                                       "--prompt-lens", "0,4,12", "--rate", "200",
                                       "--kv-layout", "paged", "--page-size", "8",
                                       "--summary-json", "s.json"] + argv)
        assert set(doc) == jax_fleet_summary_keys()
        assert doc["shard"] == "tp=2" and doc["replicas"] == 1
        assert doc["replica_restarts"] == 0
    elif flag == "--replicas":
        doc, rows = _fleet_run(TINY + ["--requests", "6", "--max-new-tokens", "5",
                                       "--prompt-lens", "0,4,12", "--rate", "200",
                                       "--kv-layout", "paged", "--page-size", "8",
                                       "--summary-json", "s.json"] + argv)
        assert set(doc) == jax_fleet_summary_keys()
        assert doc["replicas"] == 2 and not doc["echo"]
        assert [r["replica"] for r in doc["per_replica"]] == [0, 1]
    elif flag == "--tiers":
        with pytest.raises(SystemExit, match="--tiers needs --replicas N"):
            serve_loadgen.main(["--device", "cpu"] + argv)
        with pytest.raises(SystemExit, match="replica role"):
            serve_loadgen.main(["--device", "cpu", "--replicas", "3"] + argv)
        doc, rows = _fleet_run(ECHO_FLEET + argv)
        assert doc["tiers"] == "prefill:1,decode:1"
        assert doc["handoffs"] == doc["disagg_requests"] == 6
        assert [r["tier"] for r in doc["per_replica"]] == ["prefill", "decode"]
        assert sum(r["event"] == "kv_handoff" for r in rows) == 6
    elif flag == "--snapshot-interval-s":
        doc, rows = _fleet_run(ECHO_FLEET + ["--echo-delay-s", "0.05"] + argv)
        assert any(r["event"] == "fleet_snapshot" for r in rows)
    elif flag == "--affinity":
        doc, rows = _fleet_run(ECHO_FLEET + ["--scenario", "chat", "--sessions", "2",
                                             "--turns", "3"] + argv)
        assert doc["affinity"] == "off" and doc["affinity_rate"] == 0.0
        assert doc["sessions_done"] == 2
        assert next(r for r in rows if r["event"] == "router_config")["affinity"] is False
    elif flag == "--autoscale":
        with pytest.raises(ValueError, match="snapshot_interval_s"):
            serve_loadgen.main(ECHO_FLEET + argv)
        doc, rows = _fleet_run(ECHO_FLEET + ["--max-replicas", "3",
                                             "--snapshot-interval-s", "0.1"] + argv)
        policy = next(r for r in rows if r["event"] == "router_config")["autoscale"]
        assert doc["autoscale"] == "on" and (policy["min_replicas"],
                                             policy["max_replicas"]) == (2, 3)
    elif flag == "--hedge":
        doc, rows = _fleet_run(ECHO_FLEET + ["--echo-delay-s", "0.02", "--hedge-after-s",
                                             "0.05"] + argv)
        config = next(r for r in rows if r["event"] == "router_config")
        assert doc["hedge"] == "on" and config["hedge"] is True
        assert config["hedge_after_s"] == 0.05
    elif flag == "--chaos":
        doc, rows = _fleet_run(ECHO_FLEET + argv)
        assert doc["chaos"] == argv[1]
        assert any(r["event"] == "chaos" and r["kind"] == "delay" for r in rows)
    elif flag == "--echo":
        with pytest.raises(SystemExit, match="--echo needs --replicas N"):
            serve_loadgen.main(["--device", "cpu"] + argv)
        doc, rows = _fleet_run(ECHO_FLEET + argv)
        assert doc["echo"] is True and doc["replica_restarts"] == 0
    elif flag == "--framed-wire":
        doc, rows = _fleet_run(ECHO_FLEET + argv)
        ready = [r for r in rows if r["event"] == "replica" and r["action"] == "ready"]
        assert len(ready) == 2 and not any(r["framed"] for r in ready)


@pytest.mark.parametrize("argv,item", [
    # the fleet's flags are served: each id names the refusal its case replaces
    pytest.param(["--replicas", "2"], None, id="--replicas-A11"),
    pytest.param(["--tiers", "prefill:1,decode:1"], None, id="--tiers-A11"),
    # --telemetry and --shard are served now (their ids are the refusals' they replace):
    # the stream is written, and a serve mesh asks for a world of tp*dp ranks
    pytest.param(["--telemetry", "t.jsonl"], None, id="--telemetry-A11"),
    # --trace-dir too: loadgen.jsonl and server.jsonl, a tree a request, in the summary
    pytest.param(["--trace-dir", "spans"], None, id="--trace-dir"),
    pytest.param(["--snapshot-interval-s", "0.1", "--telemetry", "t.jsonl"], None,
                 id="--snapshot-interval-s-A11"),
    pytest.param(["--shard", "tp=2,dp=2"], "requested 4 devices, have 1", id="--shard-A10"),
    # and behind the router: every replica a world of tp*dp ranks
    pytest.param(["--replicas", "1", "--shard", "tp=2"], None, id="--shard-replicas"),
    pytest.param(["--affinity", "off"], None, id="--affinity-A11"),
    pytest.param(["--autoscale", "on"], None, id="--autoscale-A11"),
    pytest.param(["--hedge", "on"], None, id="--hedge-A11"),
    pytest.param(["--chaos", "delay:replica=1,ms=5"], None, id="--chaos-A11"),
    pytest.param(["--echo"], None, id="--echo-A11"),
    pytest.param(["--framed-wire", "off"], None, id="--framed-wire-A11")],
    ids=lambda x: x if isinstance(x, str) else x[0])
def test_unported_flags_raise_naming_their_item(argv, item, tmp_path, monkeypatch):
    if argv[0] == "--telemetry":
        monkeypatch.chdir(tmp_path)
        assert serve_loadgen.main(["--device", "cpu", "--seq-len", "32", "--embed-dim",
                                   "32", "--num-layers", "1", "--num-heads", "2",
                                   "--requests", "3", "--max-new-tokens", "3",
                                   "--prompt-lens", "4,8",
                                   "--prefill-chunks", "8", "--rate", "100"] + argv) == 0
        kinds = [json.loads(line)["event"] for line in open("t.jsonl")]
        assert kinds.count("serve") == 3 and kinds[-1] == "serve_summary"
        return
    if argv[0] == "--trace-dir":
        monkeypatch.chdir(tmp_path)
        assert serve_loadgen.main(["--device", "cpu", "--seq-len", "32", "--embed-dim",
                                   "32", "--num-layers", "1", "--num-heads", "2",
                                   "--requests", "3", "--max-new-tokens", "3",
                                   "--prompt-lens", "4,8", "--prefill-chunks", "8",
                                   "--rate", "100", "--summary-json", "s.json"] + argv) == 0
        names = {}
        for f in ("loadgen", "server"):
            for line in open(f"spans/{f}.jsonl"):
                row = json.loads(line)
                names.setdefault(row["trace_id"], []).append((f, row["name"]))
        assert len(names) == 3
        for tree in names.values():
            assert ("loadgen", "client") in tree and ("server", "decode") in tree
        doc = json.load(open("s.json"))["trace"]
        assert (doc["traces"], doc["orphans"], doc["dir"]) == (3, 0, "spans")
        return
    if argv[0] == "--shard":
        with pytest.raises(ValueError, match=item):
            serve_loadgen.main(["--device", "cpu"] + argv)
        # behind the router a sharded replica is served (--shard-replicas); a tiered one
        # is refused: the KV handoff installs planes on one rank
        with pytest.raises(SystemExit, match="installs planes on one rank"):
            serve_loadgen.main(["--device", "cpu", "--replicas", "2", "--tiers",
                                "prefill:1,decode:1"] + argv)
        return
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    if "--shard" in argv:
        monkeypatch.setenv("OMP_NUM_THREADS", "1")     # a world's ranks share the cores
    _ported_fleet_flag(argv[0], argv)


def test_percentiles_match_jax():
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 100):
        xs = [None if rng.random() < 0.2 else float(x) for x in rng.exponential(size=n)]
        assert serve_loadgen.percentiles(xs) == jax_jsonl.percentiles(xs)
    assert serve_loadgen.percentiles([float("inf"), 1.0]) == jax_jsonl.percentiles(
        [float("inf"), 1.0])


def _jax_bench_keys() -> tuple[set[str], set[str]]:
    """``tools/bench_spec_ab.py``'s document keys (its ``doc`` literal and
    ``gates_passed``) and its sides' metric keys (``run_side``'s ``metrics``)."""
    tree = ast.parse((ROOT / "tools" / "bench_spec_ab.py").read_text(encoding="utf-8"))
    doc = metrics = None
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            names = {t.id for t in node.targets if isinstance(t, ast.Name)}
            if "doc" in names:
                doc = _dict_keys(node.value)
            if "metrics" in names:
                metrics = _dict_keys(node.value)
    return doc | {"gates_passed"}, metrics


def test_bench_spec_ab_writes_the_jax_document(tmp_path):
    ckpt = tmp_path / "params.msgpack"
    checkpoint.save_params(str(ckpt), lm.TransformerLM().init(torch.Generator().manual_seed(0)))
    out = tmp_path / "ab.json"
    rc = bench_spec_ab.main(["--device", "cpu", "--checkpoint", str(ckpt), "--sessions", "2",
                             "--turns", "1", "--max-new-tokens", "4", "--prompt-lens", "8",
                             "--num-slots", "2", "--out", str(out)])
    doc = json.loads(out.read_text())
    want_doc, want_metrics = _jax_bench_keys()
    assert set(doc) == want_doc
    assert set(doc["a"]) == set(doc["b"]) == want_metrics
    assert doc["token_match_rate"] == 1.0 and doc["b"]["spec_stats"]["mode"] == "ngram"
    assert rc == (0 if doc["gates_passed"] else 1)
    # --fleet: both sides again as 2-replica router fleets (CPU replicas), their summaries
    # embedded with the JAX tool's fleet keys
    out = tmp_path / "ab_fleet.json"
    bench_spec_ab.main(["--device", "cpu", "--checkpoint", str(ckpt), "--sessions", "2",
                        "--turns", "1", "--max-new-tokens", "4", "--prompt-lens", "8",
                        "--num-slots", "2", "--out", str(out), "--fleet", "--workdir",
                        str(tmp_path / "work")])
    fleet = json.loads(out.read_text())["fleet"]
    for side, spec in (("a", "off"), ("b", "ngram")):
        assert set(fleet[side]) == jax_fleet_summary_keys() | {
            "sessions", "turns", "turn_user_tokens", "sessions_done"}
        assert fleet[side]["spec"] == spec and fleet[side]["replicas"] == 2
        assert fleet[side]["ok"] == fleet[side]["requests"] == 2
    assert fleet["b"]["spec_stats"]["mode"] == "ngram"
