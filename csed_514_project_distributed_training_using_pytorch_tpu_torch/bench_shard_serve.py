"""Sharded and disaggregated serving bench: the port of the JAX package's
``tools/bench_shard_serve.py``, with its flags, printed lines, JSON keys and gates.

Produces ``--out-dir`` (default ``results/shard_serve``) with the three documents the
subsystem is judged by:

- ``shard_serve.json`` — (a) a 2-rank TP replica (``--shard tp=2``: a world of gloo or
  NCCL ranks through ``train.launch``, as ``serve_loadgen --shard`` runs it) driven by the
  SAME seeded workload as the one-device oracle in this process: ``token_identical`` must
  be 1.0, the launch pins must hold under the mesh, and measured params+KV bytes per rank
  must be at most the one device's / 1.8. Plus (b)'s summaries and the trace segment
  table separating prefill-tier / handoff / decode wall.
- ``tiered.jsonl`` — the telemetry stream of a prefill-tier/decode-tier fleet run of the
  port's ``serve_loadgen`` (render: ``python -m <port>.telemetry_report tiered.jsonl``):
  every completion CRC-verified over the framed handoff wire (``handoff_failures == 0``),
  and a second leg that kills the prefill replica mid-run and still loses zero requests.
- ``plan_serve.json`` — the serving planner's candidate table (``plan.search_serve``) with
  measured tokens/s for the top predictions; the gate is that the pick IS the
  measured-best candidate.

Departures from the JAX tool, each for a reason of the port's:

- ``--device`` (default ``cuda``; raises without a card): where the engines, the worlds'
  ranks and the fleets' replicas run.
- (a) serves paged KV (pages of ``IDENTITY_PAGE_SIZE``), the oracle and the world alike,
  so that B6 runs on every rank. The port compiles nothing (its ``*_compilations`` keys
  are None), so ``trace_pins_ok`` holds the port's launch pins instead of trace counts:
  every rank's B6 calls equal layers x that world's decode steps, the ranks' steps are
  equal, and on the card every call is one launch (the CPU's plain version launches
  nothing).
- (c) prices the JAX tool's topology (4 devices, kind ``cpu``, 16 GiB) on the CPU, where
  each candidate is measured as a world of ``tp*dp`` gloo ranks; on the card it prices the
  cards present (``plan.Topology.detect``): one card leaves one candidate, measured in this
  process.
- ``--out-dir`` and ``--work-dir`` default under ``results/``.

Without ``--checkpoint`` the tool first trains the pixel LM with the port's ``train.lm`` on
the committed MNIST IDX fixture, so the artifact reflects a trained model. ``--quick``
shrinks training and load.

Usage::

    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.bench_shard_serve \\
        --quick --checkpoint results/model_lm.ckpt
    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.bench_shard_serve \\
        --quick --device cpu --out-dir sss --work-dir ssw
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

PKG = "csed_514_project_distributed_training_using_pytorch_tpu_torch"
ROOT = Path(__file__).resolve().parent.parent
FIXTURE = ROOT / "tests" / "fixtures" / "mnist_idx"
IDENTITY_PAGE_SIZE = 64          # (a): the paged layout's tokens a page
JAX_TOPOLOGY = dict(num_devices=4, device_kind="cpu", hbm_bytes=16 << 30)   # (c), the CPU


def ensure_checkpoint(args) -> str:
    """``--checkpoint`` verbatim, else train the default pixel LM on the committed MNIST
    fixture with the port's ``train.lm`` and return the saved train state's path."""
    if args.checkpoint:
        return args.checkpoint
    cached = os.path.join(args.work_dir, "model_lm.ckpt")
    if os.path.exists(cached):
        print(f"reusing trained checkpoint {cached}")
        return cached
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import (
        lm as lm_train,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.config import (
        LMConfig,
    )

    os.makedirs(args.work_dir, exist_ok=True)
    cfg = LMConfig(epochs=args.train_epochs, batch_size=32, eval_batch=50,
                   data_dir=args.data_dir, generate=0, results_dir=args.work_dir,
                   images_dir=os.path.join(args.work_dir, "images"), device=args.device)
    print(f"training checkpoint: {args.train_epochs} epochs on {args.data_dir}")
    lm_train.main(cfg)
    return os.path.join(args.work_dir, "model_lm.ckpt")


def _workload(model, n, max_new, seed):
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving import (
        Request,
    )

    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        plen = int(rng.integers(0, 96))
        reqs.append(Request(
            prompt=rng.integers(0, model.vocab_size - 1, size=plen).astype(np.int32),
            max_new_tokens=int(rng.integers(max(1, max_new // 2), max_new + 1)),
            request_id=i))
    return reqs


def _run(engine, reqs):
    t0 = time.monotonic()
    comps = engine.run(reqs)
    wall = time.monotonic() - t0
    toks = {c.request.request_id: np.asarray(c.tokens, np.int32) for c in comps}
    return toks, wall


def _model_widths(model) -> dict:
    return dict(vocab_size=model.vocab_size, seq_len=model.seq_len,
                embed_dim=model.embed_dim, num_layers=model.num_layers,
                num_heads=model.num_heads, num_kv_heads=model.num_kv_heads)


def run_world(model, params, args, *, tp: int, dp: int, requests: int, max_new: int,
              seed: int, warm: bool = False, kv_layout: str = "contiguous",
              tag: str = "world") -> dict:
    """The sharded engine on ``build_serve_mesh(tp, dp)`` as a world of ``tp*dp`` ranks of
    this module (``--mesh-child``) through ``train.launch``, every rank serving the same
    seeded requests (``engine.run``), ``params`` handed over in a params file; returns rank
    0's document (``_mesh_child``)."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.launch import (
        launch,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
        checkpoint,
    )

    os.makedirs(args.work_dir, exist_ok=True)
    params_path = os.path.join(args.work_dir, f"{tag}_params.ckpt")
    checkpoint.save_params(params_path, params)
    spec = {"model": _model_widths(model), "params": params_path, "tp": tp, "dp": dp,
            "num_slots": args.num_slots, "kv_layout": kv_layout, "requests": requests,
            "max_new": max_new, "seed": seed, "warm": warm, "device": args.device,
            "out": os.path.join(args.work_dir, f"{tag}.json")}
    spec_path = os.path.join(args.work_dir, f"{tag}_spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = (f"{ROOT}:{env['PYTHONPATH']}" if env.get("PYTHONPATH")
                         else str(ROOT))
    if args.device == "cpu":
        env.setdefault("OMP_NUM_THREADS", "1")   # the world's ranks share the cores
    rc = launch(["-m", f"{PKG}.bench_shard_serve", "--mesh-child", spec_path],
                num_processes=tp * dp, timeout=900, env=env)
    if rc != 0:
        raise SystemExit(f"the tp={tp},dp={dp} world exited {rc}")
    with open(spec["out"]) as f:
        return json.load(f)


def _mesh_child(spec_path: str) -> None:
    """One rank of ``run_world``'s world: the engine on the serve mesh, B6 calls counted
    around ``ops.paged_attention.paged_attend`` (on the card each is one launch), the
    requests served, then every rank's counters and the byte accounting gathered; rank 0
    writes the document."""
    import torch.distributed as dist

    from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import lm
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import (
        paged_attention,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.mesh import (
        cluster,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving import (
        ContinuousBatchingEngine,
        shard as shard_mod,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
        checkpoint,
    )

    with open(spec_path) as f:
        spec = json.load(f)
    with cluster(spec["device"]):
        model = lm.TransformerLM(**spec["model"])
        params = checkpoint.load_params_or_state(
            spec["params"], model.init(torch.Generator().manual_seed(0)))
        calls = [0]
        real = paged_attention.paged_attend

        def counted(*a, **kw):
            calls[0] += 1
            return real(*a, **kw)

        paged_attention.paged_attend = counted
        engine = ContinuousBatchingEngine(
            model, params, num_slots=spec["num_slots"], kv_layout=spec["kv_layout"],
            page_size=IDENTITY_PAGE_SIZE,
            mesh=shard_mod.build_serve_mesh(spec["tp"], spec["dp"]),
            device=spec["device"])
        reqs = _workload(model, spec["requests"], spec["max_new"], spec["seed"])
        if spec["warm"]:
            engine.run(reqs[:1])       # first use outside the measured window
            engine.reset_stats()
        paged_attention.reset_launch_counts()
        calls[0] = 0
        toks, wall = _run(engine, reqs)
        acct = engine.byte_accounting()
        shard_mod.check_replicas(engine)
        mine = {"rank": dist.get_rank(), "steps": engine.steps, "b6_calls": calls[0],
                "b6_launches": paged_attention.launch_counts()["paged_attend"]}
        ranks = [None] * dist.get_world_size()
        dist.all_gather_object(ranks, mine)
        if dist.get_rank() == 0:
            doc = {"tokens": {str(i): t.tolist() for i, t in toks.items()},
                   "wall_s": wall, "acct": acct, "ranks": ranks}
            tmp = spec["out"] + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, spec["out"])


def launch_pins_ok(ranks: list[dict], num_layers: int, device: str) -> bool:
    """The port's pins under the mesh: every rank's B6 calls = layers x its decode steps,
    the ranks' steps equal, and on the card every call one launch (none on the CPU)."""
    steps = {r["steps"] for r in ranks}
    launched = all(r["b6_launches"] == (r["b6_calls"] if device.startswith("cuda") else 0)
                   for r in ranks)
    return (len(steps) == 1 and steps.pop() > 0 and launched
            and all(r["b6_calls"] == num_layers * r["steps"] for r in ranks))


def run_shard_identity(model, params, args) -> dict:
    """Part (a): the 2-rank TP replica vs the one-device oracle — token identity, the
    launch pins, and the measured per-rank byte gate."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving import (
        ContinuousBatchingEngine,
        shard as shard_mod,
    )

    reqs = _workload(model, args.requests, args.max_new_tokens, args.seed)
    print(f"== shard identity: {len(reqs)} requests, single chip vs {args.shard}")

    oracle = ContinuousBatchingEngine(model, params, num_slots=args.num_slots,
                                      kv_layout="paged", page_size=IDENTITY_PAGE_SIZE,
                                      device=args.device)
    want, wall_1 = _run(oracle, reqs)
    acct_1 = oracle.byte_accounting()
    del oracle

    tp, dp = shard_mod.parse_shard_spec(args.shard)
    world = run_world(model, params, args, tp=tp, dp=dp, requests=args.requests,
                      max_new=args.max_new_tokens, seed=args.seed, kv_layout="paged",
                      tag="shard_identity")
    got = {int(i): np.asarray(t, np.int32) for i, t in world["tokens"].items()}
    acct_n = world["acct"]

    matched = sum(int(np.array_equal(want[i], got.get(i))) for i in want)
    identical = matched / len(want)
    single_pk = acct_1["params_bytes"] + acct_1["kv_bytes_resident"]
    per_chip_pk = acct_n["params_kv_bytes_per_chip_max"]
    ratio = per_chip_pk / single_pk
    pins_ok = launch_pins_ok(world["ranks"], model.num_layers, args.device)
    doc = {
        "shard": acct_n["mesh"],
        "requests": len(reqs),
        "token_identical": identical,
        "trace_pins_ok": pins_ok,
        "decode_compilations": None,
        "prefill_compilations": None,
        "single_chip": {"params_bytes": acct_1["params_bytes"],
                        "kv_bytes_resident": acct_1["kv_bytes_resident"],
                        "params_kv_bytes": single_pk,
                        "wall_s": wall_1},
        "per_chip": {str(k): v for k, v in acct_n["per_chip"].items()},
        "params_kv_bytes_per_chip_max": per_chip_pk,
        "per_chip_over_single_ratio": ratio,
        "byte_gate": f"per-chip params+KV <= single-chip / 1.8 "
                     f"(measured ratio {ratio:.4f})",
        "sharded_wall_s": world["wall_s"],
    }
    launches = ", ".join(f"rank {r['rank']}: {r['b6_calls']} B6 calls / "
                         f"{r['b6_launches']} launches, {r['steps']} steps"
                         for r in world["ranks"])
    print(f"   token identity {matched}/{len(want)}, per-chip params+KV ratio {ratio:.4f} "
          f"(gate <= {1 / 1.8:.4f}), trace pins {'OK' if pins_ok else 'BROKEN'} "
          f"({launches}; {model.num_layers} layers)")
    if identical != 1.0:
        raise SystemExit("sharded tokens diverged from the single-chip oracle")
    if ratio > 1 / 1.8:
        raise SystemExit(f"per-chip byte ratio {ratio:.4f} > 1/1.8 — "
                         "sharding did not reduce residency")
    if not pins_ok:
        raise SystemExit("launch pins broke under the mesh")
    return doc


def run_tier_leg(args, loadgen, ckpt, *, name, telemetry, kill=False) -> dict:
    """One tiered-fleet run through the port's serve_loadgen; returns its summary doc."""
    out = os.path.join(args.work_dir, f"{name}_summary.json")
    trace_dir = os.path.join(args.work_dir, f"{name}_trace")
    argv = ["--replicas", "2", "--tiers", "prefill:1,decode:1",
            "--checkpoint", ckpt, "--seed", str(args.seed),
            "--num-slots", str(args.num_slots),
            "--requests", str(args.requests),
            "--max-new-tokens", str(args.max_new_tokens),
            "--prompt-lens", "8,32,64", "--mode", "closed",
            "--concurrency", "4", "--max-restarts", "3",
            "--heartbeat-timeout-s", "60",
            "--telemetry", telemetry, "--trace-dir", trace_dir,
            "--summary-json", out, "--device", args.device]
    label = "kill prefill replica mid-run" if kill else "clean"
    print(f"== tiered fleet ({label}): prefill:1,decode:1, {args.requests} requests")
    old = os.environ.pop("RESILIENCE_FAULTS", None)
    try:
        if kill:
            os.environ["RESILIENCE_FAULTS"] = f"kill:proc=0,step={args.kill_step}"
        rc = loadgen.main(argv)
    finally:
        os.environ.pop("RESILIENCE_FAULTS", None)
        if old is not None:
            os.environ["RESILIENCE_FAULTS"] = old
    if rc != 0:
        raise SystemExit(f"tiered fleet leg ({name}) failed with rc {rc}")
    with open(out) as f:
        summ = json.load(f)
    if summ["ok"] != args.requests or summ.get("failed"):
        raise SystemExit(f"tiered leg ({name}): {summ['ok']}/{args.requests} ok — "
                         f"requests lost")
    if not kill and (summ.get("handoff_failures") or 0):
        raise SystemExit(f"clean tiered leg had {summ['handoff_failures']} handoff "
                         f"failures")
    summ["_trace_dir"] = trace_dir
    return summ


def trace_segment_table(trace_dir) -> dict:
    """Reduce a tiered run's spans to the per-segment wall table — the gate is that
    prefill_tier / handoff / decode are separated, exclusively."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.trace import (
        read_spans,
        summarize_traces,
    )

    spans, _ = read_spans([trace_dir])
    summary = summarize_traces(spans)
    seg = summary["segments"]
    table = {name: {"p50_s": row.get("p50"), "total_s": row.get("total")}
             for name, row in seg.items()
             if (row.get("total") or 0) > 0}
    print("   trace segments (p50):")
    for name in ("prefill_tier", "handoff", "decode_first", "decode_tail"):
        row = seg.get(name) or {}
        print(f"     {name:>14}  {((row.get('p50') or 0)) * 1e3:8.2f} ms")
    return {"traces": summary["traces"], "segments": table}


def plan_topology(device: str):
    """(c)'s topology: the JAX tool's on the CPU; on the card the cards present."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.plan import Topology

    if not device.startswith("cuda"):
        return Topology(**JAX_TOPOLOGY)
    return dataclasses.replace(Topology.detect(device),
                               num_devices=torch.cuda.device_count())


def run_plan_serve(model, args, *, topo=None, measure=None) -> dict:
    """Part (c): the serving planner with real measurement — the gate is pick ==
    measured-best. ``topo`` defaults to ``plan_topology(args.device)``; ``measure``
    (``(tp, dp) -> tokens/s``) to serving a seeded-init engine: in this process at one
    device, else as a world of ``tp*dp`` ranks."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.plan import (
        search_serve,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.plan.scenarios import (
        for_serve,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving import (
        ContinuousBatchingEngine,
    )

    params = model.init(torch.Generator().manual_seed(0))
    n_meas = args.measure_requests

    def measure_world(tp, dp):
        if tp * dp == 1:
            engine = ContinuousBatchingEngine(model, params, num_slots=args.num_slots,
                                              device=args.device)
            reqs = _workload(model, n_meas, args.max_new_tokens, args.seed + 31)
            engine.run(reqs[:1])        # first use outside the measured window
            toks, wall = _run(engine, reqs)
            new = sum(len(t) for t in toks.values())
        else:
            world = run_world(model, params, args, tp=tp, dp=dp, requests=n_meas,
                              max_new=args.max_new_tokens, seed=args.seed + 31, warm=True,
                              tag=f"plan_tp{tp}_dp{dp}")
            new = sum(len(t) for t in world["tokens"].values())
            wall = world["wall_s"]
        print(f"   measured tp={tp},dp={dp}: {new / wall:.1f} tokens/s")
        return new / wall

    topo = topo if topo is not None else plan_topology(args.device)
    sc = for_serve(model, num_slots=args.num_slots, prompt_len=64, topo=topo,
                   measure=measure or measure_world)
    print(f"== plan serve: {topo.num_devices} devices, {args.num_slots} slots, "
          f"measure top {args.measure_top}")
    rows = search_serve(sc, measure_top=args.measure_top)
    if len(rows) == 1:
        print(f"   {topo.num_devices} {topo.device_kind} device(s) leave one candidate: "
              f"{rows[0].shard_spec()}")
    measured = [r for r in rows if r.measured_tokens_per_s is not None]
    best = max(measured, key=lambda r: r.measured_tokens_per_s)
    pick_is_best = rows[0] is best
    doc = {
        "metric": "serving scenario planner (predict -> prune -> measure)",
        "topology": {"num_devices": topo.num_devices, "device_kind": topo.device_kind,
                     "hbm_bytes": topo.hbm_bytes},
        "num_slots": args.num_slots,
        "prompt_len": 64,
        "candidates": [
            {"shard": r.shard_spec(), "tp": r.tp, "dp": r.dp,
             "predicted_tokens_per_s": r.costs.tokens_per_s,
             "params_bytes_per_chip": r.costs.params_bytes_per_chip,
             "kv_bytes_per_chip": r.costs.kv_bytes_per_chip,
             "slots_at_budget": r.costs.slots_at_budget,
             "fits": r.costs.fits,
             "measured_tokens_per_s": r.measured_tokens_per_s}
            for r in rows],
        "picked": rows[0].shard_spec(),
        "measured_best": best.shard_spec(),
        "pick_is_measured_best": pick_is_best,
    }
    print(f"   picked {doc['picked']} ({rows[0].measured_tokens_per_s:.1f} tokens/s "
          f"measured); measured-best {doc['measured_best']}")
    if not pick_is_best:
        raise SystemExit("planner pick is not the measured-best candidate")
    return doc


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", default="",
                   help="trained train.lm TrainState/params (default: train one on the "
                        "committed MNIST fixture first)")
    p.add_argument("--train-epochs", type=int, default=12)
    p.add_argument("--data-dir", default=str(FIXTURE))
    p.add_argument("--work-dir", default="results/shard_serve_work",
                   help="scratch dir for the checkpoint, traces + summaries")
    p.add_argument("--out-dir", default="results/shard_serve")
    p.add_argument("--shard", default="tp=2",
                   help="the sharded replica's mesh for the identity leg")
    p.add_argument("--num-slots", type=int, default=8)
    p.add_argument("--requests", type=int, default=16)
    p.add_argument("--max-new-tokens", type=int, default=32)
    p.add_argument("--measure-top", type=int, default=3)
    p.add_argument("--measure-requests", type=int, default=6)
    p.add_argument("--kill-step", type=int, default=3,
                   help="RESILIENCE_FAULTS step for the prefill-kill leg")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quick", action="store_true",
                   help="CI smoke sizing: tiny training + load")
    p.add_argument("--device", default="cuda",
                   help="the engines', the worlds' and the replicas' device: cuda (the "
                        "default; raises without a card) or cpu")
    p.add_argument("--mesh-child", default="", help=argparse.SUPPRESS)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.mesh_child:
        _mesh_child(args.mesh_child)
        return 0
    if args.quick:
        args.train_epochs = min(args.train_epochs, 2)
        args.requests = min(args.requests, 8)
        args.max_new_tokens = min(args.max_new_tokens, 12)
        args.measure_top = min(args.measure_top, 2)
        args.measure_requests = min(args.measure_requests, 3)
    from csed_514_project_distributed_training_using_pytorch_tpu_torch import (
        serve_loadgen as loadgen,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import lm
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.single import (
        resolve_device,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
        checkpoint,
    )

    args.device = str(resolve_device(args.device))     # fail fast: no card, no cuda
    os.makedirs(args.out_dir, exist_ok=True)
    os.makedirs(args.work_dir, exist_ok=True)

    ckpt = ensure_checkpoint(args)
    model = lm.TransformerLM()          # the train.lm default pixel LM
    init = model.init(torch.Generator().manual_seed(0))
    params = checkpoint.load_params_or_state(ckpt, init)

    shard_doc = run_shard_identity(model, params, args)

    telemetry = os.path.join(args.out_dir, "tiered.jsonl")
    clean = run_tier_leg(args, loadgen, ckpt, name="tiered", telemetry=telemetry)
    segments = trace_segment_table(clean.pop("_trace_dir"))
    kill = run_tier_leg(args, loadgen, ckpt, name="tiered_kill",
                        telemetry=os.path.join(args.work_dir, "tiered_kill.jsonl"),
                        kill=True)
    kill.pop("_trace_dir", None)
    print(f"   clean: {clean['handoffs']} handoffs ({clean['handoff_bytes']} B, "
          f"{clean['handoff_failures']} failed); kill: {kill['ok']}/{args.requests} ok "
          f"after {sum(r.get('restarts', 0) for r in kill.get('per_replica', []))} "
          f"restart(s)")

    plan_doc = run_plan_serve(model, args)
    with open(os.path.join(args.out_dir, "plan_serve.json"), "w") as f:
        json.dump(plan_doc, f, indent=1)

    doc = {
        "metric": "sharded + disaggregated serving (DESIGN.md §25)",
        "checkpoint": ckpt,
        "trained_epochs": None if args.checkpoint else args.train_epochs,
        "quick": args.quick,
        "shard_identity": shard_doc,
        "tiered_fleet": {
            "clean": clean,
            "prefill_kill": kill,
            "zero_lost_under_kill": kill["ok"] == args.requests,
            "trace": segments,
        },
        "plan_serve": {"picked": plan_doc["picked"],
                       "pick_is_measured_best": plan_doc["pick_is_measured_best"],
                       "file": "plan_serve.json"},
        "gates": {
            "token_identical": shard_doc["token_identical"] == 1.0,
            "per_chip_bytes_le_single_over_1p8":
                shard_doc["per_chip_over_single_ratio"] <= 1 / 1.8,
            "trace_pins_ok": shard_doc["trace_pins_ok"],
            "handoffs_crc_verified_zero_failures":
                (clean.get("handoff_failures") or 0) == 0,
            "zero_requests_lost_under_prefill_kill": kill["ok"] == args.requests,
            "plan_pick_is_measured_best": plan_doc["pick_is_measured_best"],
        },
    }
    out = os.path.join(args.out_dir, "shard_serve.json")
    with open(out, "w") as f:
        json.dump(doc, f, indent=1)
    ok = all(doc["gates"].values())
    print(f"gates: {doc['gates']}")
    print(f"wrote {out}, {telemetry}, {os.path.join(args.out_dir, 'plan_serve.json')}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
