"""Network-chaos fleet bench: the port of the JAX package's ``tools/bench_chaos_fleet.py``.

A 3-replica echo fleet of the port (``serving/replica.py --echo``: no ``torch``, no
engine — the router mechanics ARE the system under test; deterministic tokens make the
oracle exact) runs a seeded two-wave workload through the chaos proxy
(``resilience/netfaults.py``) with a **10x wire straggler** on one replica plus **corrupt /
truncate / drop** schedules on the others, behind the port's ``serving.Router``. Three
legs, one JSON document, the JAX tool's flags, printed lines, keys and gates:

- **oracle** — the same seeded workload, no chaos, no hedging: the token-stream
  reference and the unfaulted TTFT floor;
- **unhedged chaos** — straggler + wire damage with straggler EJECTION armed but hedging
  off: the tail eats the straggler raw (its p99 is the number hedging is judged against);
- **hedged chaos** — identical chaos, hedging on: requests stuck behind the slow wire get
  a speculative second copy, first completion wins.

Gates (exit 0 = all pass, 3 = any fail):

1. **zero lost requests** in every leg: every submit resolves ok;
2. **100% token identity** vs the oracle leg — redispatch after wire damage and hedge
   races are schedule changes, never answer changes;
3. **>=1 ejection AND >=1 probe-recovery** in each chaos leg, with ZERO process restarts
   (slow is handled in place; the wire faults are typed reconnects, not deaths);
4. **>=1 typed wire fault** in each chaos leg;
5. **zero orphan traces** in the traced chaos legs;
6. **hedge wins the tail**: hedged p99 TTFT <= ``--hedge-ratio`` x unhedged p99 TTFT
   (default 0.8 — "measurably below"), with >=1 hedge win recorded.

The one departure: ``--out-dir`` defaults to ``results/chaos_fleet`` (the JAX tool's
default is its committed ``bench_results/`` folder). The bench touches no device.

Usage::

    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.bench_chaos_fleet
    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.bench_chaos_fleet \
        --quick --out-dir /tmp/chaos
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

PKG = "csed_514_project_distributed_training_using_pytorch_tpu_torch"


def echo_cmd(args) -> list[str]:
    return ["-m", f"{PKG}.serving.replica", "--echo",
            "--num-levels", str(args.num_levels),
            "--seq-len", str(args.seq_len),
            "--num-slots", str(args.num_slots),
            "--max-pending", str(args.max_pending),
            "--echo-delay-s", str(args.echo_delay_s)]


def chaos_spec(args) -> str:
    """The seeded damage schedule. The straggler is the LINK, not the host:
    replica 1's replies each eat ``straggler_ms`` (about 10x the unfaulted
    e2e) for the first ``straggler_count`` messages, then the link heals —
    which is what lets the probe-recovery gate close. Replicas 0 and 2 take
    one corrupt reply and one truncated submit each (typed reconnect +
    ledger-drain replay) plus a dropped connection — deliberately LATER in
    the message schedule than the straggler window, so the hedge A/B
    measures the straggler (the gray failure under test), not a correlated
    all-replicas-down storm (which has its own regression tests)."""
    # Unit budgeting: on the STRAGGLER's serialized pipe, replies coalesce
    # behind each delay (several done lines, one TCP unit), so `count` is
    # small — it must exhaust within wave 1 so the probe finds a healed link.
    # The corrupt/truncate units land mid-wave-1 on the healthy replicas
    # (~one unit per reply there); the drop hits replica 0's SECOND
    # connection — the one the corrupt-triggered reconnect established.
    return (f"delay:replica=1,conn=0,dir=s2c,after=1,ms={args.straggler_ms:g},"
            f"count={args.straggler_count};"
            f"corrupt:replica=0,conn=0,dir=s2c,after=10;"
            f"truncate:replica=2,conn=0,dir=c2s,after=12;"
            f"drop:replica=0,conn=1,dir=s2c,after=6")


def make_workload(args):
    rng = np.random.default_rng(args.seed)
    reqs = []
    for _ in range(args.requests + args.post_requests):
        plen = int(rng.integers(2, 6))
        prompt = rng.integers(0, args.num_levels - 1,
                              size=plen).astype(np.int32)
        reqs.append((prompt, int(rng.integers(3, args.max_new + 1))))
    return reqs


def run_leg(args, reqs, name, *, chaos="", hedge=False, straggler_k=0.0,
            out_dir="", trace=False):
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.router import (
        Router,
    )

    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = (f"{repo_root}:{env['PYTHONPATH']}"
                         if env.get("PYTHONPATH") else repo_root)
    tele = os.path.join(out_dir, f"router_{name}.jsonl")
    trace_dir = os.path.join(out_dir, f"trace_{name}") if trace else ""
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        for stale in os.listdir(trace_dir):   # span files append across runs
            os.unlink(os.path.join(trace_dir, stale))
    if os.path.exists(tele):
        os.unlink(tele)
    router = Router(
        echo_cmd(args), num_replicas=args.replicas,
        heartbeat_dir=os.path.join(out_dir, f"hb_{name}"),
        heartbeat_timeout_s=30.0, backoff_s=0.2,
        telemetry=tele, trace_dir=trace_dir,
        chaos=chaos, chaos_seed=args.seed,
        straggler_k=straggler_k, eject_min_samples=args.eject_min_samples,
        eject_cooldown_s=args.eject_cooldown_s,
        hedge=hedge, hedge_after_s=args.hedge_after_s,
        env=env)
    router.start()
    comps = []
    try:
        if not router.wait_ready(timeout=120):
            raise RuntimeError(f"leg {name}: fleet never came up")
        # Wave 1: the chaos window — paced so the straggler's ledger stays
        # occupied while healthy peers turn over.
        futs = []
        for prompt, max_new in reqs[:args.requests]:
            futs.append(router.submit(prompt, max_new_tokens=max_new,
                                      tenant="paid"))
            time.sleep(args.pace_s)
        comps.extend(f.result(timeout=300) for f in futs)
        if straggler_k > 0:
            # Wait for the eject->probe cycle: the straggler's link healed
            # when its delay schedule ran out, so the cooldown expiry
            # re-opens it. Bounded waits — a missed ejection fails its gate
            # loudly rather than stalling the leg.
            deadline = time.monotonic() + 15
            while (router.replicas[1].ejections < 1
                   and time.monotonic() < deadline):
                time.sleep(0.05)
            deadline = time.monotonic() + args.eject_cooldown_s + 10
            while (router.replicas[1].probes < router.replicas[1].ejections
                   and time.monotonic() < deadline):
                time.sleep(0.05)
        # Wave 2: post-recovery traffic — proves the probed replica serves.
        futs = [router.submit(p, max_new_tokens=n, tenant="paid")
                for p, n in reqs[args.requests:]]
        comps.extend(f.result(timeout=300) for f in futs)
    finally:
        summary = router.stop(timeout=120)
    return comps, summary, trace_dir


def pcts(vals):
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.jsonl import (
        percentiles,
    )

    return percentiles([v for v in vals if v is not None], qs=(50, 95, 99))


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out-dir", default="results/chaos_fleet")
    p.add_argument("--quick", action="store_true",
                   help="CI sizing: fewer requests, same gates, laxer ratio")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--replicas", type=int, default=3)
    p.add_argument("--requests", type=int, default=45,
                   help="wave-1 (chaos window) requests")
    p.add_argument("--post-requests", type=int, default=12,
                   help="wave-2 (post-recovery) requests")
    p.add_argument("--pace-s", type=float, default=0.03,
                   help="wave-1 inter-arrival pacing")
    p.add_argument("--num-levels", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=32)
    p.add_argument("--num-slots", type=int, default=4)
    p.add_argument("--max-pending", type=int, default=8)
    p.add_argument("--max-new", type=int, default=6)
    p.add_argument("--echo-delay-s", type=float, default=0.02,
                   help="per-token replica compute (sets the unfaulted floor)")
    p.add_argument("--straggler-ms", type=float, default=0.0,
                   help="per-reply wire delay on the straggler (0 = 10x the "
                        "unfaulted per-request wall, derived from "
                        "echo-delay-s x max-new)")
    p.add_argument("--straggler-count", type=int, default=4,
                   help="delayed reply UNITS before the straggler's link "
                        "heals (few but serial: each holds the pipe for "
                        "straggler-ms, and replies coalesce behind it)")
    p.add_argument("--straggler-k", type=float, default=3.0)
    p.add_argument("--eject-min-samples", type=int, default=3,
                   help="low on purpose: the straggler's delayed replies "
                        "COALESCE on the slow link (several done lines, one "
                        "TCP unit), so it yields few — but huge — samples")
    p.add_argument("--eject-cooldown-s", type=float, default=1.5)
    p.add_argument("--hedge-after-s", type=float, default=0.0,
                   help="hedge deadline (0 = 3x the unfaulted per-request "
                        "wall — far above normal, far below the straggler)")
    p.add_argument("--hedge-ratio", type=float, default=0.8,
                   help="gate: hedged p99 TTFT <= this x unhedged p99")
    args = p.parse_args(argv)
    if args.quick:
        args.requests = 27
        args.post_requests = 8
        if args.hedge_ratio == 0.8:
            args.hedge_ratio = 0.9       # smoke trip wire on a noisy runner
    # The unfaulted per-request wall: tokens x per-token sleep. The straggler
    # multiplies it ~10x at the WIRE; the hedge deadline sits 3x above normal.
    base_wall = args.echo_delay_s * args.max_new
    if args.straggler_ms <= 0:
        args.straggler_ms = 10 * base_wall * 1000.0
    if args.hedge_after_s <= 0:
        args.hedge_after_s = 3 * base_wall
    os.makedirs(args.out_dir, exist_ok=True)
    spec = chaos_spec(args)
    reqs = make_workload(args)
    n_total = len(reqs)
    print(f"workload: {n_total} requests ({args.requests} through the chaos "
          f"window), straggler {args.straggler_ms:.0f}ms/reply x "
          f"{args.straggler_count}, hedge deadline {args.hedge_after_s:.2f}s")
    print(f"chaos spec: {spec}")

    print("== leg 1/3: oracle (no chaos, no hedging)")
    oracle_comps, oracle_sum, _ = run_leg(args, reqs, "oracle",
                                          out_dir=args.out_dir)
    oracle_tokens = {c.request_id: c.tokens.tolist() for c in oracle_comps}
    oracle_ttft = pcts([c.ttft_s for c in oracle_comps])
    print(f"   {oracle_sum['ok']}/{n_total} ok, ttft p99 "
          f"{oracle_ttft['p99'] * 1e3:.0f}ms")

    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
        trace as trace_mod,
    )

    legs = {}
    for name, hedge in (("unhedged", False), ("hedged", True)):
        print(f"== leg {'2' if not hedge else '3'}/3: chaos, "
              f"hedging {'on' if hedge else 'off'} (traced)")
        comps, summ, trace_dir = run_leg(
            args, reqs, name, chaos=spec, hedge=hedge,
            straggler_k=args.straggler_k, out_dir=args.out_dir, trace=True)
        spans, _ = trace_mod.read_spans([trace_dir])
        tsum = trace_mod.summarize_traces(spans)
        mismatched = sum(
            c.tokens.tolist() != oracle_tokens[c.request_id] for c in comps)
        ttft = pcts([c.ttft_s for c in comps])
        legs[name] = {
            "ok": sum(c.ok for c in comps), "resolved": len(comps),
            "offered": n_total, "mismatched": mismatched,
            "ttft_s": ttft, "e2e_s": pcts([c.e2e_s for c in comps]),
            "ejections": summ["ejections"], "probes": summ["probes"],
            "hedges": summ["hedges"], "hedge_wins": summ["hedge_wins"],
            "hedge_win_rate": summ["hedge_win_rate"],
            "wire_corrupt": summ["wire_corrupt"],
            "redispatches": summ["redispatches"],
            "duplicates": summ["duplicates"],
            "replica_restarts": summ["replica_restarts"],
            "straggler_state": summ["per_replica"][1]["state"],
            "trace": {"traces": tsum["traces"], "orphans": tsum["orphans"],
                      "hedged": tsum["hedged"],
                      "redispatched": tsum["redispatched"]},
        }
        print(f"   {legs[name]['ok']}/{n_total} ok, ttft p99 "
              f"{ttft['p99'] * 1e3:.0f}ms, {summ['ejections']} ejection(s), "
              f"{summ['probes']} probe(s), {summ['hedges']} hedge(s) "
              f"({summ['hedge_wins']} won), {summ['wire_corrupt']} typed "
              f"wire fault(s), {summ['redispatches']} redispatch(es), "
              f"{tsum['orphans']} orphan trace(s), {mismatched} token "
              f"mismatch(es)")

    ratio = (legs["hedged"]["ttft_s"]["p99"]
             / legs["unhedged"]["ttft_s"]["p99"])
    gates = {
        "zero_lost": {
            "resolved": {n: legs[n]["resolved"] for n in legs},
            "ok": {n: legs[n]["ok"] for n in legs},
            "pass": all(legs[n]["ok"] == legs[n]["resolved"] == n_total
                        for n in legs) and oracle_sum["ok"] == n_total},
        "token_identity": {
            "mismatched": {n: legs[n]["mismatched"] for n in legs},
            "pass": all(legs[n]["mismatched"] == 0 for n in legs)},
        "eject_and_recover": {
            "ejections": {n: legs[n]["ejections"] for n in legs},
            "probes": {n: legs[n]["probes"] for n in legs},
            "straggler_state": {n: legs[n]["straggler_state"] for n in legs},
            "replica_restarts": {n: legs[n]["replica_restarts"] for n in legs},
            # Ejected, probed back, and the process never restarted: slow was
            # handled in place, distinct from hang. The final state is
            # recorded but not gated — a residual delayed unit reaching a
            # wave-2 reply can legitimately start a SECOND eject cycle that
            # is mid-cooldown at stop time (the detector doing its job).
            "pass": all(legs[n]["ejections"] >= 1 and legs[n]["probes"] >= 1
                        and legs[n]["replica_restarts"] == 0 for n in legs)},
        "typed_wire_faults": {
            "wire_corrupt": {n: legs[n]["wire_corrupt"] for n in legs},
            "pass": all(legs[n]["wire_corrupt"] >= 1 for n in legs)},
        "zero_orphans": {
            "orphans": {n: legs[n]["trace"]["orphans"] for n in legs},
            "pass": all(legs[n]["trace"]["orphans"] == 0 for n in legs)},
        "hedge_wins_the_tail": {
            "unhedged_p99_s": legs["unhedged"]["ttft_s"]["p99"],
            "hedged_p99_s": legs["hedged"]["ttft_s"]["p99"],
            "oracle_p99_s": oracle_ttft["p99"],
            "ratio": ratio, "limit": args.hedge_ratio,
            "hedge_wins": legs["hedged"]["hedge_wins"],
            "pass": (ratio <= args.hedge_ratio
                     and legs["hedged"]["hedge_wins"] >= 1)},
    }
    doc = {
        "bench": "chaos_fleet",
        "config": {k: getattr(args, k) for k in
                   ("replicas", "requests", "post_requests", "pace_s",
                    "echo_delay_s", "straggler_ms", "straggler_count",
                    "straggler_k", "eject_min_samples", "eject_cooldown_s",
                    "hedge_after_s", "seed", "quick")},
        "chaos_spec": spec,
        "oracle": {"ok": oracle_sum["ok"], "ttft_s": oracle_ttft},
        "legs": legs,
        "gates": gates,
        "pass": all(g["pass"] for g in gates.values()),
    }
    out = os.path.join(args.out_dir, "summary.json")
    with open(out, "w") as f:
        json.dump(doc, f, indent=1, default=float)
    print(f"summary -> {out}  ({'PASS' if doc['pass'] else 'FAIL'})")
    for name, g in gates.items():
        print(f"   gate {name}: {'ok' if g['pass'] else 'FAIL'} "
              f"{ {k: v for k, v in g.items() if k != 'pass'} }")
    return 0 if doc["pass"] else 3


if __name__ == "__main__":
    sys.exit(main())
