"""Train→serve promotion loop bench: one command closes the loop from a corpus to the fleet.

The port's counterpart of the JAX package's ``tools/train_serve_loop.py``, with its flags,
legs, gates, printed lines and JSON keys. Two things differ: ``--device`` (default
``cuda``; it raises without a card, and the CPU runs only when asked for) goes to every
child, the trainers and the replicas alike, in place of the JAX tool's ``JAX_PLATFORMS=cpu``
and ``platform="cpu"``; and the default output and work directories lie under
``results/``.

A corpus LM trainer (``python -m <port>.train.lm --corpus``) publishes health-stamped
versioned checkpoints while a replica fleet (``serving.router.Router`` over ``python -m
<port>.serving.replica`` processes) serves live traffic; the promoter
(``deploy/promoter.py``) gate-qualifies each candidate (health stamp → ``decode_nll``
accuracy budget → perf tolerance), canaries survivors on ONE replica via the router's
rolling-reload path, and promotes fleet-wide or auto-rolls-back on regression. Four legs,
each with exit-code gates:

- **promote** — trainer + fleet run concurrently under closed-loop traffic; at least one
  candidate qualifies, canaries, and promotes fleet-wide with ZERO lost requests across
  every rolling reload.
- **rollback** — a deliberately param-corrupted candidate (clean health stamp, so only
  measurement can catch it) is rejected at the NLL gate; a second one rides a loosened gate
  into the canary, where the sampled-token NLL under the last-good scorer catches it and
  the fleet auto-rolls-back to the incumbent.
- **resume** — the deterministic-resume invariant: kill-free split training (k epochs,
  then resume from the manifest cursor) produces a final model BITWISE identical to the
  uninterrupted run, epoch stream digests included.
- **data_wait** — a throttled streaming loader shows up in the goodput ledger:
  ``data_wait_s > 0`` and the exclusive segments sum to wall ±1%.

Produces ``--out-dir`` (default ``results/promote_loop/``) with ``summary.json`` (the
gates), ``promotion_ledger.jsonl``, ``promote_telemetry.jsonl`` (promote/canary events —
render with ``python -m <port>.telemetry_report``), ``router.jsonl`` (fleet stream incl.
canary snapshots — watch live with ``tools/fleet_top.py``), and ``goodput.json``.
``--quick`` shrinks everything for a smoke run: 2 replicas, shorter runs.

Usage::

    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.train_serve_loop
    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.train_serve_loop \\
        --quick --device cpu --out-dir /tmp/psl --work-dir /tmp/pslw
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "csed_514_project_distributed_training_using_pytorch_tpu_torch"
_CORPUS = os.path.join(_REPO, "tests", "fixtures", "corpus_tiny")


def _child_env() -> dict:
    env = dict(os.environ)
    existing = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = f"{_REPO}:{existing}" if existing else _REPO
    return env


def train_argv(args, *, epochs, results_dir, telemetry="", resume_from="",
               throttle=0.0, keep=8, guard=True, seed=1) -> list[str]:
    cmd = [sys.executable, "-m", f"{PKG}.train.lm",
           "--corpus", args.corpus, "--epochs", str(epochs),
           "--batch-size", str(args.batch_size),
           "--embed-dim", str(args.embed_dim),
           "--num-layers", str(args.num_layers),
           "--num-heads", str(args.num_heads),
           "--results-dir", results_dir,
           "--images-dir", os.path.join(results_dir, "images"),
           "--seed", str(seed),
           "--keep-checkpoints", str(keep),
           "--device", args.device]
    if guard:
        cmd += ["--guard"]
    if telemetry:
        cmd += ["--telemetry", telemetry]
    if resume_from:
        cmd += ["--resume-from", resume_from]
    if throttle:
        cmd += ["--data-throttle-s", str(throttle)]
    return cmd


def run_train(cmd: list[str], *, cwd: str) -> None:
    os.makedirs(cwd, exist_ok=True)
    r = subprocess.run(cmd, cwd=cwd, env=_child_env(), capture_output=True, text=True)
    if r.returncode != 0:
        sys.stderr.write(r.stdout[-4000:] + r.stderr[-4000:])
        raise SystemExit(f"trainer failed with rc {r.returncode}")


class Scorers:
    """The promoter's probes, built ONCE: ``models.lm.decode_nll`` on a fixed slice of the
    corpus eval split (the accuracy gate and the fixed canary scorer — scored through the
    serving decode path the fleet serves with), and a timed ``decode_nll`` (the perf gate),
    on ``--device``. Params load through the same ``load_params_or_state`` the replicas
    use, onto the device, cached by path (one slot: stores are small).

    By default the model is the corpus LM at ``args``' widths and the rows are the first
    ``--gate-eval-rows`` of the corpus eval split. A caller that serves another LM passes
    ``model`` and ``eval_rows`` (``[rows, model.seq_len]`` token ids); then ``args`` gives
    only ``device`` and no corpus is read."""

    def __init__(self, args, model=None, eval_rows=None):
        import torch

        from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import (
            stream as stream_mod,
        )
        from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import (
            lm,
        )
        from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.single import (
            resolve_device,
        )
        from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
            checkpoint,
        )

        self._torch, self._lm, self._checkpoint = torch, lm, checkpoint
        self.device = resolve_device(args.device)
        if (model is None) != (eval_rows is None):
            raise ValueError("pass model and eval_rows together, or neither")
        if model is None:
            meta = stream_mod.load_meta(args.corpus)
            model = lm.TransformerLM(
                vocab_size=int(meta["vocab"]) + 1, seq_len=int(meta["seq_len"]),
                embed_dim=args.embed_dim, num_layers=args.num_layers,
                num_heads=args.num_heads).to(self.device)
            eval_rows = stream_mod.eval_tokens(args.corpus)[:args.gate_eval_rows]
        self.model = model
        self.seq_len = int(model.seq_len)
        self.vocab = int(model.vocab_size) - 1
        self.template = self.model.init(torch.Generator().manual_seed(0))
        self.eval_tokens = np.asarray(eval_rows, np.int32)
        if self.eval_tokens.ndim != 2 or self.eval_tokens.shape[1] != self.seq_len:
            raise ValueError(f"eval_rows of shape {self.eval_tokens.shape}; want "
                             f"[rows, {self.seq_len}]")
        self._eval = torch.from_numpy(self.eval_tokens.astype(np.int64)).to(self.device)
        self._params_cache: dict[str, dict] = {}

    def _score(self, params: dict, tokens) -> float:
        with self._torch.no_grad():
            return self._lm.decode_nll(self.model, params, tokens).item()

    def params(self, path: str) -> dict:
        got = self._params_cache.get(path)
        if got is None:
            loaded = self._checkpoint.load_params_or_state(path, self.template)
            got = {k: p.to(self.device) for k, p in loaded.items()}
            self._params_cache = {path: got}     # one-slot: stores are small
        return got

    def nll(self, path: str) -> float:
        return self._score(self.params(path), self._eval)

    def perf(self, path: str) -> float:
        """Seconds of one ``decode_nll`` over the eval rows. An untimed call first when
        the params were not resident yet absorbs the load and the copy to the device (the
        cached params are already there)."""
        if path not in self._params_cache:
            self._score(self.params(path), self._eval)
        p = self.params(path)
        t0 = time.perf_counter()
        self._score(p, self._eval)
        return time.perf_counter() - t0

    def sample_nll(self, samples: list[dict], scorer_path: str) -> float | None:
        """Mean NLL of the sampled full sequences under the FIXED scorer at
        ``scorer_path`` (the incumbent) — the canary-vs-fleet comparison scores BOTH
        sides' tokens with the same params, so a regressed canary's generated tokens read
        as surprising while the fleet's read as expected."""
        rows = [s["tokens"] for s in samples if len(s["tokens"]) == self.seq_len]
        if not rows:
            return None
        return self._score(self.params(scorer_path), self._torch.tensor(
            rows, dtype=self._torch.int64, device=self.device))


class Traffic(threading.Thread):
    """Closed-loop fleet load: ``concurrency`` in-flight requests cycling over eval-split
    prompts, every completion tallied by finish — the zero-lost-requests evidence across
    every rolling reload."""

    def __init__(self, router, prompts, *, concurrency, max_new, timeout_s):
        super().__init__(daemon=True, name="loop-traffic")
        self.router = router
        self.prompts = prompts
        self.concurrency = concurrency
        self.max_new = max_new
        self.timeout_s = timeout_s
        self.stop_ev = threading.Event()
        self.ok = 0
        self.finishes: dict[str, int] = {}
        self.errors = 0

    def run(self):
        i = 0
        while not self.stop_ev.is_set():
            futs = []
            for k in range(self.concurrency):
                prompt = self.prompts[(i + k) % len(self.prompts)]
                try:
                    futs.append(self.router.submit(
                        prompt, max_new_tokens=self.max_new, timeout_s=self.timeout_s))
                except Exception:
                    self.errors += 1
            i += self.concurrency
            for f in futs:
                try:
                    comp = f.result(self.timeout_s + 60.0)
                except Exception:
                    self.errors += 1
                    continue
                self.ok += comp.ok
                self.finishes[comp.finish] = self.finishes.get(comp.finish, 0) + 1
            time.sleep(0.02)

    def halt(self):
        self.stop_ev.set()
        self.join(self.timeout_s + 120.0)

    @property
    def lost(self) -> int:
        return self.errors + sum(n for f, n in self.finishes.items() if f != "ok")


def publish_corrupted(store: str, src_path: str, *, step: int, seed: int) -> str:
    """Fabricate the regression the promoter must catch: the incumbent's params plus heavy
    seeded noise, republished as a NEW versioned candidate with a CLEAN health stamp — the
    trainer-side immune system vouched for it, so only the promoter's own measurements
    stand between it and the fleet.

    The file is the JAX tool's, byte for byte, for the same source and seed: the state is
    decoded by the port's msgpack codec, the float leaves of ``params`` are visited in the
    file's own order, one ``normal(0, 2)`` draw each, and the state is encoded with every
    map's keys sorted (the JAX tool's encoder copies the tree through a pytree map, which
    sorts dict keys)."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
        _msgpack,
        checkpoint,
    )

    with open(src_path, "rb") as f:
        state = _msgpack.from_bytes(f.read())
    rng = np.random.default_rng(seed)

    def corrupt(node):
        for key, val in node.items():
            if isinstance(val, dict):
                corrupt(val)
            elif hasattr(val, "dtype") and np.issubdtype(np.dtype(val.dtype), np.floating):
                node[key] = (np.asarray(val) + rng.normal(0.0, 2.0, np.shape(val))
                             ).astype(val.dtype)

    def sorted_keys(node):
        if isinstance(node, dict):
            return {key: sorted_keys(node[key]) for key in sorted(node)}
        return node

    corrupt(state["params"])
    blob = _msgpack.packb(sorted_keys(state))
    name = f"ckpt_{step:08d}.msgpack"
    path = os.path.join(store, name)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)
    man = checkpoint.load_manifest(store)
    man["entries"].append({
        "file": name, "step": step,
        "sha256": hashlib.sha256(blob).hexdigest(), "bytes": len(blob),
        "unix_time": time.time(),
        "health": {"clean": True, "anomalies": 0, "skipped": 0, "step": step},
    })
    mtmp = os.path.join(store, "manifest.json.tmp")
    with open(mtmp, "w") as f:
        json.dump(man, f)
    os.replace(mtmp, os.path.join(store, "manifest.json"))
    return path


def _fleet_checkpoint(router) -> str:
    cmd = router._command
    for i, tok in enumerate(cmd):
        if tok == "--checkpoint" and i + 1 < len(cmd):
            return cmd[i + 1]
    return ""


def run_promote_and_rollback(args, out_dir: str, scorers: Scorers) -> tuple[dict, dict]:
    """Legs 1+2 on ONE fleet session: concurrent train+serve with promotion, then the
    forced-rollback scenario against the promoted incumbent."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.deploy import (
        CanaryConfig,
        GateConfig,
        Promoter,
        read_ledger,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.obs.slo import (
        SLOSpec,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.router import (
        Router,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
        checkpoint,
    )

    wd = args.work_dir
    rd = os.path.join(wd, "train")
    store = os.path.join(rd, "checkpoints")
    tele_a = os.path.join(wd, "train_initial.jsonl")
    tele_b = os.path.join(wd, "train_continue.jsonl")

    print(f"== promote leg: initial {args.initial_epochs}-epoch train")
    run_train(train_argv(args, epochs=args.initial_epochs, results_dir=rd,
                         telemetry=tele_a), cwd=wd)
    ckpt0 = checkpoint.newest_valid_checkpoint(store)
    if not ckpt0:
        raise SystemExit("initial training produced no versioned checkpoint")
    print(f"   serving from {os.path.basename(ckpt0)}")

    replica_cmd = ["-m", f"{PKG}.serving.replica",
                   "--checkpoint", ckpt0,
                   "--seq-len", str(scorers.seq_len),
                   "--num-levels", str(scorers.vocab),
                   "--embed-dim", str(args.embed_dim),
                   "--num-layers", str(args.num_layers),
                   "--num-heads", str(args.num_heads),
                   "--num-slots", "4", "--max-pending", "32",
                   "--prefill-chunks", str(scorers.seq_len),
                   "--seed", "0"]
    # affinity=False: the closed loop cycles a small prompt set, and prefix affinity would
    # pin every prompt to its first-seen replica — the canary would sit at zero requests
    # forever. Least-loaded routing spreads the loop so both sides of the canary
    # comparison accumulate evidence.
    router = Router(
        replica_cmd, num_replicas=args.replicas, device=args.device,
        affinity=False,
        heartbeat_dir=os.path.join(wd, "hb"), heartbeat_timeout_s=120.0,
        backoff_s=0.5, connect_timeout_s=600.0,
        drain_timeout_s=120.0, warm_prefixes=0,
        telemetry=os.path.join(out_dir, "router.jsonl"),
        snapshot_interval_s=2.0,
        slo=SLOSpec.parse(args.slo),
        sample_completions=16).start()
    prompt_len = scorers.seq_len - args.max_new_tokens
    prompts = [np.asarray(row[:prompt_len], np.int32)
               for row in scorers.eval_tokens[:args.traffic_prompts]]
    traffic = Traffic(router, prompts, concurrency=args.concurrency,
                      max_new=args.max_new_tokens, timeout_s=args.request_timeout_s)
    promote_doc = rollback_doc = None
    try:
        if not router.wait_ready(900.0):
            raise SystemExit("fleet never became ready")
        traffic.start()

        print(f"   trainer continues to {args.total_epochs} epochs "
              f"(throttle {args.train_throttle_s}s/batch) while the fleet serves")
        proc = subprocess.Popen(
            train_argv(args, epochs=args.total_epochs, results_dir=rd,
                       telemetry=tele_b, resume_from=ckpt0,
                       throttle=args.train_throttle_s),
            cwd=wd, env=_child_env(),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

        prom = Promoter(
            store, router=router,
            nll_fn=scorers.nll, perf_fn=scorers.perf,
            gate=GateConfig(nll_budget=args.nll_budget,
                            perf_tolerance=args.perf_tolerance, perf_probes=3),
            canary=CanaryConfig(window_s=args.canary_window_s,
                                min_requests=args.canary_min_requests,
                                attainment_margin=args.attainment_margin,
                                nll_margin=args.nll_margin),
            ledger_path=os.path.join(out_dir, "promotion_ledger.jsonl"),
            telemetry=os.path.join(out_dir, "promote_telemetry.jsonl"),
            incumbent=ckpt0)
        # The fixed canary scorer: the incumbent AT JUDGMENT TIME (promotion moves it;
        # both sides of one comparison always share one scorer).
        prom.sample_nll_fn = lambda samples: scorers.sample_nll(samples, prom.incumbent)
        prom.run(stop_fn=lambda: proc.poll() is not None, poll_s=1.0)
        out = proc.communicate()[0]
        if proc.returncode != 0:
            sys.stderr.write(out[-4000:])
            raise SystemExit(f"continuing trainer failed rc {proc.returncode}")
        promoted_ckpt = prom.incumbent
        print(f"   promoter: {prom.counts} — incumbent now "
              f"{os.path.basename(promoted_ckpt)}")

        promote_doc = {
            "initial_checkpoint": os.path.basename(ckpt0),
            "final_incumbent": os.path.basename(promoted_ckpt),
            "promoter_counts": dict(prom.counts),
            "incumbent_advanced": promoted_ckpt != ckpt0,
        }

        # ---- forced rollback, same fleet ----
        newest_step = max(e.get("step", 0) for e in
                          checkpoint.load_manifest(store)["entries"])
        print("== rollback leg: corrupted candidate vs the gate")
        publish_corrupted(store, promoted_ckpt, step=newest_step + 1000,
                          seed=args.seed + 17)
        gate_acts = prom.run_once()
        print(f"   gate verdict: {gate_acts}")

        print("   corrupted candidate vs the canary (gate loosened)")
        publish_corrupted(store, promoted_ckpt, step=newest_step + 2000,
                          seed=args.seed + 29)
        prom.gate = GateConfig(nll_budget=1e9, perf_tolerance=1e9)
        canary_acts = prom.run_once()
        print(f"   canary verdict: {canary_acts}")
        fleet_ckpt = _fleet_checkpoint(router)

        # Post-rollback proof of life: the fleet serves the incumbent.
        settle = traffic.ok
        deadline = time.monotonic() + 120.0
        while traffic.ok < settle + args.concurrency and time.monotonic() < deadline:
            time.sleep(0.25)
    finally:
        traffic.halt()
        summary = router.stop()
        try:
            prom.close()
        except Exception:
            pass
    ledger_actions = [r["action"] for r in
                      read_ledger(os.path.join(out_dir, "promotion_ledger.jsonl"))]
    promote_doc.update({
        "traffic": {"ok": traffic.ok, "lost": traffic.lost,
                    "finishes": traffic.finishes, "errors": traffic.errors},
        "router_summary": {k: summary.get(k) for k in
                           ("requests", "ok", "failed", "redispatches", "restarts")
                           if k in summary},
        "ledger_actions": ledger_actions,
    })
    rollback_doc = {
        "gate_actions": gate_acts,
        "canary_actions": canary_acts,
        "caught_at_gate": gate_acts == ["gate_fail"],
        "rolled_back_from_canary": canary_acts == ["rolled_back"],
        "fleet_checkpoint_after": os.path.basename(fleet_ckpt),
        "fleet_on_last_good": fleet_ckpt == promoted_ckpt,
        "incumbent_after": os.path.basename(prom.incumbent),
    }
    return promote_doc, rollback_doc


def run_resume_leg(args) -> dict:
    """Leg 3: uninterrupted vs split-and-resume training — final model bitwise identical,
    per-epoch stream digests identical."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
        checkpoint,
    )

    wd = args.work_dir
    full_rd = os.path.join(wd, "resume_full")
    s1_rd = os.path.join(wd, "resume_split1")
    s2_rd = os.path.join(wd, "resume_split2")
    full_tele = os.path.join(wd, "resume_full.jsonl")
    s2_tele = os.path.join(wd, "resume_split2.jsonl")
    total, split = args.resume_total_epochs, args.resume_split_epochs
    print(f"== resume leg: {total} epochs uninterrupted vs {split}+resume")
    run_train(train_argv(args, epochs=total, results_dir=full_rd,
                         telemetry=full_tele, guard=False), cwd=wd)
    run_train(train_argv(args, epochs=split, results_dir=s1_rd, guard=False), cwd=wd)
    mid = checkpoint.newest_valid_checkpoint(os.path.join(s1_rd, "checkpoints"))
    cursor = checkpoint.cursor_for(mid)
    run_train(train_argv(args, epochs=total, results_dir=s2_rd,
                         telemetry=s2_tele, resume_from=mid, guard=False), cwd=wd)

    def digests(path):
        out = {}
        with open(path) as f:
            for line in f:
                try:
                    row = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if row.get("event") == "data" and row.get("stream_digest") is not None:
                    out[row["epoch"]] = row["stream_digest"]
        return out

    with open(os.path.join(full_rd, "model_lm.ckpt"), "rb") as f:
        full_bytes = f.read()
    with open(os.path.join(s2_rd, "model_lm.ckpt"), "rb") as f:
        split_bytes = f.read()
    d_full, d_split = digests(full_tele), digests(s2_tele)
    tail = {e: d_full.get(e) == d_split.get(e) for e in d_split}   # resumed epochs only
    bitwise = full_bytes == split_bytes
    print(f"   cursor {cursor}; bitwise={'OK' if bitwise else 'DIVERGED'}, "
          f"digests {tail}")
    return {
        "total_epochs": total, "split_at": split,
        "resume_cursor": cursor,
        "bitwise_identical": bitwise,
        "stream_digests_match": all(tail.values()) and bool(tail),
        "digests_full": d_full, "digests_resumed": d_split,
    }


def run_data_wait_leg(args, out_dir: str) -> dict:
    """Leg 4: a throttled streaming loader must surface in the goodput ledger's
    ``data_wait_s`` segment, with the exclusive decomposition still summing to wall
    ±1%."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.obs import goodput

    wd = args.work_dir
    rd = os.path.join(wd, "throttled")
    tele = os.path.join(out_dir, "train_throttled.jsonl")
    if os.path.exists(tele):
        os.remove(tele)                # goodput reads ONE attempt here
    print(f"== data_wait leg: {args.throttle_epochs} epochs at {args.throttle_s}s/batch")
    run_train(train_argv(args, epochs=args.throttle_epochs, results_dir=rd,
                         telemetry=tele, throttle=args.throttle_s,
                         guard=False, keep=2), cwd=wd)
    report = goodput.decompose([tele])
    seg = report["segments"]
    total = sum(seg.values())
    wall = report["wall_s"]
    gap = abs(total - wall) + report["unaccounted_s"]
    doc = {
        "throttle_s": args.throttle_s,
        "wall_s": wall,
        "segments": seg,
        "segments_total_s": total,
        "unaccounted_s": report["unaccounted_s"],
        "data_wait_s": seg["data_wait_s"],
        "data_wait_positive": seg["data_wait_s"] > 0.0,
        "sums_to_wall_1pct": gap <= 0.01 * wall,
    }
    with open(os.path.join(out_dir, "goodput.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(f"   data_wait {seg['data_wait_s']:.3f}s of {wall:.3f}s wall (gap {gap:.4f}s)")
    return doc


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--corpus", default=_CORPUS)
    p.add_argument("--work-dir", default="results/promote_loop_work")
    p.add_argument("--out-dir", default="results/promote_loop")
    p.add_argument("--device", default="cuda",
                   help="where the scorers, the trainers and the replicas run: 'cuda' "
                        "(the default: raises without a card) or 'cpu'")
    p.add_argument("--replicas", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--embed-dim", type=int, default=32)
    p.add_argument("--num-layers", type=int, default=1)
    p.add_argument("--num-heads", type=int, default=2)
    p.add_argument("--initial-epochs", type=int, default=1)
    p.add_argument("--total-epochs", type=int, default=6)
    p.add_argument("--train-throttle-s", type=float, default=0.3,
                   help="continuing trainer's per-batch brake so checkpoints "
                        "land WHILE the fleet serves (0 = as fast as it can)")
    p.add_argument("--max-new-tokens", type=int, default=16)
    p.add_argument("--concurrency", type=int, default=4)
    p.add_argument("--traffic-prompts", type=int, default=16)
    p.add_argument("--request-timeout-s", type=float, default=300.0)
    p.add_argument("--slo", default="ttft=30,e2e=120,window=60")
    p.add_argument("--gate-eval-rows", type=int, default=16)
    p.add_argument("--nll-budget", type=float, default=0.25,
                   help="gate: candidate decode_nll may exceed incumbent by "
                        "at most this (nats/token)")
    p.add_argument("--perf-tolerance", type=float, default=5.0,
                   help="gate: relative perf-probe slack (probe noise is "
                        "large; the gate still catches order-of-magnitude "
                        "regressions)")
    p.add_argument("--canary-window-s", type=float, default=8.0)
    p.add_argument("--canary-min-requests", type=int, default=3)
    p.add_argument("--attainment-margin", type=float, default=0.25)
    p.add_argument("--nll-margin", type=float, default=0.5,
                   help="canary: sampled-token NLL margin vs the fleet under "
                        "the shared last-good scorer. The fleet's greedy "
                        "tokens are scored by the params that CHOSE them "
                        "(low by construction), so a sane successor sits a "
                        "little above the fleet; corrupted params decode "
                        "near-uniform garbage (~ln(vocab) at generated "
                        "positions) and clear this by a wide gap")
    p.add_argument("--resume-total-epochs", type=int, default=4)
    p.add_argument("--resume-split-epochs", type=int, default=2)
    p.add_argument("--throttle-epochs", type=int, default=2)
    p.add_argument("--throttle-s", type=float, default=0.05)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quick", action="store_true",
                   help="smoke sizing: 2 replicas, shorter runs")
    args = p.parse_args(argv)
    if args.quick:
        args.replicas = min(args.replicas, 2)
        args.total_epochs = min(args.total_epochs, 4)
        args.canary_window_s = min(args.canary_window_s, 5.0)
        args.resume_total_epochs = min(args.resume_total_epochs, 3)
        args.resume_split_epochs = min(args.resume_split_epochs, 1)
        args.train_throttle_s = min(args.train_throttle_s, 0.2)

    # Trainer subprocesses run with cwd=work_dir, so relative --out-dir telemetry paths
    # would resolve against the wrong root: absolutize both.
    args.out_dir = os.path.abspath(args.out_dir)
    args.work_dir = os.path.abspath(args.work_dir)
    os.makedirs(args.out_dir, exist_ok=True)
    os.makedirs(args.work_dir, exist_ok=True)
    t0 = time.monotonic()

    scorers = Scorers(args)                     # fails fast without the asked-for device
    promote_doc, rollback_doc = run_promote_and_rollback(args, args.out_dir, scorers)
    resume_doc = run_resume_leg(args)
    data_doc = run_data_wait_leg(args, args.out_dir)

    gates = {
        "candidate_promoted_fleet_wide":
            promote_doc["promoter_counts"]["promoted"] >= 1
            and promote_doc["incumbent_advanced"],
        "zero_lost_requests":
            promote_doc["traffic"]["lost"] == 0
            and promote_doc["traffic"]["ok"] > 0,
        "regressed_candidate_caught":
            rollback_doc["caught_at_gate"]
            and rollback_doc["rolled_back_from_canary"],
        "fleet_on_last_good_after_rollback":
            rollback_doc["fleet_on_last_good"],
        "resume_bitwise_identical":
            resume_doc["bitwise_identical"]
            and resume_doc["stream_digests_match"],
        "data_wait_measured":
            data_doc["data_wait_positive"],
        "goodput_sums_to_wall_1pct":
            data_doc["sums_to_wall_1pct"],
    }
    doc = {
        "metric": "train→serve promotion loop (DESIGN.md §26)",
        "corpus": args.corpus,
        "quick": args.quick,
        "wall_s": time.monotonic() - t0,
        "promote": promote_doc,
        "rollback": rollback_doc,
        "resume": resume_doc,
        "data_wait": data_doc,
        "gates": gates,
    }
    out = os.path.join(args.out_dir, "summary.json")
    with open(out, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"gates: {gates}")
    print(f"wrote {out}")
    return 0 if all(gates.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
