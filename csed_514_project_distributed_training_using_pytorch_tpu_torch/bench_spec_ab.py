"""Speculative-decoding A/B on the chat scenario: the port of the JAX package's
``tools/bench_spec_ab.py``.

Runs the same seeded multi-turn chat workload (``serve_loadgen.run_chat``: each turn
resubmits the prior context, the model's reply and fresh user tokens, the traffic n-gram
self-speculation exists for) through a spec-off and a spec-on ``Server`` built from a
trained checkpoint, and writes one JSON document with the numbers the subsystem is
judged by:

- ``token_match_rate``: greedy speculative decoding must emit plain decoding's streams
  (1.0, compared request by request across the two runs);
- ``accepted_tokens_per_step``: emitted tokens per slot per verify invocation (plain
  decode is exactly 1.0);
- ``invocation_ratio``: decode-program invocations per generated token, A over B (each
  invocation reads the whole KV working set).

The document has the JAX tool's keys. The ``*_compilations`` keys are None: the port
compiles nothing while it serves. Without ``--checkpoint`` the tool first trains the pixel
LM with the port's ``train.lm`` on the committed MNIST IDX fixture, so the artifact
reflects a trained model. ``--draft-checkpoint`` gives the draft-LM side trained weights
(the JAX tool reaches them through its fleet's flag); the default is the replica's recipe
at a seeded init. ``--fleet`` also runs both sides as 2-replica router fleets through
``serve_loadgen --replicas 2 --scenario chat`` and embeds the two fleet summaries
(``fleet``: ``a``, ``b``). The engines and the replicas run on ``--device`` (``cuda`` by
default).

Usage::

    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.bench_spec_ab \\
        --out bench_results/spec_ab_cuda.json
    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.bench_spec_ab \\
        --checkpoint results/model_lm.ckpt --spec draft-lm --draft-checkpoint draft.ckpt
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from csed_514_project_distributed_training_using_pytorch_tpu_torch import serve_loadgen
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import lm
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving import (
    ContinuousBatchingEngine,
    Request,
    Server,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.serving.spec.draft_lm import (
    DraftLMDrafter,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import checkpoint

FIXTURE = Path(__file__).resolve().parent.parent / "tests" / "fixtures" / "mnist_idx"


def ensure_checkpoint(args) -> str:
    """``--checkpoint`` as given, else train the default pixel LM with the port's
    ``train.lm`` on the committed MNIST fixture (reused from ``--workdir`` when it is
    there) and return the saved train state's path."""
    if args.checkpoint:
        return args.checkpoint
    cached = os.path.join(args.workdir, "model_lm.ckpt")
    if os.path.exists(cached):
        print(f"reusing trained checkpoint {cached}")
        return cached
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import (
        lm as lm_train,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.config import (
        LMConfig,
    )

    os.makedirs(args.workdir, exist_ok=True)
    # the fixture is 128 train / 100 test images; both batches divide their splits
    cfg = LMConfig(epochs=args.train_epochs, batch_size=32, eval_batch=50,
                   data_dir=args.data_dir, generate=0, results_dir=args.workdir,
                   images_dir=os.path.join(args.workdir, "images"), device=args.device)
    print(f"training checkpoint: {args.train_epochs} epochs on {args.data_dir}")
    lm_train.main(cfg)
    return cached


def chat_args(args, seq_len: int):
    """The ``run_chat`` knob namespace (serve_loadgen's chat flags)."""
    return argparse.Namespace(
        seed=args.seed, sessions=args.sessions, turns=args.turns, turn_user_tokens=4,
        max_new_tokens=args.max_new_tokens, seq_len=seq_len, temperature=0.0, top_k=0,
        top_p=1.0, prompt_dist="custom", prompt_lens=args.prompt_lens, tenants="")


def draft_lm(model: lm.TransformerLM, args) -> DraftLMDrafter:
    """The replica's draft-LM recipe (one layer, half the embed width, the target's
    heads), at a seeded init (``seed + 1``) or from ``--draft-checkpoint``."""
    dm = lm.TransformerLM(vocab_size=model.vocab_size, seq_len=model.seq_len,
                          embed_dim=model.embed_dim // 2, num_layers=1,
                          num_heads=model.num_heads)
    dp = dm.init(torch.Generator().manual_seed(args.seed + 1))
    if getattr(args, "draft_checkpoint", ""):
        dp = checkpoint.load_params_or_state(args.draft_checkpoint, dp)
    return DraftLMDrafter(dm, dp)


def build_side(model, params, args, *, spec: str, drafter=None) -> ContinuousBatchingEngine:
    """One side's engine, warmed up (a 48-token prompt and a promptless request) with
    its counters reset."""
    kw = {}
    if spec != "off":
        kw = dict(spec=spec, spec_k=args.spec_k)
        if spec == "draft-lm":
            kw["drafter"] = drafter if drafter is not None else draft_lm(model, args)
    engine = ContinuousBatchingEngine(model, params, num_slots=args.num_slots,
                                      kv_layout=args.kv_layout, device=args.device, **kw)
    rng = np.random.default_rng(args.seed + 17)
    warm = rng.integers(0, model.vocab_size - 1, size=48).astype(np.int32)
    engine.run([Request(prompt=warm, max_new_tokens=4)])
    engine.run([Request(prompt=np.zeros(0, np.int32), max_new_tokens=2)])
    engine.reset_stats()
    return engine


def run_side(model, params, args, *, spec: str, drafter=None, engine=None):
    """One in-process chat run through a ``Server``: ``(metrics, streams by prompt,
    engine)``. ``engine``, where given, is a side already made by ``build_side``."""
    if engine is None:
        engine = build_side(model, params, args, spec=spec, drafter=drafter)
    server = Server(engine).start()
    t0 = time.monotonic()
    try:
        comps, rejected, _ = serve_loadgen.run_chat(
            server, chat_args(args, model.seq_len), model.vocab_size)
    finally:
        server.stop()
    wall = time.monotonic() - t0
    if rejected["rejected"] or not all(c.ok for c in comps):
        raise RuntimeError(f"spec={spec}: {rejected['rejected']} rejected, "
                           f"{sum(not c.ok for c in comps)} not ok")
    new_tokens = sum(c.new_tokens for c in comps)
    metrics = {
        "spec": spec,
        "spec_k": args.spec_k if spec != "off" else None,
        "requests": len(comps),
        "new_tokens": new_tokens,
        "wall_s": wall,
        "tokens_per_s": new_tokens / wall,
        "decode_invocations": engine.steps,
        "generated_tokens": engine.generated_tokens,
        "invocations_per_token": engine.steps / engine.generated_tokens,
        "spec_stats": engine.spec_stats(),
        "decode_compilations": None,
        "verify_compilations": None,
        "prefill_compilations": None,
    }
    by_prompt = {tuple(int(x) for x in c.request.prompt): np.asarray(c.tokens, np.int32)
                 for c in comps}
    return metrics, by_prompt, engine


def run_fleet_side(args, ckpt: str, *, spec: str) -> dict:
    """One 2-replica router-fleet chat run through ``serve_loadgen``; returns its
    ``--summary-json`` document (the fleet's tokens/s and the router's spec ledger)."""
    out = os.path.join(args.workdir, f"fleet_{spec}.json")
    argv = ["--replicas", "2", "--scenario", "chat",
            "--sessions", str(args.sessions), "--turns", str(args.turns),
            "--max-new-tokens", str(args.max_new_tokens),
            "--prompt-lens", args.prompt_lens, "--num-slots", str(args.num_slots),
            "--kv-layout", args.kv_layout, "--device", args.device,
            "--checkpoint", ckpt, "--seed", str(args.seed),
            "--spec", spec, "--spec-k", str(args.spec_k), "--summary-json", out]
    if args.draft_checkpoint:
        argv += ["--draft-checkpoint", args.draft_checkpoint]
    os.makedirs(args.workdir, exist_ok=True)
    rc = serve_loadgen.main(argv)
    if rc != 0:
        raise SystemExit(f"fleet leg ({spec}) failed with rc {rc}")
    with open(out) as fh:
        return json.load(fh)


def token_match_rate(toks_a: dict, toks_b: dict) -> float:
    """The share of requests whose streams are equal. Greedy chat is deterministic per
    prompt, so the two runs' completions join on the exact prompt tokens; a prompt only
    one side sent (a session whose earlier turn diverged) counts as a mismatch."""
    keys = toks_a.keys() | toks_b.keys()
    return sum(key in toks_a and key in toks_b and bool(np.array_equal(
        toks_a[key], toks_b[key])) for key in keys) / len(keys)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, allow_abbrev=False,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--checkpoint", default="",
                   help="trained train.lm state or params (default: train one on the "
                        "committed MNIST fixture first)")
    p.add_argument("--train-epochs", type=int, default=12)
    p.add_argument("--data-dir", default=str(FIXTURE))
    p.add_argument("--workdir", default="spec_ab_work",
                   help="directory of the trained checkpoint and the fleet summaries")
    p.add_argument("--spec", default="ngram", choices=("ngram", "draft-lm"))
    p.add_argument("--spec-k", type=int, default=4)
    p.add_argument("--draft-checkpoint", default="",
                   help="trained draft-LM params or state for --spec draft-lm (default: "
                        "the recipe's seeded init)")
    p.add_argument("--num-slots", type=int, default=4)
    p.add_argument("--kv-layout", default="contiguous", choices=("contiguous", "paged"))
    p.add_argument("--sessions", type=int, default=6)
    p.add_argument("--turns", type=int, default=3)
    p.add_argument("--max-new-tokens", type=int, default=48)
    p.add_argument("--prompt-lens", default="32,64,96")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fleet", action="store_true",
                   help="also run the 2-replica router-fleet A/B and embed both fleet "
                        "summaries")
    p.add_argument("--gate-tokens-per-step", type=float, default=1.5,
                   help="minimum accepted tokens/step (the acceptance bar)")
    p.add_argument("--gate-invocation-ratio", type=float, default=1.5,
                   help="minimum A/B decode-invocations-per-token ratio")
    p.add_argument("--out", default="bench_results/spec_ab_torch.json")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; no quiet fallback) or cpu")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.single import (
        resolve_device,
    )

    args.device = str(resolve_device(args.device))
    ckpt = ensure_checkpoint(args)
    model = lm.TransformerLM()          # the train.lm default pixel LM
    params = checkpoint.load_params_or_state(ckpt, model.init(torch.Generator()))

    print("== A: spec off")
    a, toks_a, _ = run_side(model, params, args, spec="off")
    print(f"   {a['new_tokens']} tokens in {a['decode_invocations']} invocations, "
          f"{a['tokens_per_s']:.1f} tokens/s")
    print(f"== B: spec {args.spec} k={args.spec_k}")
    b, toks_b, _ = run_side(model, params, args, spec=args.spec)
    sp = b["spec_stats"]
    print(f"   {b['new_tokens']} tokens in {b['decode_invocations']} invocations, "
          f"{b['tokens_per_s']:.1f} tokens/s, accepted tok/step "
          f"{sp['accepted_tokens_per_step']:.2f}, acceptance rate "
          f"{sp['acceptance_rate'] or 0.0:.2f}")
    match = token_match_rate(toks_a, toks_b)
    invocation_ratio = a["invocations_per_token"] / b["invocations_per_token"]
    doc = {
        "metric": f"speculative-decoding A/B ({args.spec} k={args.spec_k}, chat scenario)",
        "checkpoint": ckpt,
        "trained_epochs": None if args.checkpoint else args.train_epochs,
        "scenario": {"sessions": args.sessions, "turns": args.turns,
                     "max_new_tokens": args.max_new_tokens,
                     "prompt_lens": args.prompt_lens, "num_slots": args.num_slots,
                     "seed": args.seed},
        "a": a,
        "b": b,
        "token_match_rate": match,
        "accepted_tokens_per_step": sp["accepted_tokens_per_step"],
        "acceptance_rate": sp["acceptance_rate"],
        "invocation_ratio": invocation_ratio,
        "tokens_per_s_ratio": b["tokens_per_s"] / a["tokens_per_s"],
    }
    print(f"== token match {match:.3f}, {invocation_ratio:.2f}x fewer invocations/token, "
          f"tokens/s ratio {doc['tokens_per_s_ratio']:.2f}x")
    if args.fleet:
        print("== fleet legs (2 replicas each)")
        doc["fleet"] = {"a": run_fleet_side(args, ckpt, spec="off"),
                        "b": run_fleet_side(args, ckpt, spec=args.spec)}
    problems = []
    if match < 1.0:
        problems.append(f"token match {match:.3f} < 1.0")
    if sp["accepted_tokens_per_step"] < args.gate_tokens_per_step:
        problems.append(f"accepted tok/step {sp['accepted_tokens_per_step']:.2f} < "
                        f"{args.gate_tokens_per_step}")
    if invocation_ratio < args.gate_invocation_ratio:
        problems.append(f"invocation ratio {invocation_ratio:.2f} < "
                        f"{args.gate_invocation_ratio}")
    doc["gates_passed"] = not problems
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(doc, fh, indent=1)
    print(f"artifact -> {args.out}")
    if problems:
        print("GATES FAILED: " + "; ".join(problems))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
