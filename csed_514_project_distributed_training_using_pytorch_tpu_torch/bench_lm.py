"""Pixel-LM throughput bench: training steps/s and decode tokens/s, on the port.

Counterpart of the repository's ``bench_lm.py``, with its flags, defaults (d_model 256, 4
layers, 8 heads, bf16, batch 64, seq 784, decode batch 8, 20 steps a run) and JSON keys.
The training half times ``--steps`` SGD steps of ``models.lm.next_token_loss`` on one fixed
random batch as one segment of ``train.step.make_epoch_from_step``: on the card a CUDA graph
captured once and replayed, so a timed run is one replay (eager on the CPU). The decode
half times ``models.lm.generate`` (temperature 1, eager, one position a step) at the decode
batch. Protocol: one untimed warm-up of each, then three timed runs, each ended by a device
sync (a loss or the sampled tokens fetched to the host); the medians are the values. A
timed decode run is one ``generate`` call: ``decode_chain_lengths`` records 1 for each, and
``decode_chain_converged`` is true (no chained difference is taken).

``mfu_vs_bf16_peak`` and ``decode_hbm_roofline_frac`` are against the H100's 989 TFLOP/s
(bf16, dense) and 3.35 TB/s, on the card only. The model FLOPs and the decode bytes are the
reference bench's formulas. The bench runs on the card and exits non-zero without one,
unless ``--device cpu`` asks for the CPU. It prints exactly one JSON line::

    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.bench_lm
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import lm as lm_mod
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.single import (
    resolve_device,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.step import (
    create_train_state,
    make_epoch_from_step,
    make_train_step,
    segment_program,
)

BF16_PEAK_FLOPS = 989e12      # H100 SXM, bf16 dense (NVIDIA's data sheet)
HBM_PEAK_BYTES_PER_S = 3.35e12  # H100 SXM device memory
TIMED_RUNS = 3


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure(args) -> dict:
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    model = lm_mod.TransformerLM(
        vocab_size=args.vocab + 1, seq_len=args.seq, embed_dim=args.d_model,
        num_layers=args.layers, num_heads=args.heads, num_kv_heads=args.kv_heads or None,
        rope=args.rope, attention_window=args.window or 0, dropout_rate=0.0,
        dtype=dtype).to(device)
    rng = np.random.default_rng(0)
    targets = torch.from_numpy(rng.integers(0, args.vocab, size=(args.batch, args.seq))
                               .astype(np.int32)).to(device)
    zeros = torch.zeros(args.batch, dtype=torch.int64, device=device)
    plan = torch.arange(args.batch, device=device).repeat(args.steps, 1)
    state = create_train_state(model, torch.Generator().manual_seed(1), device=device)

    def lm_loss(params, xs, ys, rng_):
        return lm_mod.next_token_loss(model, params, xs, None, deterministic=True)

    step = make_train_step(model, learning_rate=1e-3, momentum=0.0, loss_fn=lm_loss)
    run_train = make_epoch_from_step(step)

    def timed_train(state):
        t0 = time.perf_counter()
        state, losses = run_train(state, targets, zeros, plan, 2)
        last = losses[-1].item()                      # the sync
        return state, time.perf_counter() - t0, last

    state, _, _ = timed_train(state)                  # warm-up (the capture, on the card)
    train_times, last_loss = [], None
    for _ in range(TIMED_RUNS):
        state, dt, last_loss = timed_train(state)
        train_times.append(dt)
    train_median = float(np.median(train_times))
    steps_per_s = args.steps / train_median

    # decode weights in the activation dtype, as a server reads them
    gen_params = {k: (v.to(dtype) if v.is_floating_point() else v)
                  for k, v in state.params.items()}
    generator = torch.Generator(device=device).manual_seed(3)

    def timed_generate() -> float:
        _sync(device)
        t0 = time.perf_counter()
        ids = lm_mod.generate(model, gen_params, generator, batch=args.gen_batch,
                              temperature=1.0)
        ids.sum().item()                              # the sync
        return time.perf_counter() - t0

    timed_generate()                                  # warm-up
    gen_times = [timed_generate() for _ in range(TIMED_RUNS)]
    gen_median = float(np.median(gen_times))
    decode_tokens_per_s = args.gen_batch * args.seq / gen_median

    # the reference bench's model FLOPs: GQA narrows the KV projection, a window caps the
    # attended keys, training is 3x the forward
    e = args.d_model
    kvh = args.kv_heads or args.heads
    proj_flops = (20 + 4 * kvh / args.heads) * e * e
    s_att = min(args.window, args.seq) if args.window else args.seq
    fwd_per_token = (args.layers * (proj_flops + 4 * s_att * e)
                     + 2 * e * (args.vocab + 1))
    train_flops_per_step = int(3 * fwd_per_token * args.seq * args.batch)
    achieved = steps_per_s * train_flops_per_step
    on_card = device.type == "cuda"

    # decode bytes a token: each step re-reads every layer's cached K+V prefix (the
    # segmented loop reads ceil((t+1)/SEG)·SEG rows at step t) and the decode weights,
    # amortized over the batch
    hd = e // args.heads
    seg = lm_mod.DECODE_SEGMENT
    avg_prefix = sum(min((t // seg + 1) * seg, args.seq) for t in range(args.seq)) / args.seq
    cache_row_bytes = 2 * args.layers * avg_prefix * kvh * hd * dtype.itemsize
    param_bytes = sum(v.numel() * v.element_size() for v in gen_params.values())
    decode_bytes_per_token = cache_row_bytes + param_bytes / args.gen_batch
    achieved_hbm = decode_tokens_per_s * decode_bytes_per_token
    return {
        "metric": (f"pixel-LM train steps/s + decode tokens/s (L={args.layers}, "
                   f"d_model={args.d_model}, seq={args.seq}, batch={args.batch}, "
                   f"heads={args.heads}"
                   f"{f', kv_heads={args.kv_heads}' if args.kv_heads else ''}"
                   f"{', rope' if args.rope else ''}"
                   f"{f', window={args.window}' if args.window else ''}, "
                   f"{'bf16' if args.bf16 else 'f32'})"),
        "value": round(steps_per_s, 2),
        "unit": "steps/s",
        "vs_baseline": None,        # the reference has no LM
        "platform": "gpu" if on_card else "cpu",
        "device_kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "train_program": segment_program(device),
        "train_seconds_per_run_all": [round(t, 4) for t in train_times],
        "train_tokens_per_s": round(steps_per_s * args.batch * args.seq),
        "decode_seconds_all": [round(t, 4) for t in gen_times],
        "decode_chain_lengths": [1] * TIMED_RUNS,
        "decode_chain_converged": True,
        "decode_tokens_per_s": round(decode_tokens_per_s, 1),
        "decode_batch": args.gen_batch,
        "decode_bytes_per_token": round(decode_bytes_per_token),
        "decode_achieved_hbm_bytes_per_s": round(achieved_hbm),
        "decode_hbm_roofline_frac": (round(achieved_hbm / HBM_PEAK_BYTES_PER_S, 4)
                                     if on_card else None),
        "model_train_flops_per_step": train_flops_per_step,
        "achieved_model_flops_per_s": round(achieved),
        "mfu_vs_bf16_peak": round(achieved / BF16_PEAK_FLOPS, 6) if on_card else None,
        "final_train_loss": round(last_loss, 4),
    }


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0], allow_abbrev=False)
    p.add_argument("--vocab", type=int, default=16, help="gray levels (BOS is +1)")
    p.add_argument("--seq", type=int, default=784)
    p.add_argument("--batch", type=int, default=64, help="training batch")
    p.add_argument("--gen-batch", type=int, default=8, help="decode batch")
    p.add_argument("--d-model", type=int, default=256)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--kv-heads", type=int, default=0, help="GQA K/V heads (0 = MHA)")
    p.add_argument("--rope", action=argparse.BooleanOptionalAction, default=False)
    p.add_argument("--window", type=int, default=0,
                   help="sliding-window attention width (0 = full)")
    p.add_argument("--steps", type=int, default=20, help="training steps per run")
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default: exits non-zero when no card is present) or "
                        "'cpu', which must be asked for")
    print(json.dumps(measure(p.parse_args(argv))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
