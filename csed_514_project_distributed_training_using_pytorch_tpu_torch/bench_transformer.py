"""Transformer training-throughput bench: steps/s and MFU of the transformer classifier, on
the port.

Counterpart of the repository's ``bench_transformer.py``, with its flags, defaults
(d_model 256, seq 256, batch 64, 4 layers, 8 heads, 50 steps, bf16; ``--large``: d_model
1024, seq 2048, batch 16, 8 layers, 10 steps) and JSON keys. ``--flash`` routes attention
through ``ops.flash_attention.dispatch_attention``: the CUDA flash kernels (B4/B5) where
``dispatch_uses_flash`` takes them (S >= 2048), the dense core below; ``flash_layout``
names the route that ran (``mma-bf16`` for bf16 operands, ``tf32x3`` for f32), None for
dense.

Protocol: ``--steps`` SGD steps (``train.step.make_train_step``, lr 0.01, momentum 0.5) on
one constant synthetic token batch (``[batch, seq, 16]`` features, labels ``arange % 10``)
as one segment: on the card a CUDA graph captured once and replayed when attention is
dense, the eager loop when it runs the flash kernels (a flash launch is not captured) and
on the CPU (``segment_program`` names which). One untimed warm-up run, then three timed
runs, each ended by a host fetch of a scalar that depends on the last step's loss and on
its parameter update; the median is the value. The model FLOPs are the reference bench's
formula; ``mfu_vs_bf16_peak`` is against ``utils.benchmarks.peak_flops`` (the H100's 989
TFLOP/s, bf16 dense) on the card only. The bench runs on the card and exits non-zero
without one, unless ``--device cpu`` asks for the CPU. It prints exactly one JSON line::

    python -m csed_514_project_distributed_training_using_pytorch_tpu_torch.bench_transformer \\
        --large --flash
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from csed_514_project_distributed_training_using_pytorch_tpu_torch.models.transformer import (
    TransformerClassifier,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import attention
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops.flash_attention import (
    dispatch_attention,
    dispatch_uses_flash,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.single import (
    resolve_device,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train.step import (
    create_train_state,
    make_epoch_from_step,
    make_segment_fn,
    make_train_step,
    segment_program,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.benchmarks import (
    peak_flops,
)

FEATURES = 16         # the synthetic tokens' feature width (the embed's input)
TIMED_RUNS = 3
SMALL = dict(d_model=256, seq=256, batch=64, layers=4, steps=50)
LARGE = dict(d_model=1024, seq=2048, batch=16, layers=8, steps=10)


def flops_by_component(e: int, s: int, b: int, layers: int) -> dict[str, int]:
    """The reference bench's training FLOPs a step (3x the forward), by component: the
    q/k/v/out projections 8e², the MLP 16e², the attention einsums 4se and the embed 2fe
    a token."""
    per_token = {"attn_projections": layers * 8 * e * e, "mlp": layers * 16 * e * e,
                 "attention_einsums": layers * 4 * s * e, "embed": 2 * FEATURES * e}
    return {k: 3 * v * s * b for k, v in per_token.items()}


def measure(args) -> dict:
    device = resolve_device(args.device)
    e, s, b, layers = args.d_model, args.seq, args.batch, args.layers
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    attention_fn, attn_impl, flash_layout = attention.full_attention, "dense", None
    if args.flash:
        attention_fn = dispatch_attention
        # what the dispatcher runs at this shape: a row labelled flash must have timed it
        attn_impl = "flash" if dispatch_uses_flash(s) else "dense"
        if attn_impl == "flash":
            flash_layout = "mma-bf16" if args.bf16 else "tf32x3"
    model = TransformerClassifier(seq_len=s, embed_dim=e, num_layers=layers,
                                  num_heads=args.heads, dropout_rate=0.0, dtype=dtype,
                                  attention_fn=attention_fn,
                                  token_features=FEATURES).to(device)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.normal(size=(b, s, FEATURES)).astype(np.float32))
    tokens = tokens.to(device)
    labels = torch.from_numpy((np.arange(b) % 10).astype(np.int64)).to(device)
    plan = torch.arange(b, device=device).repeat(args.steps, 1)
    state = create_train_state(model, torch.Generator().manual_seed(1), device=device)
    step = make_train_step(model, learning_rate=0.01, momentum=0.5)
    if attn_impl == "flash":
        run, program = make_segment_fn(step), "eager"      # a flash launch is not captured
    else:
        run, program = make_epoch_from_step(step), segment_program(device)
    probe = next(iter(state.params))

    def timed(state):
        t0 = time.perf_counter()
        state, losses = run(state, tokens, labels, plan, 2)
        # the sync: the last step's loss and its update
        last = (losses[-1].float() + 0.0 * state.params[probe].reshape(-1)[0]).item()
        return state, time.perf_counter() - t0, last

    state, _, _ = timed(state)                     # warm-up (the capture, on the card)
    times, last_loss = [], None
    for _ in range(TIMED_RUNS):
        state, dt, last_loss = timed(state)
        times.append(dt)
    median = float(np.median(times))
    by_component = flops_by_component(e, s, b, layers)
    train_flops = sum(by_component.values())
    steps_per_s = args.steps / median
    achieved = steps_per_s * train_flops
    on_card = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    peak = peak_flops(kind) if on_card else None
    return {
        "metric": (f"transformer train steps/s (L={layers}, d_model={e}, seq={s}, "
                   f"batch={b}, heads={args.heads}, {'bf16' if args.bf16 else 'f32'}"
                   f"{f', attn-dispatch({attn_impl})' if args.flash else ''})"),
        "value": round(steps_per_s, 2),
        "unit": "steps/s",
        "vs_baseline": None,      # the reference has no transformer
        "platform": "gpu" if on_card else "cpu",
        "device_kind": kind,
        "seconds_per_run_all": [round(t, 4) for t in times],
        "steps_per_run": args.steps,
        "tokens_per_s": round(steps_per_s * b * s),
        "examples_per_s": round(steps_per_s * b, 1),
        "model_train_flops_per_step": train_flops,
        "train_flops_per_step_by_component": by_component,
        "achieved_model_flops_per_s": round(achieved),
        "mfu_vs_bf16_peak": round(achieved / peak, 6) if peak else None,
        "flash_layout": flash_layout,
        "final_train_loss": round(last_loss, 4),
        "segment_program": program,
    }


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0], allow_abbrev=False)
    for name in ("d_model", "seq", "batch", "layers", "steps"):
        p.add_argument("--" + name.replace("_", "-"), type=int, default=None)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--large", action="store_true",
                   help="d_model 1024, seq 2048, batch 16, 8 layers, 10 steps; explicit "
                        "flags still override")
    p.add_argument("--bf16", action=argparse.BooleanOptionalAction, default=True,
                   help="bfloat16 activations (f32 master weights)")
    p.add_argument("--flash", action=argparse.BooleanOptionalAction, default=False,
                   help="attention through dispatch_attention: the flash kernels at "
                        "S >= 2048, the dense core below")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the default: exits non-zero when no card is present) or "
                        "'cpu', which must be asked for")
    args = p.parse_args(argv)
    for name, value in (LARGE if args.large else SMALL).items():
        if getattr(args, name) is None:
            setattr(args, name, value)
    print(json.dumps(measure(args)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
