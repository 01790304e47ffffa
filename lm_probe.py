#!/usr/bin/env python3
"""Two measurements behind the pixel-LM trainer's design, on one NVIDIA GPU.

    python3 lm_probe.py

1. Run-to-run determinism of the token embedding's gradient at the trainer's shapes (ids
   ``[64, 784]`` over 17 rows of 64): the table's gradient taken twice from the same
   inputs, for an indexing gather (``W[ids]``), ``F.embedding`` and the one-hot product
   ``one_hot(ids) @ W`` that ``models/lm.py`` uses, on the CPU and on the card. A
   difference between the two runs is what makes a resumed run part from an unbroken one.
2. What a captured segment's length costs: ``train.lm``'s step
   (``train.lm.make_lm_step`` at ``LMConfig``'s defaults: AdamW 1e-3, clip 1.0, the
   all-reduce at world 1) over one 937-step epoch of the synthetic split, as one graph of
   the whole epoch and as ``train.lm.SEGMENT_STEPS``-step graphs; each epoch twice, so the
   first holds the captures and the second replays only.

Without a CUDA device it prints (1) on the CPU and exits non-zero; with one, the card's
name and power limit, then (1) on both and (2).
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def embedding_gradients(dev, tag: str) -> None:
    """(1): the embedding table's gradient twice, under three forms, on ``dev``."""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn(17, 64, generator=gen, device=dev) * 0.02
    ids = torch.randint(0, 17, (64, 784), generator=gen, device=dev)
    ct = torch.randn(64, 784, 64, generator=gen, device=dev)
    forms = {"indexing W[ids]": lambda w: w[ids],
             "F.embedding": lambda w: F.embedding(ids, w),
             "one_hot(ids) @ W": lambda w: F.one_hot(ids, 17).float() @ w}
    for name, form in forms.items():
        grads = []
        for _ in range(2):
            w = table.clone().requires_grad_()
            (g,) = torch.autograd.grad((form(w) * ct).sum(), w)
            grads.append(g)
        print(f"[lm_probe] (1) {name} on {dev.type}: the table's gradient twice, max |diff| "
              f"{(grads[0] - grads[1]).abs().max().item():.3e} [{tag}]")


def main() -> None:
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import (
        load_mnist,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import lm
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import (
        data_parallel as dp, mesh,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import (
        lm as lm_train, step as st,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.config import (
        LMConfig,
    )

    embedding_gradients(torch.device("cpu"), f"{torch.get_num_threads()} CPU threads")
    if not torch.cuda.is_available():
        sys.exit("lm_probe: no CUDA device; (1) on the card and (2) not run")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"[lm_probe] {torch.cuda.get_device_name(0)}; nvidia-smi: {card}; torch "
          f"{torch.__version__}")
    embedding_gradients(dev, card)

    # 2. one graph of the epoch against SEGMENT_STEPS-step graphs
    cfg = LMConfig()
    train_ds, _ = load_mnist(str(ROOT / "files"))
    tokens = lm.tokenize_images_to_ids(torch.from_numpy(train_ds.images)).to(dev)
    zeros = torch.zeros(len(train_ds), dtype=torch.int64, device=dev)
    steps = len(train_ds) // cfg.batch_size
    plan = torch.from_numpy(np.random.default_rng(np.random.SeedSequence(
        [cfg.seed, 0])).permutation(len(train_ds))[:steps * cfg.batch_size].reshape(
            steps, cfg.batch_size)).to(dev)
    model = lm_train.lm_model(cfg, vocab=cfg.num_levels, seq_len=tokens.shape[1]).to(dev)
    opt = lm_train.lm_optimizer(cfg)
    with mesh.cluster(dev):
        for label, seg_steps in (("one graph of the epoch", steps),
                                 (f"{lm_train.SEGMENT_STEPS}-step graphs",
                                  lm_train.SEGMENT_STEPS)):
            state = st.create_train_state(model, torch.Generator().manual_seed(cfg.seed),
                                          optimizer=opt, device=dev)
            reducer = dp.GradReducer(state.params)
            fn = lm_train.make_lm_step(model, cfg, optimizer=opt, steps_per_epoch=steps,
                                       grad_reduce=reducer)
            segment = st.CapturedSegment(fn, grad_reduce=reducer)
            seconds = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for start in range(0, steps, seg_steps):
                    state, losses = segment(state, tokens, zeros,
                                            plan[start:start + seg_steps], cfg.seed + 1)
                losses[-1].item()
                seconds.append(time.perf_counter() - t0)
            print(f"[lm_probe] (2) {label}: {len(segment.graphs)} graph(s); epoch with the "
                  f"captures {seconds[0]:.3f} s, replays only {seconds[1]:.3f} s "
                  f"({seconds[1] / steps * 1e3:.4f} ms a step); capture cost "
                  f"{seconds[0] - seconds[1]:.3f} s [{card}]")
            del segment, state
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
