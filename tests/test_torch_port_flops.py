"""PyTorch port, one training step's flops without a dispatch mode
(``utils/telemetry.py::StepFlopCounter``, ``train_step_flops``), held against
``torch.utils.flop_counter.FlopCounterMode``, here and nowhere else in the repo:

- on each trainer's step at tiny widths on the CPU (the CNN with the fused kernels' plain
  versions; the transformer classifier without and with remat, and under the
  ``save-dots`` policy; the MoE block, top-1 and top-2; the pixel LM, without and with
  remat) the count equals ``FlopCounterMode``'s total exactly, as an integer;
- a custom autograd function's backward in plain torch (the flash plain versions on the
  CPU) is counted inside the backward, as ``FlopCounterMode`` counts it;
- ``train_step_flops`` on a CNN step and on an LM step, in a fresh interpreter, imports
  no module (not ``torch._dynamo``, ``torch.utils.flop_counter`` or ``sympy``): the
  start-up seconds a trainer's ``--telemetry`` used to pay.
"""

import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import cnn
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models.transformer import (
    TransformerClassifier,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import (
    flash_attention,
    optim,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import lm as lm_train
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import step as S
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import telemetry as T
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.config import LMConfig


def _images(batch: int, seed: int):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((batch, 28, 28, 1)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 10, batch).astype(np.int64)))


def _cnn_step():
    model = cnn.Net()
    state = S.create_train_state(model, torch.Generator().manual_seed(0))
    step = S.make_train_step(model, learning_rate=0.01, momentum=0.5, use_pallas=True)
    return step, state, (*_images(16, 1), 0)


def _classifier_step(**knobs):
    model = TransformerClassifier(seq_len=16, embed_dim=32, num_layers=2, num_heads=2,
                                  dropout_rate=0.1, **knobs)
    opt = optim.make_optimizer("adamw", learning_rate=1e-3, momentum=0.9, weight_decay=0.01)
    state = S.create_train_state(model, torch.Generator().manual_seed(0), optimizer=opt)
    step = S.make_train_step(model, learning_rate=1e-3, momentum=0.9, optimizer=opt,
                             clip_grad_norm=1.0)
    return step, state, (*_images(8, 2), 0)


def _lm_step(**knobs):
    cfg = LMConfig(embed_dim=32, num_layers=2, num_heads=2, batch_size=2, **knobs)
    model = lm_train.lm_model(cfg, vocab=cfg.num_levels + 1, seq_len=784)
    opt = lm_train.lm_optimizer(cfg)
    state = S.create_train_state(model, torch.Generator().manual_seed(0), optimizer=opt)
    step = lm_train.make_lm_step(model, cfg, optimizer=opt, steps_per_epoch=10)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, 16, (2, 784)))
    return step, state, (tokens, torch.zeros(2, dtype=torch.int64), 1)


STEPS = {
    "cnn": _cnn_step,
    "transformer": _classifier_step,
    "transformer-remat": lambda: _classifier_step(remat=True),
    "transformer-save-dots": lambda: _classifier_step(remat=True, remat_policy="save-dots"),
    "moe-top1": lambda: _classifier_step(num_experts=4),
    "moe-top2": lambda: _classifier_step(num_experts=4, expert_top_k=2),
    "lm": _lm_step,
    "lm-remat": lambda: _lm_step(remat=True),
}


@pytest.mark.parametrize("name", list(STEPS))
def test_the_step_count_equals_flop_counter_mode(name):
    from torch.utils.flop_counter import FlopCounterMode

    step, state, batch = STEPS[name]()
    with FlopCounterMode(display=False) as counter:
        step(T._clone(state), *batch)
    want = counter.get_total_flops()
    got = T.train_step_flops(step, state, *batch)
    assert want > 0 and got == float(want) and int(got) == want


def test_a_custom_functions_plain_backward_is_counted():
    from torch.utils.flop_counter import FlopCounterMode

    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 256, 2, 16)).astype(np.float32))
               .requires_grad_() for _ in range(3))

    def fwd_bwd():
        out = flash_attention.flash_attention(q, k, v, causal=True)
        torch.autograd.grad(out.sum(), [q, k, v])

    with FlopCounterMode(display=False) as counter:
        fwd_bwd()
    _, got = T.step_flops(fwd_bwd)
    assert got == counter.get_total_flops() > 0


def test_counting_a_step_imports_nothing():
    """In a fresh interpreter, after one plain step of the CNN and of the LM (their own
    first-use imports), counting each step's flops imports no module (``FlopCounterMode``
    pulled in ``torch._dynamo``, ``torch.broadcast_shapes`` ``sympy``: seconds of a
    trainer's ``--telemetry``), and neither ``torch._dynamo`` nor
    ``torch.utils.flop_counter`` is loaded at all (this module imports
    ``FlopCounterMode`` only inside its cases)."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {str(pathlib.Path(__file__).parent)!r})
        import test_torch_port_flops as case
        from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import (
            telemetry as T,
        )
        for name in ("cnn", "lm"):
            step, state, batch = case.STEPS[name]()
            step(T._clone(state), *batch)       # the step's own first-use imports
            before = set(sys.modules)
            assert T.train_step_flops(step, state, *batch) > 0
            print(name, "new", sorted(set(sys.modules) - before), "heavy",
                  [m for m in ("torch._dynamo", "torch.utils.flop_counter")
                   if m in sys.modules])
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.splitlines() == ["cnn new [] heavy []", "lm new [] heavy []"], \
        out.stdout
