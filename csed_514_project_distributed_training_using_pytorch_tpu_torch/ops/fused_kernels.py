"""Fused loss and optimizer kernels of the training step: CUDA on the card, plain on the CPU.

Counterpart of the JAX package's ``ops/pallas_kernels.py``. Each kernel there has a
hand-written CUDA kernel here (``csrc/fused_kernels.cu``, built by ``ops/_build.py``) and,
beside it, a plain PyTorch version of the same function:

- ``nll_fwd``: per-row ``-log_softmax(logits)[label]`` in one pass (TPU ``_nll_fwd_kernel``);
- ``nll_bwd``: ``(softmax - onehot) * ct_row`` in one pass (TPU ``_nll_bwd_kernel``);
- ``sgd_momentum_step``: ``v <- mu*v + g; p <- p - lr*v``, in place, over every leaf of a
  parameter dict, on the card in one launch per ``SGD_TABLE_LEAVES`` leaves (TPU
  ``_sgd_kernel``); ``sgd_momentum_leaf`` does the same for one leaf.

``nll_from_logits`` joins the first two as one ``torch.autograd.Function``.

Dispatch is by the device of the tensors alone: a CPU tensor takes the plain version (the
CPU tests), a CUDA tensor launches the kernel or raises. Nothing falls back. Each launch
adds one to its counter (``nll_fwd_launches``, ``nll_bwd_launches``,
``sgd_momentum_launches``), so a run can show that it went through the kernels. A launch
recorded into a CUDA graph is counted at each replay instead (``train.step.CapturedSegment``
adds the captured counts through ``add_launch_counts``).
"""

from __future__ import annotations

import array

import torch

from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import _build

SGD_TABLE_LEAVES = 64   # leaves per multi-tensor launch (kSgdTableLeaves in the source)

nll_fwd_launches = 0
nll_bwd_launches = 0
sgd_momentum_launches = 0
# The floating-point operations the launches above did, by formula (a flop counter over
# torch's operators cannot see a kernel launched through the C entry): 4 a logit for the
# NLL forward (max, subtract, exp, sum) and backward (exp, divide, subtract, scale), 4 an
# element for the SGD update (v = mu*v + g, p = p - lr*v). ``utils.telemetry`` reads it.
launched_flops = 0.0


def reset_launch_counts() -> None:
    global nll_fwd_launches, nll_bwd_launches, sgd_momentum_launches
    nll_fwd_launches = nll_bwd_launches = sgd_momentum_launches = 0


def launch_counts() -> dict[str, int]:
    return {"nll_fwd": nll_fwd_launches, "nll_bwd": nll_bwd_launches,
            "sgd_momentum": sgd_momentum_launches}


def add_launch_counts(delta: dict[str, int]) -> None:
    """Add ``delta`` (keyed as ``launch_counts``) to the counters: a graph replay's
    launches, or, negative, a capture's, which launched nothing."""
    global nll_fwd_launches, nll_bwd_launches, sgd_momentum_launches
    nll_fwd_launches += delta["nll_fwd"]
    nll_bwd_launches += delta["nll_bwd"]
    sgd_momentum_launches += delta["sgd_momentum"]


def _add_flops(n: int) -> None:
    global launched_flops
    launched_flops += n


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU: the plain versions' only case."""
    return all(t.is_cpu for t in tensors)


def _check_cuda(name: str, device: torch.device, **tensors) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on ``device`` of the dtype the
    kernel takes (``arg=(tensor, dtype)``)."""
    for arg, (t, dtype) in tensors.items():
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, expected {device} "
                             f"(the kernel runs on one CUDA device)")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} has dtype {t.dtype}, the kernel takes {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _check_rows(name: str, logits: torch.Tensor, labels: torch.Tensor) -> tuple[int, int]:
    if logits.dim() != 2 or labels.shape != (logits.shape[0],):
        raise ValueError(f"{name}: expected logits [B, C] and labels [B], got "
                         f"{tuple(logits.shape)} and {tuple(labels.shape)}")
    return logits.shape[0], logits.shape[1]


# =========================================================================================
# Fused log-softmax + NLL loss
# =========================================================================================


def nll_fwd_plain(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Plain version of ``nll_fwd``: the TPU kernel's arithmetic, with its one-hot mask (a
    label outside ``[0, C)`` gives 0, as the kernel's does)."""
    x = logits.float()
    m = x.max(dim=1, keepdim=True).values
    s = x - m
    lse = torch.log(torch.exp(s).sum(dim=1, keepdim=True))
    classes = torch.arange(x.shape[1], device=x.device)[None, :]
    picked = torch.where(classes == labels[:, None], s - lse, 0.0).sum(dim=1)
    return -picked


def nll_fwd(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row ``-log_softmax(logits)[row, label]``: logits f32 ``[B, C]``, labels int64
    ``[B]`` -> f32 ``[B]``."""
    global nll_fwd_launches
    rows, cols = _check_rows("nll_fwd", logits, labels)
    if _on_cpu(logits, labels):
        return nll_fwd_plain(logits, labels)
    dev = logits.device
    _check_cuda("nll_fwd", dev, logits=(logits, torch.float32), labels=(labels, torch.int64))
    out = torch.empty(rows, dtype=torch.float32, device=dev)
    _build.launch("fused_kernels", "nll_fwd", dev, "nll_fwd_f32", logits.data_ptr(),
                  labels.data_ptr(), out.data_ptr(), rows, cols)
    nll_fwd_launches += 1
    _add_flops(4 * rows * cols)
    return out


def nll_bwd_plain(logits: torch.Tensor, labels: torch.Tensor, ct: torch.Tensor,
                  scale: float = 1.0) -> torch.Tensor:
    """Plain version of ``nll_bwd``."""
    x = logits.float()
    ct_rows = (torch.tensor(scale, dtype=torch.float32, device=x.device)
               * ct.float()).expand(x.shape[0])
    m = x.max(dim=1, keepdim=True).values
    e = torch.exp(x - m)
    softmax = e / e.sum(dim=1, keepdim=True)
    classes = torch.arange(x.shape[1], device=x.device)[None, :]
    onehot = torch.where(classes == labels[:, None], 1.0, 0.0)
    return (softmax - onehot) * ct_rows[:, None]


def nll_bwd(logits: torch.Tensor, labels: torch.Tensor, ct: torch.Tensor,
            scale: float = 1.0) -> torch.Tensor:
    """``d nll / d logits = (softmax(logits) - onehot(labels)) * (scale * ct_row)``.

    ``ct`` holds one cotangent per row (``[B]``) or one for all rows (a 0-d tensor): the
    kernel broadcasts it with stride 0, so reductions mean and sum cost no extra launch.
    Returns f32 ``[B, C]``."""
    global nll_bwd_launches
    rows, cols = _check_rows("nll_bwd", logits, labels)
    if ct.dim() == 0:
        ct_stride = 0
    elif ct.shape == (rows,):
        ct_stride = 1
    else:
        raise ValueError(f"nll_bwd: ct must be a scalar or [{rows}], got {tuple(ct.shape)}")
    if _on_cpu(logits, labels, ct):
        return nll_bwd_plain(logits, labels, ct, scale)
    dev = logits.device
    _check_cuda("nll_bwd", dev, logits=(logits, torch.float32), labels=(labels, torch.int64),
                ct=(ct, torch.float32))
    out = torch.empty((rows, cols), dtype=torch.float32, device=dev)
    _build.launch("fused_kernels", "nll_bwd", dev, "nll_bwd_f32", logits.data_ptr(),
                  labels.data_ptr(), ct.data_ptr(), ct_stride, scale, out.data_ptr(), rows,
                  cols)
    nll_bwd_launches += 1
    _add_flops(4 * rows * cols)
    return out


def _nll_reduce(per_example: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return per_example.mean()
    if reduction == "sum":
        return per_example.sum()
    if reduction == "none":
        return per_example
    raise ValueError(f"unknown reduction {reduction!r}")


class _NLLFromLogits(torch.autograd.Function):
    """Forward through ``nll_fwd``, backward through ``nll_bwd``."""

    @staticmethod
    def forward(ctx, logits, labels, reduction):
        x = logits.float().contiguous()
        ctx.save_for_backward(x, labels)
        ctx.reduction = reduction
        ctx.in_dtype = logits.dtype
        return _nll_reduce(nll_fwd(x, labels), reduction)

    @staticmethod
    def backward(ctx, ct):
        x, labels = ctx.saved_tensors
        # ct_row as the TPU kernel's _nll_bwd builds it: ct/B, ct, or per-example.
        scale = 1.0 / x.shape[0] if ctx.reduction == "mean" else 1.0
        dlogits = nll_bwd(x, labels, ct.float().contiguous(), scale)
        return dlogits.to(ctx.in_dtype), None, None


def nll_from_logits(logits: torch.Tensor, labels: torch.Tensor,
                    reduction: str = "mean") -> torch.Tensor:
    """Fused ``nll_loss(log_softmax(logits), labels)``, differentiable in ``logits``."""
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"unknown reduction {reduction!r}")
    return _NLLFromLogits.apply(logits, labels, reduction)


# =========================================================================================
# Fused SGD-momentum update
# =========================================================================================


@torch.no_grad()
def sgd_momentum_leaf_plain(p: torch.Tensor, v: torch.Tensor, g: torch.Tensor, *,
                            learning_rate: float, momentum: float) -> None:
    """Plain version of ``sgd_momentum_leaf``, in place, with the kernel's two roundings
    per line."""
    v.mul_(momentum).add_(g)
    p.sub_(v * learning_rate)


def _check_shapes(name: str, p: torch.Tensor, v: torch.Tensor, g: torch.Tensor) -> None:
    if not (p.shape == v.shape == g.shape):
        raise ValueError(f"{name}: shapes differ: p {tuple(p.shape)}, "
                         f"v {tuple(v.shape)}, g {tuple(g.shape)}")


def _on_card(t: torch.Tensor, index: int) -> bool:
    """True for a contiguous f32 tensor on CUDA device ``index``: what the SGD kernel takes."""
    return t.is_cuda and t.get_device() == index and t.dtype == torch.float32 and (
        t.is_contiguous())


def _sgd_launch(device: torch.device, ps: list[torch.Tensor], vs: list[torch.Tensor],
                gs: list[torch.Tensor], learning_rate: float, momentum: float) -> None:
    """One launch of the multi-tensor kernel per ``SGD_TABLE_LEAVES`` checked CUDA leaves
    (the kernel gives an empty leaf no block; a table of empty leaves is not launched)."""
    global sgd_momentum_launches
    for start in range(0, len(ps), SGD_TABLE_LEAVES):
        chunk = slice(start, start + SGD_TABLE_LEAVES)
        numels = [t.numel() for t in ps[chunk]]
        if not any(numels):
            continue
        # the C entry's host arrays: data pointers and sizes, 8 bytes each (array.array
        # builds them several times faster than ctypes arrays; they live through the call)
        tables = [array.array("Q", [t.data_ptr() for t in xs[chunk]]) for xs in (ps, vs, gs)]
        tables.append(array.array("q", numels))
        _build.launch("fused_kernels", "sgd_momentum", device, "sgd_momentum_multi_f32",
                      *[t.buffer_info()[0] for t in tables], len(numels), learning_rate,
                      momentum)
        sgd_momentum_launches += 1
        _add_flops(4 * sum(numels))


@torch.no_grad()
def sgd_momentum_leaf(p: torch.Tensor, v: torch.Tensor, g: torch.Tensor, *,
                      learning_rate: float, momentum: float) -> None:
    """``v <- momentum*v + g; p <- p - learning_rate*v`` on one f32 leaf, IN PLACE: on the
    card one launch of the multi-tensor kernel with a table of one."""
    _check_shapes("sgd_momentum_leaf", p, v, g)
    if _on_cpu(p, v, g):
        sgd_momentum_leaf_plain(p, v, g, learning_rate=learning_rate, momentum=momentum)
        return
    dev = p.device
    _check_cuda("sgd_momentum", dev, p=(p, torch.float32), v=(v, torch.float32),
                g=(g, torch.float32))
    _sgd_launch(dev, [p], [v], [g], learning_rate, momentum)


@torch.no_grad()
def sgd_momentum_step(params: dict[str, torch.Tensor], velocity: dict[str, torch.Tensor],
                      grads: dict[str, torch.Tensor], *, learning_rate: float,
                      momentum: float):
    """Fused SGD-momentum step over every leaf — the counterpart of
    ``ops.optim.sgd_update``. Updates ``params`` and ``velocity`` in place and returns them
    as ``(params, velocity)``. On the card it makes one launch of the multi-tensor kernel
    per ``SGD_TABLE_LEAVES`` leaves (one for the CNN's 8); on the CPU it takes the plain
    version leaf by leaf. A gradient that autograd left in another memory layout (cuDNN
    returns some conv weight gradients channels-last) is made contiguous first; the kernel
    reads memory in order."""
    ps = list(params.values())
    vs = [velocity[k] for k in params]
    gs = [grads[k].contiguous() for k in params]
    if not ps:
        return params, velocity
    index = ps[0].get_device()
    # One quick pass, since this runs every step (a host-bound step's update costs as much
    # host time as its checks); the full checks run only to raise or to take the CPU path.
    if not all([p.shape == v.shape == g.shape and _on_card(p, index) and _on_card(v, index)
                and _on_card(g, index) for p, v, g in zip(ps, vs, gs)]):
        for leaf in zip(ps, vs, gs):
            _check_shapes("sgd_momentum_step", *leaf)
        if _on_cpu(*ps, *vs, *gs):
            for leaf in zip(ps, vs, gs):
                sgd_momentum_leaf_plain(*leaf, learning_rate=learning_rate,
                                        momentum=momentum)
            return params, velocity
        f32 = torch.float32
        for p, v, g in zip(ps, vs, gs):
            _check_cuda("sgd_momentum_step", ps[0].device, p=(p, f32), v=(v, f32),
                        g=(g, f32))
    _sgd_launch(ps[0].device, ps, vs, gs, learning_rate, momentum)
    return params, velocity
