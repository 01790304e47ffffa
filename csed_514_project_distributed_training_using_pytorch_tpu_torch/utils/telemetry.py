"""Structured run telemetry: a machine-readable record of what ran and where the time went.

Counterpart of the JAX package's ``utils/telemetry.py``, with the JAX package's event
kinds (``utils/telemetry_events.py``) and keys, so ``tools/telemetry_report.py`` renders
either package's stream:

- events: one JSON object per line (strict JSONL: non-finite floats become ``null``),
  each typed by an ``"event"`` key. The trainers write ``manifest`` (once: config, grid,
  device, versions), ``compile``, ``epoch``, ``health`` (``--health-stats``: the
  accumulators of ``train/step.py``'s ``HealthStats``, carried inside the segment, read
  once an epoch), ``anomaly``, ``checkpoint``, ``preempt`` and ``mfu``; the server
  (``serving/server.py``) writes ``serve``, ``serve_config``, ``serve_summary``,
  ``prefill``, ``spec``, ``shed``, ``tenant_summary``, ``kv_pages`` and ``slo``;
- the writer: ``TelemetryWriter`` is rank-0 gated (a fleet writes one file) and atomic
  (every emit rewrites the file through tmp + rename), or, ``stream=True``, appends one
  flushed line per emit (the server's O(requests) volume; a kill tears at most the last
  line, which ``utils.jsonl.read_jsonl`` skips).

Where the JAX package reads a number off XLA, the port says what it measured instead, and
leaves ``null`` where it has nothing honest:

- ``compile``: the port compiles nothing ahead of time. Its ``compile_s`` is the first
  segment call's seconds (on the card the warm-up and the CUDA-graph capture with the
  first replay; on the CPU the first eager segment); ``lower_s`` and the bytes keys are
  null (no lowering, no cost analysis);
- ``flops_per_step``: ``step_flops`` counts one step under ``StepFlopCounter``, a
  ``TorchFunctionMode`` that prices each matmul, einsum, linear and conv call as
  ``FlopCounterMode`` prices the aten products they run (2·m·k·n; bias and elementwise
  work free) and derives the backward's products by rule, and adds the flops of the
  hand-written kernels that it cannot see, by formula, for each launch the step made
  (``fused_kernels.launched_flops``, ``flash_attention.launched_flops``). A function mode
  imports nothing: ``FlopCounterMode``, a dispatch mode, pulls in ``torch._dynamo`` and
  ``sympy`` on first entry, seconds of every trainer's start-up;
- the manifest's ``jax_version``/``jaxlib_version`` are null; it names ``torch_version``
  and ``cuda_version`` beside them, and its ``mesh`` is the process grid's axes;
- ``estimate_mfu`` divides by the card's bf16 peak (``utils.benchmarks.peak_flops``), and
  is null off the card or on an unknown card.

Read side: ``utils.jsonl.read_jsonl``; renderer: ``tools/telemetry_report.py``.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import platform
import threading
import time

import numpy as np
import torch

from csed_514_project_distributed_training_using_pytorch_tpu_torch.obs.hist import (
    LogHistogram,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import metrics as M
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.jsonl import (
    percentiles,
    read_jsonl,
)

SCHEMA_VERSION = 1


def _finite(x):
    """Strict-JSONL rule: non-finite -> None."""
    if x is None:
        return None
    x = float(x)
    return x if math.isfinite(x) else None


def _sanitize(obj):
    """``obj`` with every non-finite float mapped to None: a diverged run (NaN loss, inf
    grad norm) still serializes as valid JSON."""
    if isinstance(obj, float):
        return _finite(obj)
    if isinstance(obj, dict):
        return {k: _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    return obj


class TelemetryWriter:
    """Append-only event stream as atomically (re)written JSONL; rank-0 gated.

    ``path`` empty/None disables everything: ``emit`` is then a no-op, so callers emit
    unconditionally. ``stream=True`` appends one flushed line per emit (file truncated at
    the first emit, reopened for append after ``close``). ``preserve=True`` (rewrite mode)
    loads an existing file's events first, so a resumed run's file keeps the earlier
    attempt's events (each attempt opens with its own ``manifest``); a fresh run on a stale
    path truncates."""

    def __init__(self, path: str | None, *, stream: bool = False, preserve: bool = False):
        self.path = path or ""
        self.stream = bool(stream)
        self.preserve = bool(preserve)
        self._fh = None
        self._truncated = False
        self._events: list[dict] = []
        self._loaded_history = False
        self._t0 = time.time()
        # the write-behind checkpointer reports from its worker thread
        self._emit_lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return bool(self.path) and M.is_logging_process()

    def emit(self, event: dict) -> None:
        """Record one typed event."""
        if not self.enabled:
            return
        if "event" not in event:
            raise ValueError(f"telemetry event missing its 'event' type key: {event}")
        row = dict(event)
        row.setdefault("t_s", round(time.time() - self._t0, 6))
        row = _sanitize(row)
        with self._emit_lock:
            if self.stream:
                if self._fh is None:
                    os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
                    self._fh = open(self.path, "a" if self._truncated else "w")
                    self._truncated = True
                self._fh.write(json.dumps(row, allow_nan=False) + "\n")
                self._fh.flush()
                return
            if not self._loaded_history:
                self._loaded_history = True
                if self.preserve and os.path.exists(self.path):
                    self._events = read_jsonl(self.path) + self._events
            self._events.append(row)
            payload = "".join(json.dumps(e, allow_nan=False) + "\n" for e in self._events)
            M._atomic_write(self.path, payload.encode())

    def close(self) -> None:
        """Release the stream-mode file handle (no-op otherwise)."""
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _device_kind() -> tuple[str, str, int]:
    """``(platform, device_kind, device_count)`` of this process's accelerator, or the
    CPU's when no card is present."""
    if torch.cuda.is_available():
        return "gpu", torch.cuda.get_device_name(0), torch.cuda.device_count()
    return "cpu", "cpu", 1


def manifest_event(config=None, *, axes: dict[str, int] | None = None, run_type: str = "",
                   device: torch.device | str | None = None) -> dict:
    """The once-per-run provenance record: config, topology, software versions, in the
    JAX package's keys. ``axes`` is the trainer's grid (``{axis: size}``, in the mesh
    spec's order), in place of a JAX mesh; ``device`` where the run computes (its type
    decides the ``platform``: the CPU is reported as such on a machine with a card)."""
    import torch.distributed as dist

    platform_name, kind, count = _device_kind()
    if device is not None and torch.device(device).type == "cpu":
        platform_name, kind, count = "cpu", "cpu", 1
    up = dist.is_available() and dist.is_initialized()
    ev = {
        "event": "manifest",
        "schema_version": SCHEMA_VERSION,
        "run_type": run_type or (type(config).__name__ if config is not None else ""),
        "unix_time": time.time(),
        "platform": platform_name,
        "device_kind": kind,
        "device_count": count,
        "local_device_count": count,
        "process_count": dist.get_world_size() if up else 1,
        "process_index": dist.get_rank() if up else 0,
        "jax_version": None,
        "jaxlib_version": None,
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "python_version": platform.python_version(),
    }
    if axes is not None:
        ev["mesh"] = {"axis_names": list(axes),
                      "shape": {str(k): int(v) for k, v in axes.items()}}
    if config is not None and dataclasses.is_dataclass(config):
        cfg = dataclasses.asdict(config)
        ev["config"] = cfg
        ev["precision"] = {"bf16": bool(cfg.get("bf16", False)), "jax_enable_x64": None,
                           "tf32": bool(torch.backends.cuda.matmul.allow_tf32)}
    return ev


def hand_kernel_flops() -> float:
    """The flops the hand-written kernels have launched so far, by formula (each wrapper
    adds its call's count where it launches; the CPU's plain versions add nothing)."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import (
        flash_attention,
        fused_kernels,
    )
    return float(fused_kernels.launched_flops + flash_attention.launched_flops)


def _prod(xs) -> int:
    return math.prod(int(x) for x in xs)


def _matmul_flops(a: torch.Tensor, b: torch.Tensor) -> int:
    """``torch.matmul(a, b)``'s flops as its aten ``mm``/``bmm`` count them; a
    vector operand makes an ``mv``/``dot``, which the aten count leaves out. The batch
    dims broadcast by hand: ``torch.broadcast_shapes`` imports ``sympy``."""
    if a.dim() < 2 or b.dim() < 2:
        return 0
    batch = itertools.zip_longest(reversed(a.shape[:-2]), reversed(b.shape[:-2]),
                                  fillvalue=1)
    return 2 * _prod(max(x, y) for x, y in batch) * a.shape[-2] * a.shape[-1] * b.shape[-1]


def _einsum_flops(equation: str, operands) -> int:
    """A two-operand einsum's flops as its one ``bmm`` counts them: 2 × the sizes of
    the letters both operands share or the output keeps (a letter that only one operand
    has and the output drops is summed before the product, for free)."""
    equation = equation.replace(" ", "")
    inputs, _, out = equation.partition("->")
    specs = inputs.split(",")
    if len(specs) != 2 or "." in equation or "->" not in equation:
        raise NotImplementedError(f"StepFlopCounter: einsum {equation!r} is not priced "
                                  f"(two operands, an explicit output, no ellipsis)")
    size = {}
    for spec, t in zip(specs, operands):
        for letter, n in zip(spec, t.shape):
            size[letter] = max(size.get(letter, 1), int(n))
    left, right = set(specs[0]), set(specs[1])
    return 2 * _prod(size[c] for c in (left & right) | ((left | right) & set(out)))


_MATMULS = (torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__, torch.mm,
            torch.Tensor.mm, torch.bmm, torch.Tensor.bmm)
_BACKWARDS = (torch.autograd.grad, torch.autograd.backward, torch.Tensor.backward)


class StepFlopCounter(torch.overrides.TorchFunctionMode):
    """Counts the flops of the torch calls made under it, as ``FlopCounterMode`` counts
    the aten products they lower to, with no dispatch mode.

    A function mode sees the Python-level calls, not the aten ops of autograd's
    derivative formulas, so the backward's products are derived: a product called with
    grad enabled costs its forward flops once more for each operand that requires grad
    (its backward computes one product of the same size for each; a step differentiates
    every parameter it reads, so every such operand's gradient is computed). The mode
    stays on inside the backward (``_engine_run_backward`` entered under it, and the
    engine carries the mode to its worker threads), where the calls it sees are real
    forward products counted once: the recomputation of a rematerialized block, a custom
    autograd function's backward in plain torch. A product recomputed under a dispatch
    mode is served from the selective-remat cache (``save-dots``, the only dispatch mode
    the port enters) and is not counted; a conv is not a dot and is."""

    def __init__(self):
        super().__init__()
        self.total = 0
        self._in_backward = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _BACKWARDS:
            return self._backward(func, args, kwargs)
        out = func(*args, **kwargs)
        operands, flops = (), 0
        if func in _MATMULS or func in (torch.addmm, torch.baddbmm):
            operands = args[1:3] if func in (torch.addmm, torch.baddbmm) else args[:2]
            flops = _matmul_flops(*operands)
        elif func is torch.Tensor.__rmatmul__:
            operands = args[:2]
            flops = _matmul_flops(args[1], args[0])
        elif func is torch.nn.functional.linear:
            x, w = args[0], args[1] if len(args) > 1 else kwargs["weight"]
            operands = (x, w)
            flops = 2 * _prod(x.shape) * w.shape[0] if x.dim() >= 2 else 0
        elif func is torch.einsum:
            operands = args[1:]
            if len(operands) == 1 and isinstance(operands[0], (list, tuple)):
                operands = tuple(operands[0])
            flops = _einsum_flops(args[0], operands)
        elif func in (torch.nn.functional.conv2d, torch.conv2d):
            operands = args[:2]
            flops = 2 * out.shape[0] * _prod(out.shape[2:]) * _prod(args[1].shape)
        if not flops:
            return out
        if self._in_backward:
            is_dot = func not in (torch.nn.functional.conv2d, torch.conv2d)
            if not (is_dot and torch._C._len_torch_dispatch_stack()):
                self.total += flops
            return out
        grads = (sum(isinstance(t, torch.Tensor) and t.requires_grad for t in operands)
                 if torch.is_grad_enabled() else 0)
        self.total += flops * (1 + grads)
        return out

    def _backward(self, func, args, kwargs):
        """``func`` (the backward's entry) with the engine's run under this mode: the
        entry's Python wrapper would otherwise leave the mode off for the whole run."""
        import torch.autograd as autograd

        engine_run = autograd._engine_run_backward

        def run_under_mode(*a, **k):
            with self:
                return engine_run(*a, **k)

        self._in_backward += 1
        autograd._engine_run_backward = run_under_mode
        try:
            return func(*args, **kwargs)
        finally:
            autograd._engine_run_backward = engine_run
            self._in_backward -= 1


def step_flops(fn, *args, **kwargs) -> tuple[object, float]:
    """``fn(*args, **kwargs)`` once under ``StepFlopCounter``: ``(its result, the
    flops)``, the counter's total plus the hand kernels' formula flops of the launches
    it made."""
    before = hand_kernel_flops()
    with StepFlopCounter() as counter:
        out = fn(*args, **kwargs)
    return out, float(counter.total) + hand_kernel_flops() - before


def _clone(tree):
    """A deep copy of a state tree's tensors (dicts, tuples, named tuples)."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        items = [_clone(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return tree


def train_step_flops(step_fn, state, *batch) -> float:
    """The flops of one training step: ``step_fn(copy of state, *batch)`` under
    ``step_flops``, on a copy (the fused SGD update writes its state in place), with the
    hand kernels' launch counters put back afterwards: the count is not a step of the
    run."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import (
        flash_attention,
        fused_kernels,
    )

    fused = fused_kernels.launch_counts()
    flash = {f"{k}_launches": v for k, v in flash_attention.launch_counts().items()}
    offsets = dict(flash_attention.offset_launches)
    try:
        _, flops = step_flops(step_fn, _clone(state), *batch)
    finally:
        now = fused_kernels.launch_counts()
        fused_kernels.add_launch_counts({k: fused[k] - now[k] for k in fused})
        for name, value in flash.items():
            setattr(flash_attention, name, value)
        flash_attention.offset_launches.update(offsets)
    return flops


class TrainerTelemetry:
    """A trainer's telemetry: the writer (rank-0 gated, atomic, ``preserve`` on a resumed
    run), the manifest at construction, the ``compile`` event from the first segment
    call's seconds (``first_call``), the ``plan`` event of a planned run (``plan``), one
    ``epoch`` (and, with ``health``, one ``health``) event an epoch, and the ``mfu`` event
    with the best step time at ``close``. Every method is a no-op when ``path`` is empty."""

    def __init__(self, path: str, config, *, run_type: str, device,
                 axes: dict[str, int] | None = None, preserve: bool = False):
        self.writer = TelemetryWriter(path, preserve=preserve)
        self.device = torch.device(device)
        self.compile_s: float | None = None
        self.flops_per_step: float | None = None
        self.best_step_s: float | None = None
        self.writer.emit(manifest_event(config, axes=axes, run_type=run_type,
                                        device=self.device))

    @property
    def on(self) -> bool:
        return bool(self.writer.path)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def first_call(self, fn, *args, steps_per_call: int, name: str = "epoch_segment"):
        """``fn(*args)``; the first call of the run is timed (closed by a device sync)
        and reported as the ``compile`` event."""
        if not self.on or self.compile_s is not None:
            return fn(*args)
        self.sync()
        t0 = time.perf_counter()
        out = fn(*args)
        self.sync()
        self.compile_s = time.perf_counter() - t0
        flops = (self.flops_per_step * steps_per_call if self.flops_per_step else None)
        self.writer.emit(compile_event(name, {"lower_s": None, "compile_s": self.compile_s,
                                              "flops": flops, "bytes_accessed": None},
                                       steps_per_call=steps_per_call))
        return out

    def epoch(self, epoch: int, *, examples: int, steps: int, wall_s: float,
              execute_s: float, eval_s: float | None = None, data_s: float | None = None,
              train_loss: float | None = None, val_loss: float | None = None,
              health=None, param_norm: float | None = None) -> None:
        """The epoch's ``epoch`` event, and its ``health`` event when ``health`` (a
        host ``HealthStats``) is given."""
        if not self.on:
            return
        step_s = execute_s / steps if steps else None
        if step_s and (self.best_step_s is None or step_s < self.best_step_s):
            self.best_step_s = step_s
        self.writer.emit(epoch_event(
            epoch, examples=examples, steps=steps, wall_s=wall_s, execute_s=execute_s,
            eval_s=eval_s, data_s=data_s, compile_s=self.compile_s,
            flops_per_step=self.flops_per_step, train_loss=train_loss, val_loss=val_loss,
            mfu=estimate_mfu(self.flops_per_step, step_s, device=self.device)["mfu"]))
        if health is not None:
            self.writer.emit(health_event(epoch, health, steps, param_norm=param_norm))

    def plan(self, plan, events=()) -> None:
        """The ``plan`` event of a run that ``--plan`` laid out, then the ``autotune``
        events its trials buffered before the writer existed."""
        self.writer.emit(plan_event(plan))
        for event in events:
            self.writer.emit(event)

    def close(self) -> None:
        if self.on and self.best_step_s is not None:
            self.writer.emit(mfu_event(self.flops_per_step, self.best_step_s,
                                       device=self.device))


def host_health(health):
    """A ``HealthStats`` of device scalars as host floats (one fetch)."""
    return type(health)(*torch.stack([h.float() for h in health]).tolist())


def compile_event(fn_name: str, aot: dict, *, steps_per_call: int | None = None) -> dict:
    """The ``compile`` event for one program: ``aot`` holds ``lower_s``, ``compile_s``,
    ``flops`` (one call's) and ``bytes_accessed``, each None where not measured."""
    flops = aot.get("flops")
    return {
        "event": "compile",
        "fn": fn_name,
        "lower_s": _finite(aot.get("lower_s")),
        "compile_s": _finite(aot.get("compile_s")),
        "flops_per_call": _finite(flops),
        "steps_per_call": steps_per_call,
        "flops_per_step": _finite(flops / steps_per_call
                                  if flops and steps_per_call else None),
        "bytes_accessed_per_call": _finite(aot.get("bytes_accessed")),
        "bytes_accessed_per_step": _finite(
            aot["bytes_accessed"] / steps_per_call
            if aot.get("bytes_accessed") and steps_per_call else None),
    }


def epoch_event(epoch: int, *, examples: int, steps: int | None = None,
                wall_s: float | None = None, execute_s: float | None = None,
                eval_s: float | None = None, data_s: float | None = None,
                compile_s: float | None = None, flops_per_step: float | None = None,
                train_loss: float | None = None, val_loss: float | None = None,
                mfu: float | None = None) -> dict:
    """Per-epoch phase timing. ``execute_s`` is the epoch's training (closed by a device
    sync); ``wall_s`` the whole epoch with host work; ``data_s`` the index plan's
    construction; ``compile_s`` repeated on every line so each is self-contained."""
    ex = _finite(execute_s)
    return {
        "event": "epoch",
        "epoch": int(epoch),
        "examples": int(examples),
        "steps": int(steps) if steps is not None else None,
        "wall_s": _finite(wall_s),
        "execute_s": ex,
        "eval_s": _finite(eval_s),
        "data_s": _finite(data_s),
        "compile_s": _finite(compile_s),
        "examples_per_s": _finite(examples / ex if ex else None),
        "steps_per_s": _finite(steps / ex if ex and steps else None),
        "flops_per_step": _finite(flops_per_step),
        "train_loss": _finite(train_loss),
        "val_loss": _finite(val_loss),
        "mfu": _finite(mfu),
    }


def data_event(epoch: int, *, batches: int, sequences: int, wait_s: float | None = None,
               throttle_s: float = 0.0, cursor: dict | None = None,
               stream_digest: int | None = None) -> dict:
    """Per-epoch streaming-loader ledger (``data/stream.py``): batches consumed, seconds
    blocked on the loader, the resume cursor and the epoch's stream CRC."""
    return {
        "event": "data",
        "epoch": int(epoch),
        "batches": int(batches),
        "sequences": int(sequences),
        "wait_s": _finite(wait_s),
        "throttle_s": _finite(throttle_s),
        "cursor": dict(cursor) if cursor else None,
        "stream_digest": int(stream_digest) if stream_digest is not None else None,
    }


def health_event(epoch: int, health, steps: int, *, param_norm: float | None = None) -> dict:
    """The ``health`` event from a ``train.step.HealthStats`` (read once an epoch).
    ``grad_norm`` is the per-step mean; min/max bound the epoch."""
    steps = max(int(steps), 1)
    return {
        "event": "health",
        "epoch": int(epoch),
        "steps": steps,
        "grad_norm": _finite(float(health.grad_norm_sum) / steps),
        "grad_norm_max": _finite(float(health.grad_norm_max)),
        "loss_min": _finite(float(health.loss_min)),
        "loss_max": _finite(float(health.loss_max)),
        "loss_mean": _finite(float(health.loss_sum) / steps),
        "param_norm": _finite(param_norm),
    }


def anomaly_event(epoch: int, guard, steps: int, *, fingerprint: float | None = None,
                  skip: str = "") -> dict:
    """The per-epoch ``anomaly`` event from a ``train.step.GuardState`` (counters
    cumulative for the attempt), with the fingerprint and the active skip windows."""
    mean = float(guard.ema_mean)
    std = math.sqrt(max(float(guard.ema_sq) - mean * mean, 0.0))
    return {
        "event": "anomaly",
        "epoch": int(epoch),
        "steps": int(steps),
        "anomalies": int(guard.anomalies),
        "nonfinite": int(guard.nonfinite),
        "spikes": int(guard.spikes),
        "skipped": int(guard.skipped),
        "clean_steps": int(guard.count),
        "first_anomaly_step": int(guard.first_anomaly_step),
        "last_anomaly_step": int(guard.last_anomaly_step),
        "grad_norm_ema": _finite(mean),
        "grad_norm_std": _finite(std),
        "fingerprint": _finite(fingerprint),
        "skip": skip,
    }


def param_fingerprint(tree: dict[str, torch.Tensor]) -> float:
    """The state's fingerprint: per-leaf f32 absolute sums, folded on the host in f32.

    Computed on this process's own copy (one host fetch a leaf), never by a collective: a
    reduction across ranks would hand every rank the same value, corruption included, and
    a supervisor comparing the ranks' fingerprints would see nothing. Equal across ranks
    exactly when their replicated parameters are."""
    total = np.float32(0.0)
    for leaf in tree.values():
        data = leaf.detach().cpu().numpy()
        total += np.abs(data.astype(np.float32)).sum(dtype=np.float32)
    return float(total)


def checkpoint_event(*, op: str, path: str, kind: str = "full", nbytes: int | None = None,
                     wall_s: float | None = None, step: int | None = None,
                     coalesced: int | None = None, background: bool = False) -> dict:
    """One checkpoint save/restore: ``op`` ``"save"``/``"restore"``, ``kind``
    ``"full"``/``"sharded"``."""
    return {
        "event": "checkpoint",
        "op": op,
        "path": path,
        "kind": kind,
        "bytes": int(nbytes) if nbytes is not None else None,
        "wall_s": _finite(wall_s),
        "step": int(step) if step is not None else None,
        "background": bool(background),
        "coalesced": int(coalesced) if coalesced is not None else None,
    }


def preempt_event(*, epoch: int, step: int, checkpoint: str = "") -> dict:
    """A cooperative preemption stop: where the run halted and its durable checkpoint."""
    return {"event": "preempt", "epoch": int(epoch), "step": int(step),
            "checkpoint": checkpoint}


def plan_event(plan, *, candidates: int | None = None) -> dict:
    """The once-per-run ``plan`` record (``plan.apply_plan``): which layout the
    planner picked, from which source, at what predicted/measured cost.
    ``plan`` is a ``plan.artifact.Plan``; the full candidate table lives in the
    saved plan JSON — this line carries the decision, not the search."""
    predicted = plan.predicted or {}
    return {
        "event": "plan",
        "run_type": plan.run_type,
        "source": plan.source,
        "mesh": plan.mesh,
        "axes": dict(plan.axes),
        "fsdp": bool(plan.fsdp),
        "grad_accum": int(plan.grad_accum),
        "pipeline_microbatches": int(plan.pipeline_microbatches),
        "device_count": int(plan.device_count),
        "global_batch": int(plan.global_batch),
        "predicted_step_s": _finite(predicted.get("step_s")),
        "predicted_bytes_per_chip": _finite(predicted.get("total_bytes_per_chip")),
        "measured_step_s": _finite(plan.measured_step_s),
        "candidates": (int(candidates) if candidates is not None
                       else len(plan.candidates)),
    }


def autotune_event(*, mesh: str, fsdp: bool, grad_accum: int, microbatches: int,
                   rank: int, predicted_step_s: float | None,
                   measured_step_s: float | None = None,
                   compile_s: float | None = None,
                   flops_per_step: float | None = None) -> dict:
    """One empirically trialed candidate (``plan/autotune.py``): the analytical
    prediction next to the measured fact, so the cost model is auditable from
    the telemetry alone. ``measured_step_s`` None = the trial harness could not
    build this layout (analytical estimate retained in the ranking)."""
    return {
        "event": "autotune",
        "mesh": mesh,
        "fsdp": bool(fsdp),
        "grad_accum": int(grad_accum),
        "microbatches": int(microbatches),
        "rank": int(rank),
        "predicted_step_s": _finite(predicted_step_s),
        "measured_step_s": _finite(measured_step_s),
        "compile_s": _finite(compile_s),
        "flops_per_step": _finite(flops_per_step),
    }


def global_l2_norm(tree: dict[str, torch.Tensor], norm_fn=None) -> float:
    """The global L2 norm of a parameter dict (the health event's ``param_norm``), read
    once an epoch: ``ops.optim.global_l2_norm``, or ``norm_fn`` for a dict split over a
    grid (``parallel.tensor_parallel.sharded_norm_fn``: a collective, so every rank calls
    it)."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import optim

    return float((norm_fn or optim.global_l2_norm)(tree))


def estimate_mfu(flops_per_step: float | None, step_s: float | None,
                 bytes_per_step: float | None = None,
                 device: torch.device | str | None = None) -> dict:
    """Achieved FLOP/s per device against the card's published bf16 peak
    (``utils.benchmarks.peak_flops``), and achieved bytes/s against its memory rate when
    ``bytes_per_step`` is given. ``mfu`` is None on the CPU or an unknown card."""
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils.benchmarks import (
        PEAK_HBM_BYTES_BY_KIND,
        lookup_by_kind,
        peak_flops,
    )

    platform_name, kind, count = _device_kind()
    on_card = platform_name == "gpu" and (device is None or torch.device(device).type == "cuda")
    if not on_card:
        kind, count = "cpu", 1
    achieved = flops_per_step / step_s if flops_per_step and step_s else None
    peak = peak_flops(kind) if on_card else None
    bw = bytes_per_step / step_s if bytes_per_step and step_s else None
    peak_bw = lookup_by_kind(PEAK_HBM_BYTES_BY_KIND, kind) if on_card else None
    return {
        "flops_per_step": _finite(flops_per_step),
        "step_s": _finite(step_s),
        "achieved_flops_per_s_per_device": _finite(achieved),
        "device_kind": kind,
        "devices": count,
        "peak_flops_per_s_per_device": _finite(peak),
        "mfu": _finite(achieved / peak if achieved and peak else None),
        "bytes_accessed_per_step": _finite(bytes_per_step),
        "achieved_bytes_per_s_per_device": _finite(bw),
        "peak_hbm_bytes_per_s": _finite(peak_bw),
        "hbm_frac": _finite(bw / peak_bw if bw and peak_bw else None),
    }


def mfu_event(flops_per_step: float | None, step_s: float | None,
              bytes_per_step: float | None = None,
              device: torch.device | str | None = None) -> dict:
    """The steady-state ``mfu`` event (once, with the best measured step time)."""
    return {"event": "mfu", **estimate_mfu(flops_per_step, step_s, bytes_per_step, device)}


def series_percentiles(series, qs=(50, 95, 99)) -> dict | None:
    """p50/p95/p99 of a latency series: a raw sequence (nearest rank) or a
    ``LogHistogram`` sketch."""
    if isinstance(series, LogHistogram):
        return series.percentiles(qs)
    return percentiles(series, qs)


def serve_event(*, request_id: int, prompt_len: int, new_tokens: int, finish: str,
                queue_wait_s: float | None = None, ttft_s: float | None = None,
                tpot_s: float | None = None, e2e_s: float | None = None,
                tenant: str = "default", preemptions: int = 0) -> dict:
    """One served request: ``tokens_per_s`` is generated tokens over the time since
    admission (e2e minus queue wait)."""
    decode_s = (e2e_s - queue_wait_s
                if e2e_s is not None and queue_wait_s is not None else None)
    return {
        "event": "serve",
        "request_id": int(request_id),
        "prompt_len": int(prompt_len),
        "new_tokens": int(new_tokens),
        "finish": finish,
        "queue_wait_s": _finite(queue_wait_s),
        "ttft_s": _finite(ttft_s),
        "tpot_s": _finite(tpot_s),
        "e2e_s": _finite(e2e_s),
        "tokens_per_s": _finite(new_tokens / decode_s if new_tokens and decode_s else None),
        "tenant": tenant,
        "preemptions": int(preemptions),
    }


def shed_event(*, tenant: str, reason: str, request_id: int | None = None,
               priority: int | None = None, source: str = "server") -> dict:
    """One shedding decision: ``reason`` ``"quota"``, ``"refused"`` or ``"displaced"``."""
    return {
        "event": "shed",
        "source": source,
        "tenant": tenant,
        "reason": reason,
        "request_id": int(request_id) if request_id is not None else None,
        "priority": int(priority) if priority is not None else None,
    }


def tenant_summary_event(*, tenant: str, source: str = "server", requests: int = 0,
                         ok: int = 0, timeout: int = 0, shed: int = 0, new_tokens: int = 0,
                         preemptions: int = 0, ttft_s: dict | None = None,
                         e2e_s: dict | None = None, slo: dict | None = None) -> dict:
    """One tenant's drain-time ledger: counts, percentiles, preemptions, attainment."""
    return {
        "event": "tenant_summary",
        "source": source,
        "tenant": tenant,
        "requests": int(requests),
        "ok": int(ok),
        "timeout": int(timeout),
        "shed": int(shed),
        "new_tokens": int(new_tokens),
        "preemptions": int(preemptions),
        "ttft_s": ttft_s,
        "e2e_s": e2e_s,
        "slo": slo,
    }


def prefill_event(*, request_id: int, prompt_len: int, chunks: int, tokens: int,
                  cache_hit_len: int, wall_s: float | None,
                  latency_s: float | None = None) -> dict:
    """One completed prompt prefill: ``chunks`` invocations covered ``tokens`` positions
    (``cache_hit_len`` more came from the prefix cache); ``latency_s`` is admission to
    decode-ready. The port's engine measures no per-chunk wall (``wall_s`` None)."""
    return {
        "event": "prefill",
        "request_id": int(request_id),
        "prompt_len": int(prompt_len),
        "chunks": int(chunks),
        "tokens": int(tokens),
        "cache_hit_len": int(cache_hit_len),
        "wall_s": _finite(wall_s),
        "latency_s": _finite(latency_s),
        "tokens_per_s": _finite(tokens / wall_s if tokens and wall_s else None),
    }


def spec_event(*, step: int, active: int, proposed: int, accepted: int, emitted: int,
               draft_wall_s: float | None = None,
               verify_wall_s: float | None = None) -> dict:
    """One speculative verify step: ``emitted_per_slot`` is at least 1.0 (the correction
    always lands), so read acceptance from ``accepted`` / ``proposed``."""
    return {
        "event": "spec",
        "step": int(step),
        "active": int(active),
        "proposed": int(proposed),
        "accepted": int(accepted),
        "emitted": int(emitted),
        "emitted_per_slot": _finite(emitted / active if active else None),
        "draft_wall_s": _finite(draft_wall_s),
        "verify_wall_s": _finite(verify_wall_s),
    }


def serve_summary_event(*, requests: int, ok: int, timeout: int, new_tokens: int,
                        wall_s: float | None, steps: int | None = None, shed: int = 0,
                        decode_invocations: int | None = None,
                        generated_tokens: int | None = None, spec: dict | None = None,
                        slot_occupancy: float | None = None,
                        prefill_tokens: int | None = None,
                        prefill_chunks: int | None = None,
                        prefill_wall_s: float | None = None,
                        prefix_cache: dict | None = None, queue: dict | None = None,
                        byte_accounting: dict | None = None, kv_pages: dict | None = None,
                        slo: dict | None = None, preemptions: int | None = None,
                        resumes: int | None = None, tenants: dict | None = None,
                        ttft_s=(), tpot_s=(), e2e_s=(), queue_wait_s=()) -> dict:
    """The once-per-run serving aggregate, emitted at drain (the JAX package's keys):
    counts, tokens/s over the server's wall, program invocations against generated tokens,
    occupancy, the prefill and prefix-cache ledgers, the queue snapshot, the engine's
    byte accounting (as ``"bytes"``), the page ledger, attainment, tenancy, and p50/p95/p99
    of the four latency series (raw sequences or ``LogHistogram`` sketches)."""
    return {
        "event": "serve_summary",
        "requests": int(requests),
        "ok": int(ok),
        "timeout": int(timeout),
        "new_tokens": int(new_tokens),
        "wall_s": _finite(wall_s),
        "tokens_per_s": _finite(new_tokens / wall_s if new_tokens and wall_s else None),
        "steps": int(steps) if steps is not None else None,
        "decode_invocations": (int(decode_invocations)
                               if decode_invocations is not None else None),
        "generated_tokens": (int(generated_tokens)
                             if generated_tokens is not None else None),
        "tokens_per_invocation": _finite(
            generated_tokens / decode_invocations
            if generated_tokens and decode_invocations else None),
        "spec": spec,
        "slot_occupancy": _finite(slot_occupancy),
        "prefill_tokens": int(prefill_tokens) if prefill_tokens is not None else None,
        "prefill_chunks": int(prefill_chunks) if prefill_chunks is not None else None,
        "prefill_wall_s": _finite(prefill_wall_s),
        "prefill_tokens_per_s": _finite(
            prefill_tokens / prefill_wall_s if prefill_tokens and prefill_wall_s else None),
        "prefix_cache": prefix_cache,
        "queue": queue,
        "bytes": byte_accounting,
        "kv_pages": kv_pages,
        "slo": slo,
        "shed": int(shed),
        "preemptions": int(preemptions) if preemptions is not None else None,
        "resumes": int(resumes) if resumes is not None else None,
        "tenants": tenants,
        "ttft_s": series_percentiles(ttft_s),
        "tpot_s": series_percentiles(tpot_s),
        "e2e_s": series_percentiles(e2e_s),
        "queue_wait_s": series_percentiles(queue_wait_s),
    }


def kv_pages_event(*, source: str = "server", stats: dict) -> dict:
    """One paged-KV pool ledger line (a paged engine's ``page_stats()``), at drain."""
    return {"event": "kv_pages", "source": source, **stats}


def promote_event(*, action: str, candidate: str, step: int | None = None,
                  reason: str = "", incumbent: str = "",
                  nll: float | None = None, incumbent_nll: float | None = None,
                  perf_s: float | None = None,
                  incumbent_perf_s: float | None = None) -> dict:
    """One promotion-gate lifecycle transition (``deploy/promoter.py``):
    ``action`` is ``candidate_seen`` / ``gate_pass`` / ``gate_fail`` /
    ``canary_start`` / ``promoted`` / ``rolled_back``. ``candidate`` and
    ``incumbent`` are checkpoint paths; the NLL and perf pairs record the
    gate's actual measurements so a rejected candidate's margin is auditable
    from the stream alone."""
    return {
        "event": "promote",
        "action": action,
        "candidate": candidate,
        "step": int(step) if step is not None else None,
        "reason": reason,
        "incumbent": incumbent,
        "nll": _finite(nll),
        "incumbent_nll": _finite(incumbent_nll),
        "perf_s": _finite(perf_s),
        "incumbent_perf_s": _finite(incumbent_perf_s),
    }


def canary_event(*, candidate: str, replica: int, verdict: str,
                 window_s: float | None = None,
                 canary_attainment: float | None = None,
                 fleet_attainment: float | None = None,
                 canary_nll: float | None = None,
                 fleet_nll: float | None = None,
                 canary_requests: int | None = None,
                 fleet_requests: int | None = None,
                 reason: str = "") -> dict:
    """One canary-window verdict (``deploy/promoter.py``): the candidate on
    ONE replica vs the rest of the fleet over the same attainment window —
    windowed SLO attainment (fractions) and sampled-token NLL under the
    shared last-good scorer. ``verdict`` is ``pass`` / ``fail`` /
    ``inconclusive`` (too few requests to judge)."""
    return {
        "event": "canary",
        "candidate": candidate,
        "replica": int(replica),
        "verdict": verdict,
        "window_s": _finite(window_s),
        "canary_attainment": _finite(canary_attainment),
        "fleet_attainment": _finite(fleet_attainment),
        "canary_nll": _finite(canary_nll),
        "fleet_nll": _finite(fleet_nll),
        "canary_requests": (int(canary_requests)
                            if canary_requests is not None else None),
        "fleet_requests": (int(fleet_requests)
                           if fleet_requests is not None else None),
        "reason": reason,
    }


__all__ = ["anomaly_event", "autotune_event", "canary_event", "checkpoint_event",
           "compile_event", "data_event", "epoch_event", "estimate_mfu",
           "global_l2_norm", "hand_kernel_flops", "health_event", "host_health",
           "kv_pages_event", "manifest_event", "mfu_event", "param_fingerprint",
           "percentiles", "plan_event", "preempt_event", "prefill_event",
           "promote_event", "SCHEMA_VERSION", "series_percentiles", "serve_event",
           "serve_summary_event", "shed_event", "spec_event", "step_flops",
           "TelemetryWriter", "tenant_summary_event", "train_step_flops",
           "TrainerTelemetry"]
