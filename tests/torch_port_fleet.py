"""Gloo fleets for the port's mesh tests: ``python -c code`` as a world of N processes on
the CPU through the port's launcher (one thread each, a hard ``--timeout``), started and
not waited for, so a test file's JAX references run while its fleet trains. Each test file
opens one fleet per world size it needs and runs all its cases in it."""

import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = "csed_514_project_distributed_training_using_pytorch_tpu_torch"
FLEET_TIMEOUT = 240            # seconds; the launcher kills the fleet and exits 124

# the child's preamble: the tiny synthetic splits every mesh test trains on
SPLITS = """
import os
import numpy as np, torch
from {pkg}.data import mnist
torch.set_num_threads(1)
RANK = int(os.environ["RANK"])


def splits(n_train, n_test):
    out = []
    for n, seed in ((n_train, 200), (n_test, 201)):
        x, y = mnist._synthesize_split(n, seed)
        out.append(mnist.Dataset(mnist._normalize(x), y.astype(np.int32), "synthetic"))
    return tuple(out)
"""


def env() -> dict:
    out = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        out.pop(key, None)
    return out


def start(cwd: pathlib.Path, code: str, world: int) -> subprocess.Popen:
    """``code`` (after ``SPLITS``) as a world of ``world`` gloo processes."""
    return subprocess.Popen(
        [sys.executable, "-m", f"{PKG}.train.launch", "--num-processes", str(world),
         "--timeout", str(FLEET_TIMEOUT), "--", "-c", SPLITS.format(pkg=PKG) + code],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env(), cwd=str(cwd))


def finish(proc: subprocess.Popen) -> str:
    out, err = proc.communicate(timeout=FLEET_TIMEOUT + 60)
    assert proc.returncode == 0, f"fleet exited {proc.returncode}\n{out[-2000:]}\n{err[-4000:]}"
    return out


class Fleets:
    """The fleets of one test file, started at once; ``get(name)`` waits for one."""

    def __init__(self, base: pathlib.Path, fleets: dict):
        self.base = base
        self.procs = {name: start(base, code, world) for name, (code, world) in fleets.items()}
        self.out: dict = {}

    def get(self, name: str) -> pathlib.Path:
        if name not in self.out:
            self.out[name] = finish(self.procs[name])
        return self.base

    def close(self) -> None:
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


def port_init(path: pathlib.Path, **model_kw) -> dict:
    """A classifier's initial parameters drawn by the port (seed 3), saved for the fleet
    and returned as numpy arrays: both packages start from them."""
    import numpy as np
    import torch

    from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import (
        transformer,
    )
    params = transformer.TransformerClassifier(dropout_rate=0.0, **model_kw).init(
        torch.Generator().manual_seed(3))
    arrays = {k: p.numpy() for k, p in params.items()}
    np.savez(path, **arrays)
    return arrays


def jax_starting_from(arrays: dict):
    """A stand-in for the JAX package's ``create_train_state`` that starts from the port's
    parameters ``arrays`` (patched into ``train.composed`` around a reference run): the
    JAX state's layout and optimizer state, with those values, and no eager init."""
    import jax.numpy as jnp

    from csed_514_project_distributed_training_using_pytorch_tpu.train import (
        step as jax_step,
    )
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import (
        transformer,
    )
    import torch

    tree = transformer.params_to_jax({k: torch.from_numpy(v) for k, v in arrays.items()})

    def create(model, rng, sample_input_shape=(1, 28, 28, 1), *, optimizer=None,
               ema=False, guard=False):
        params = {k: _to_jnp(v, jnp) for k, v in tree.items()}
        init = optimizer.init if optimizer is not None else jax_step.sgd_init
        return jax_step.TrainState(params=params, velocity=init(params),
                                   step=jnp.zeros((), jnp.int32),
                                   ema=_to_jnp(tree, jnp) if ema else None,
                                   guard=jax_step.init_guard() if guard else None)

    return create


def _to_jnp(node, jnp):
    if isinstance(node, dict):
        return {k: _to_jnp(v, jnp) for k, v in node.items()}
    return jnp.asarray(node)
