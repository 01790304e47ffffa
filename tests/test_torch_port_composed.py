"""PyTorch port, composed trainer on one device, against the JAX package's
``train.composed.main`` at ``--mesh data=1``.

Both trainers run on the same injected synthetic splits from the same initial parameters
(the JAX package's, carried across with ``params_from_jax``), dropout off (the composed
default). The epoch plans are compared bitwise; the epoch train loss and val loss agree
within atol 1e-5 (float32 sums in another order, over two epochs of four steps).
"""

import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from csed_514_project_distributed_training_using_pytorch_tpu.data import mnist as jax_mnist
from csed_514_project_distributed_training_using_pytorch_tpu.models import (
    transformer as jax_tf,
)
from csed_514_project_distributed_training_using_pytorch_tpu.train import (
    composed as jax_composed,
)
from csed_514_project_distributed_training_using_pytorch_tpu.train import step as jax_step
from csed_514_project_distributed_training_using_pytorch_tpu.utils import (
    config as jax_config,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.data import mnist
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import transformer
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import (
    flash_attention as fa,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel import (
    parse_mesh_spec,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import composed
from csed_514_project_distributed_training_using_pytorch_tpu_torch.utils import config

LOSS_ATOL = 1e-5
EPOCH_LINE = re.compile(r"Epoch (\d+): train_loss: ([\d.]+), val_loss: ([\d.]+), "
                        r"accuracy: ([\d.]+), time_elapsed: [\d.]+s")


def _datasets(n_train, n_test):
    out = []
    for n, seed in ((n_train, 200), (n_test, 201)):
        x, y = mnist._synthesize_split(n, seed)
        out.append((mnist._normalize(x), y.astype(np.int32)))
    port = tuple(mnist.Dataset(x, y, "synthetic") for x, y in out)
    ref = tuple(jax_mnist.Dataset(x, y, "synthetic") for x, y in out)
    return port, ref


def test_composed_main_matches_jax(tmp_path, monkeypatch, capsys):
    (port_ds, ref_ds) = _datasets(256, 100)
    common = dict(mesh="data=1", seq_len=16, epochs=2, batch_size=64, batch_size_test=100,
                  learning_rate=0.05, momentum=0.5, seed=3)
    jax_plans, port_plans = [], []
    put_global = jax_composed.dp.put_global

    def record_put(mesh, array, spec):
        if np.asarray(array).ndim == 2:
            jax_plans.append(np.asarray(array))
        return put_global(mesh, array, spec)

    monkeypatch.setattr(jax_composed.dp, "put_global", record_put)
    _, j_hist = jax_composed.main(
        jax_config.ComposedConfig(results_dir=str(tmp_path / "jax"), **common),
        datasets=ref_ds)

    j_model = jax_tf.TransformerClassifier(seq_len=16, dropout_rate=0.0)
    j_init = jax_step.create_train_state(j_model, jax.random.PRNGKey(3)).params
    plan = composed.epoch_plan
    monkeypatch.setattr(composed, "epoch_plan",
                        lambda *a: port_plans.append(plan(*a)) or port_plans[-1])
    capsys.readouterr()
    state, hist = composed.main(
        config.ComposedConfig(results_dir=str(tmp_path / "port"), device="cpu", **common),
        datasets=port_ds, init_params=transformer.params_from_jax(j_init))
    lines = [EPOCH_LINE.match(l) for l in capsys.readouterr().out.splitlines()]
    lines = [m for m in lines if m]

    assert len(jax_plans) == len(port_plans) == 2
    for j, p in zip(jax_plans, port_plans):
        np.testing.assert_array_equal(p, j.astype(np.int64))
    assert state.step == 8 and [m.group(1) for m in lines] == ["0", "1"]
    assert hist.train_counter == j_hist.train_counter == [256, 512]
    np.testing.assert_allclose(hist.train_losses, j_hist.train_losses, atol=LOSS_ATOL)
    np.testing.assert_allclose(hist.test_losses, j_hist.test_losses, atol=LOSS_ATOL)
    with open(tmp_path / "port" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["kind"] for r in rows] == ["train", "train", "test", "test"]


@pytest.mark.parametrize("kw,match", [
    ({"mesh": "data=2"}, "ROADMAP A6/A10"),
    ({"mesh": "data=2,seq=2,model=2"}, "ROADMAP A6/A10"),       # the JAX default mesh
    ({"mesh": "data=1,expert=4"}, "ROADMAP A6/A10"),            # MoE rides the expert axis
    ({"mesh": "data=2,seq=2", "flash_attention": True, "seq_len": 256},
     "ROADMAP A6/A10"),                                         # data beside seq
    ({"mesh": "data=1,pipe=1"}, "unknown mesh axis"),
    ({"mesh": "data=1", "kv_heads": 3}, "positive divisor"),
    ({"mesh": "data=1", "attention_window": -1}, "window must be >= 1"),
    ({"mesh": "data=1", "flash_attention": True, "seq_len": 100}, "divisible by"),
    ({"mesh": "data=1", "optimizer": "adamw"}, "only 'sgd'"),
])
def test_unported_or_bad_configs_raise(kw, match):
    with pytest.raises(ValueError, match=match):
        composed.main(config.ComposedConfig(device="cpu", **kw), datasets=_datasets(64, 10)[0])


def test_cuda_is_the_default_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert config.ComposedConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="--device cpu"):
        composed.main(config.ComposedConfig(mesh="data=1"), datasets=_datasets(64, 10)[0])


def test_flash_path_at_seq_2048_runs_the_plain_versions(tmp_path, monkeypatch):
    """The slice's path on the CPU: seq 2048 with --flash-attention goes through the flash
    wrappers (their plain versions here), 2 layers x (2 steps + 1 eval batch) forwards and
    2 x 2 backwards, each one plain pass for dq and one for dk/dv."""
    calls = {"forward": 0, "backward": 0}
    fwd, bwd = fa.flash_forward_plain, fa._backward_plain

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(fa, "flash_forward_plain", counted("forward", fwd))
    monkeypatch.setattr(fa, "_backward_plain", counted("backward", bwd))
    state, hist = composed.main(
        config.ComposedConfig(mesh="data=1", flash_attention=True, seq_len=2048, epochs=1,
                              batch_size=16, batch_size_test=16, max_train_examples=32,
                              max_test_examples=16, device="cpu",
                              results_dir=str(tmp_path)),
        datasets=_datasets(40, 20)[0])
    assert state.step == 2
    assert calls == {"forward": 2 * (2 + 1), "backward": 2 * 2 * 2}
    assert fa.launch_counts() == {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
    assert all(np.isfinite(hist.train_losses + hist.test_losses))
    assert os.path.exists(tmp_path / "metrics.jsonl")


def test_cli_flags():
    cfg = config.parse_config(config.ComposedConfig, [
        "--mesh", "data=1", "--flash-attention", "--seq-len", "2048", "--device", "cpu",
        "--max-train-examples", "64"])
    assert (cfg.mesh, cfg.flash_attention, cfg.seq_len, cfg.device,
            cfg.max_train_examples) == ("data=1", True, 2048, "cpu", 64)
    for unported in (["--fsdp"], ["--remat"], ["--label-smoothing", "0.1"]):
        with pytest.raises(SystemExit):
            config.parse_config(config.ComposedConfig, unported)
    ours = {f for f in config.ComposedConfig.__dataclass_fields__} - {"device"}
    theirs = jax_config.ComposedConfig()
    for name in ours:
        assert getattr(config.ComposedConfig(), name) == getattr(theirs, name), name


def test_parse_mesh_spec_matches_jax():
    from csed_514_project_distributed_training_using_pytorch_tpu.parallel.mesh import (
        parse_mesh_spec as jax_parse,
    )
    for spec in ("data=1", "data=2,seq=2,model=2", "stage=2,data=4"):
        assert parse_mesh_spec(spec) == jax_parse(spec)
    for bad in ("", "data", "data=0", "data=x", "data=1,data=1", "rows=2"):
        with pytest.raises(ValueError) as got:
            parse_mesh_spec(bad)
        with pytest.raises(ValueError) as want:
            jax_parse(bad)
        assert str(got.value) == str(want.value)
