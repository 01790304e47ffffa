"""PyTorch port, transformer family: tokenization, the ops it adds (layer_norm, gelu,
RoPE), the classifier's forward and a short flash trajectory, against the JAX package.

The JAX package's initial parameters are carried across with
``models.transformer.params_from_jax``; inputs are made with numpy and handed to both. The
JAX flash kernels run in Pallas interpret mode; the port's take their plain versions on
CPU tensors.

Tolerances: float32 forwards within atol 1e-5 (the same arithmetic, sums in another
order); bfloat16 forwards within atol 3e-2 on log-probs of magnitude ~2.3 (activations
round to bf16 at each dense and LayerNorm output, in places that differ by an ulp between
the two frameworks); the 3-step trajectory within atol 2e-5 in loss and parameters
(float32 round-off compounded over three updates at lr 0.05).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csed_514_project_distributed_training_using_pytorch_tpu import ops as jax_ops
from csed_514_project_distributed_training_using_pytorch_tpu.models import (
    transformer as jax_tf,
)
from csed_514_project_distributed_training_using_pytorch_tpu.ops import (
    attention as jax_attn,
    pallas_attention as jax_pa,
    rotary as jax_rotary,
)
from csed_514_project_distributed_training_using_pytorch_tpu.train import step as jax_step
from csed_514_project_distributed_training_using_pytorch_tpu_torch import models, ops
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models import transformer
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops import (
    attention,
    flash_attention as fa,
    optim,
    rotary,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.train import step

ATOL = 1e-5
BF16_ATOL = 3e-2
TRAJECTORY_ATOL = 2e-5


def _images(n, seed=0):
    return np.random.default_rng(seed).normal(size=(n, 28, 28, 1)).astype(np.float32)


def _pair(kw, jax_core=None, port_core=None):
    """The JAX model, its parameters, and the port's model with those parameters."""
    jax_kw = {k: v for k, v in kw.items() if k != "dtype"}
    port_kw = dict(jax_kw)
    if kw.get("dtype") == "bf16":
        jax_kw["dtype"], port_kw["dtype"] = jnp.bfloat16, torch.bfloat16
    if jax_core is not None:
        jax_kw["attention_fn"], port_kw["attention_fn"] = jax_core, port_core
    jm = jax_tf.TransformerClassifier(**jax_kw)
    jp = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 28, 28, 1)))["params"]
    pm = transformer.TransformerClassifier(**port_kw)
    return jm, jp, pm, transformer.params_from_jax(jp)


@pytest.mark.parametrize("seq_len", [16, 100, 128, 2048])
def test_tokenize_images_is_bitwise(seq_len):
    x = _images(3)
    got = transformer.tokenize_images(torch.from_numpy(x), seq_len).numpy()
    want = np.asarray(jax_tf.tokenize_images(jnp.asarray(x), seq_len))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_layer_norm_and_gelu_match_jax():
    rng = np.random.default_rng(1)
    x, g, b = (rng.normal(size=s).astype(np.float32) for s in ((4, 7, 32), (32,), (32,)))
    np.testing.assert_allclose(
        ops.layer_norm(*map(torch.from_numpy, (x, g, b))).numpy(),
        np.asarray(jax_ops.layer_norm(*map(jnp.asarray, (x, g, b)))), atol=ATOL)
    np.testing.assert_allclose(ops.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax_ops.gelu(jnp.asarray(x))), atol=ATOL)


def test_rotary_matches_jax():
    x = np.random.default_rng(2).normal(size=(2, 16, 4, 16)).astype(np.float32)
    positions = np.arange(16)
    np.testing.assert_allclose(
        rotary.apply_rotary(torch.from_numpy(x), torch.from_numpy(positions)).numpy(),
        np.asarray(jax_rotary.apply_rotary(jnp.asarray(x), jnp.asarray(positions))),
        atol=ATOL)
    one = rotary.apply_rotary(torch.from_numpy(x[0, 3]), torch.tensor(3))
    np.testing.assert_allclose(one.numpy(), np.asarray(jax_rotary.apply_rotary(
        jnp.asarray(x[0, 3]), jnp.asarray(3))), atol=ATOL)


@pytest.mark.parametrize("kw", [{}, {"num_kv_heads": 2}, {"num_kv_heads": 1},
                                {"seq_len": 2048, "embed_dim": 1024, "num_heads": 8,
                                 "num_layers": 8}],
                         ids=["mha", "gqa2", "mqa", "large"])
def test_param_count_matches_jax(kw):
    jm = jax_tf.TransformerClassifier(**kw)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                            jnp.zeros((1, 28, 28, 1)))["params"])
    want = sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes))
    pm = transformer.TransformerClassifier(**kw)
    assert transformer.param_count(pm) == want
    flat = {".".join(str(k.key) for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
    assert {k: tuple(v) for k, v in flat.items()} == {
        k: tuple(p.shape) for k, p in pm.named_parameters()}


@pytest.mark.parametrize("kw", [
    {}, {"num_kv_heads": 2}, {"rope": True}, {"causal": True},
    {"causal": True, "rope": True, "num_kv_heads": 2},
], ids=["mha", "gqa", "rope", "causal", "causal_rope_gqa"])
def test_forward_matches_jax_dense(kw):
    jm, jp, pm, params = _pair({"dropout_rate": 0.0, **kw})
    x = _images(4, 3)
    want = np.asarray(jm.apply({"params": jp}, jnp.asarray(x)))
    got = torch.func.functional_call(pm, params, (torch.from_numpy(x),))
    assert got.dtype == torch.float32 and got.shape == (4, 10)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_forward_matches_jax_windowed():
    jm, jp, pm, params = _pair({"dropout_rate": 0.0}, jax_attn.windowed_attention_fn(4),
                               attention.windowed_attention_fn(4))
    x = _images(4, 4)
    np.testing.assert_allclose(
        torch.func.functional_call(pm, params, (torch.from_numpy(x),)).numpy(),
        np.asarray(jm.apply({"params": jp}, jnp.asarray(x))), atol=ATOL)


@pytest.mark.parametrize("seq_len,kw", [
    (128, {}), (128, {"num_kv_heads": 1, "rope": True}), (256, {"causal": True}),
    (256, {"window": 100}),
], ids=["s128", "s128_mqa_rope", "s256_causal", "s256_window"])
def test_forward_matches_jax_flash(seq_len, kw):
    window = kw.pop("window", None)
    jm, jp, pm, params = _pair(
        {"seq_len": seq_len, "embed_dim": 32, "num_heads": 2, "num_layers": 1,
         "dropout_rate": 0.0, **kw},
        functools.partial(jax_pa.flash_attention, window=window),
        functools.partial(fa.flash_attention, window=window))
    x = _images(2, 5)
    np.testing.assert_allclose(
        torch.func.functional_call(pm, params, (torch.from_numpy(x),)).numpy(),
        np.asarray(jm.apply({"params": jp}, jnp.asarray(x))), atol=ATOL)


@pytest.mark.parametrize("seq_len,flash", [(16, False), (128, True)], ids=["dense", "flash"])
def test_forward_bf16_matches_jax(seq_len, flash):
    cores = (jax_pa.flash_attention, fa.flash_attention) if flash else (None, None)
    jm, jp, pm, params = _pair({"seq_len": seq_len, "embed_dim": 32, "num_heads": 2,
                                "dropout_rate": 0.0, "dtype": "bf16"}, *cores)
    x = _images(4, 6)
    got = torch.func.functional_call(pm, params, (torch.from_numpy(x),))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jm.apply({"params": jp}, jnp.asarray(x))),
                               atol=BF16_ATOL)


def test_pre_tokenized_input_matches_jax():
    """The bench's input form: [B, S, F] tokens, F independent of the image size."""
    jm = jax_tf.TransformerClassifier(seq_len=32, embed_dim=32, num_heads=2,
                                      dropout_rate=0.0)
    tokens = np.random.default_rng(8).normal(size=(2, 32, 16)).astype(np.float32)
    jp = jm.init({"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 32, 16)))["params"]
    pm = transformer.TransformerClassifier(seq_len=32, embed_dim=32, num_heads=2,
                                           dropout_rate=0.0, token_features=16)
    np.testing.assert_allclose(
        torch.func.functional_call(pm, transformer.params_from_jax(jp),
                                   (torch.from_numpy(tokens),)).numpy(),
        np.asarray(jm.apply({"params": jp}, jnp.asarray(tokens))), atol=ATOL)


def test_three_flash_steps_match_jax():
    """Three SGD-momentum steps through ``make_train_step`` with flash as the core on
    both sides (seq 128, embed 32, 2 heads, batch 4, dropout off)."""
    kw = {"seq_len": 128, "embed_dim": 32, "num_heads": 2, "dropout_rate": 0.0}
    jm, jp, pm, params = _pair(kw, jax_pa.flash_attention, fa.flash_attention)
    xs, ys = _images(12, 9), np.arange(12) % 10
    j_state = jax_step.create_train_state(jm, jax.random.PRNGKey(0))
    j_step = jax.jit(jax_step.make_train_step(jm, learning_rate=0.05, momentum=0.5))
    p_state = step.TrainState(params, optim.sgd_init(params), 0)
    p_step = step.make_train_step(pm, learning_rate=0.05, momentum=0.5)
    for i in range(3):
        sl = slice(4 * i, 4 * i + 4)
        j_state, j_loss = j_step(j_state, jnp.asarray(xs[sl]), jnp.asarray(ys[sl]),
                                 jax.random.PRNGKey(2))
        p_state, p_loss = p_step(p_state, torch.from_numpy(xs[sl]),
                                 torch.from_numpy(ys[sl]), 2)
        np.testing.assert_allclose(p_loss.item(), float(j_loss), atol=TRAJECTORY_ATOL)
    want = transformer.params_from_jax(jax.device_get(j_state.params))
    for name, p in p_state.params.items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=TRAJECTORY_ATOL,
                                   err_msg=name)


def test_eval_fn_runs_the_classifier():
    jm, jp, pm, params = _pair({"dropout_rate": 0.0})
    x, y = _images(20, 10), np.arange(20) % 10
    sum_nll, correct = step.make_eval_fn(pm, batch_size=10)(
        params, torch.from_numpy(x), torch.from_numpy(y))
    j_nll, j_correct = jax_step.make_eval_fn(jm, batch_size=10)(
        jp, jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(sum_nll.item(), float(j_nll), atol=1e-4)
    assert int(correct) == int(j_correct)


@pytest.mark.parametrize("policy", ["recompute-all", "save-dots"])
def test_classifier_remat_is_bitwise_the_run_without_it(policy):
    """The classifier's blocks rematerialized (dropout 0.1, the step's masks replayed in
    the recomputation): three SGD steps, losses and parameters bitwise."""
    rng = np.random.default_rng(21)
    xs = torch.from_numpy(rng.normal(size=(3, 8, 28, 28, 1)).astype(np.float32))
    ys = torch.from_numpy(rng.integers(0, 10, size=(3, 8)))
    runs = []
    for remat in (False, True):
        model = transformer.TransformerClassifier(dropout_rate=0.1, remat=remat,
                                                  remat_policy=policy if remat else "")
        state = step.create_train_state(model, torch.Generator().manual_seed(2))
        train_step = step.make_train_step(model, learning_rate=0.05, momentum=0.5)
        losses = []
        for x, y in zip(xs, ys):
            state, loss = train_step(state, x, y, 3)
            losses.append(loss)
        runs.append((torch.stack(losses), state.params))
    assert torch.equal(runs[0][0], runs[1][0])
    for k in runs[0][1]:
        assert torch.equal(runs[0][1][k], runs[1][1][k]), k


def test_unported_knobs_raise():
    # the MoE and the model axis are ported: what remains refused is a split that does
    # not divide (experts over the expert axis, heads over the model axis)
    from csed_514_project_distributed_training_using_pytorch_tpu_torch.parallel.mesh import (
        Axis,
        ShardContext,
    )
    for kw, match in (
            ({"num_experts": 3, "shard": ShardContext(expert=Axis("expert", 2))},
             "experts do not split over the expert axis of 2"),
            ({"shard": ShardContext(model=Axis("model", 3))},
             "split over the model axis of 3")):
        with pytest.raises(ValueError, match=match):
            transformer.TransformerClassifier(**kw)
    assert transformer.TransformerClassifier(num_experts=4).num_experts == 4
    with pytest.raises(ValueError, match="add --remat"):
        transformer.TransformerClassifier(remat_policy="save-dots")
    with pytest.raises(ValueError, match="not divisible"):
        transformer.TransformerClassifier(num_kv_heads=3)
    assert isinstance(models.build_model("transformer", seq_len=32),
                      transformer.TransformerClassifier)
    with pytest.raises(ValueError, match="unknown model"):
        models.build_model("mlp")
    models.validate_model_config("transformer", remat=True, remat_policy="save-dots")
    with pytest.raises(ValueError, match="transformer family only"):
        models.validate_model_config("cnn", remat=True)
    with pytest.raises(ValueError, match="unknown remat policy"):
        models.validate_model_config("transformer", remat=True, remat_policy="dots")


def _bf16_operands(case):
    """[B, S, H, D] bf16 operands for the bf16 flash backward's alignment rule."""
    b, s, h, d = 2, 64, 2, 16
    if case == "fused_qkv_views":        # the classifier's q, k, v slices of one projection
        qkv = torch.zeros(b, s, 3, h, d, dtype=torch.bfloat16)
        return dict(q=qkv[:, :, 0], k=qkv[:, :, 1], v=qkv[:, :, 2],
                    dout=torch.zeros(b, h, s, d, dtype=torch.bfloat16).transpose(1, 2))
    if case == "pointer_16_bytes_in":
        return dict(q=torch.zeros(b * s * h * d + 8, dtype=torch.bfloat16)[8:].view(b, s, h, d))
    if case == "head_stride_40_bytes":
        return dict(k=torch.zeros(b, s, h, 20, dtype=torch.bfloat16)[..., :d])
    # the same 40-byte stride on a dim of length 1, which the kernels never step along
    return dict(k=torch.zeros(b * s * d, dtype=torch.bfloat16).as_strided((b, s, 1, d),
                                                                         (s * d, d, 20, 1)))


@pytest.mark.parametrize("case,raises", [("fused_qkv_views", False),
                                         ("pointer_16_bytes_in", False),
                                         ("head_stride_40_bytes", True),
                                         ("head_stride_40_bytes_one_head", False)])
def test_bf16_flash_backward_alignment_rule(case, raises):
    """The tensor-core backward stages tiles with 16-byte copies, so its wrappers refuse a
    bf16 operand whose pointer or (b, s, h) stride over a dim longer than 1 is not a
    multiple of 16 bytes. The rule reads only pointers and strides, so it is checked here
    on CPU tensors; the card tests check that the wrappers apply it."""
    operands = _bf16_operands(case) | dict(lse=torch.zeros(2, 2, 64),
                                           delta=torch.zeros(2, 2, 64))
    if raises:
        with pytest.raises(ValueError, match="k must be 16-byte aligned"):
            fa._check_aligned("flash_dkv", **operands)
    else:
        fa._check_aligned("flash_dkv", **operands)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this module's torch work: the suite runs several workers
    on the host's cores, and torch's default of one thread a core each oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
