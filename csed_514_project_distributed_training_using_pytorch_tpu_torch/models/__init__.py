"""Model zoo: the reference's MNIST CNN and the transformer classifier family."""

import torch

from csed_514_project_distributed_training_using_pytorch_tpu_torch.models.cnn import (
    Net,
    param_count,
    params_from_jax,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models.transformer import (
    NUM_HEADS,
    TransformerClassifier,
    validate_remat_policy,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.ops.attention import (
    windowed_attention_fn,
)

VALID_MODELS = ("cnn", "transformer")


def validate_model_config(name: str, *, remat: bool = False, causal: bool = False,
                          attention_window: int = 0, kv_heads: int = 0,
                          rope: bool = False, remat_policy: str = "") -> None:
    """Fail fast on a bad model name or model/knob combination, with the JAX package's
    messages."""
    if name not in VALID_MODELS:
        raise ValueError(
            f"unknown model {name!r} — choose one of {', '.join(VALID_MODELS)}")
    if remat and name == "cnn":
        raise ValueError("--remat applies to the transformer family only "
                         "(the CNN's activations are a few hundred KB)")
    validate_remat_policy(remat, remat_policy)
    for flag, value in (("causal", causal), ("attention-window", attention_window),
                        ("kv-heads", kv_heads), ("rope", rope)):
        if value and name == "cnn":
            raise ValueError(f"--{flag} applies to the transformer family only")
    if attention_window < 0:
        raise ValueError(f"--attention-window must be >= 0, got {attention_window}")
    if kv_heads < 0:
        raise ValueError(f"--kv-heads must be >= 0, got {kv_heads}")
    if kv_heads and NUM_HEADS % kv_heads:
        raise ValueError(f"--kv-heads {kv_heads} must divide the transformer's "
                         f"{NUM_HEADS} heads")


def build_model(name: str, *, bf16: bool = False, remat: bool = False,
                causal: bool = False, attention_window: int = 0, kv_heads: int = 0,
                rope: bool = False, remat_policy: str = "", **widths):
    """Model factory behind the trainers' ``--model`` flag, mapping the knobs as the JAX
    package does: ``bf16`` becomes the activation dtype (of ``Net`` as well),
    ``attention_window`` the windowed dense core (``ops.attention.windowed_attention_fn``),
    ``kv_heads`` ``num_kv_heads``. The knobs are validated first
    (``validate_model_config``). ``widths`` go to the constructor unchanged (``seq_len``,
    ``dropout_rate``, ...)."""
    validate_model_config(name, remat=remat, causal=causal,
                          attention_window=attention_window, kv_heads=kv_heads,
                          rope=rope, remat_policy=remat_policy)
    dtype = torch.bfloat16 if bf16 else torch.float32
    if name == "cnn":
        return Net(dtype=dtype, **widths)
    if rope:
        widths["rope"] = True
    if kv_heads:
        widths["num_kv_heads"] = kv_heads
    if attention_window:
        widths["attention_fn"] = windowed_attention_fn(attention_window)
    return TransformerClassifier(dtype=dtype, remat=remat, causal=causal,
                                 remat_policy=remat_policy, **widths)


__all__ = ["Net", "TransformerClassifier", "VALID_MODELS", "build_model", "param_count",
           "params_from_jax", "validate_model_config", "validate_remat_policy"]
