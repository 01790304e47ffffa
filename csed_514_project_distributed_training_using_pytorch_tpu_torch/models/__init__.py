"""Model zoo: the reference's MNIST CNN and the transformer classifier family."""

from csed_514_project_distributed_training_using_pytorch_tpu_torch.models.cnn import (
    Net,
    param_count,
    params_from_jax,
)
from csed_514_project_distributed_training_using_pytorch_tpu_torch.models.transformer import (
    NUM_HEADS,
    TransformerClassifier,
)

VALID_MODELS = ("cnn", "transformer")


def validate_model_config(name: str, *, remat: bool = False, causal: bool = False,
                          attention_window: int = 0, kv_heads: int = 0,
                          rope: bool = False) -> None:
    """Fail fast on a bad model name or model/knob combination, with the JAX package's
    messages; ``remat`` is not ported yet."""
    if name not in VALID_MODELS:
        raise ValueError(
            f"unknown model {name!r} — choose one of {', '.join(VALID_MODELS)}")
    if remat:
        raise ValueError("--remat is not ported yet (ROADMAP A10)")
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


def build_model(name: str, **kwargs):
    """Model factory by family name, as the JAX package's ``--model`` names them:
    ``"cnn"`` -> ``Net()``; ``"transformer"`` -> ``TransformerClassifier(**kwargs)``."""
    validate_model_config(name)
    if name == "cnn":
        return Net(**kwargs)
    return TransformerClassifier(**kwargs)


__all__ = ["Net", "TransformerClassifier", "VALID_MODELS", "build_model", "param_count",
           "params_from_jax", "validate_model_config"]
