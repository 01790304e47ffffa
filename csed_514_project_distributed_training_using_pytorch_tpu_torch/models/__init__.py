"""Model zoo: the reference's MNIST CNN (the transformer family comes with the LM slice)."""

from csed_514_project_distributed_training_using_pytorch_tpu_torch.models.cnn import (
    Net,
    param_count,
    params_from_jax,
)


def build_model(name: str) -> Net:
    """Model factory by family name, as the JAX package's ``--model`` names them; only the
    CNN is ported."""
    if name == "cnn":
        return Net()
    raise ValueError(f"unknown model {name!r} — this port implements only 'cnn'")


__all__ = ["Net", "build_model", "param_count", "params_from_jax"]
