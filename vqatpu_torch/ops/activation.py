"""Activation functions by name (``vqatpu/ops/activation.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def swish(x: torch.Tensor) -> torch.Tensor:
    """Swish = x * sigmoid(x) (arXiv:1710.05941)."""
    return x * torch.sigmoid(x)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


_ACTS = {
    "": _identity,
    "none": _identity,
    "ReLU": torch.relu,
    "relu": torch.relu,
    "Tanh": torch.tanh,
    "tanh": torch.tanh,
    "Sigmoid": torch.sigmoid,
    "sigmoid": torch.sigmoid,
    "LeakyReLU": F.leaky_relu,
    "GELU": _gelu_tanh,
    "Swish": swish,
    "swish": swish,
}


def get_activation(name: str):
    try:
        return _ACTS[name]
    except KeyError:
        raise ValueError(f"activation {name!r} is not supported") from None
