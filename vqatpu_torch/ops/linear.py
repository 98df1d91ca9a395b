"""Weight-normalized linear layers and the FCNet MLP stack
(``vqatpu/ops/linear.py:27-59, 102-130``).

``weight_norm(nn.Linear, dim=None)`` reparameterizes the whole weight by its
Frobenius norm, ``W = g * v / ||v||_F`` with a scalar ``g``.  The parameters
are stored as ``v``, ``g`` and ``b``, the names of the JAX param tree.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from vqatpu_torch.ops.activation import get_activation
from vqatpu_torch.ops.module import dropout


def uniform_(t: torch.Tensor, bound: float) -> torch.Tensor:
    """U(-bound, bound) in place: torch's default Linear/RNN init family."""
    with torch.no_grad():
        return t.uniform_(-bound, bound)


class WNLinear(nn.Module):
    """``weight_norm(nn.Linear(in_dim, out_dim), dim=None)``."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True):
        super().__init__()
        bound = 1.0 / (in_dim ** 0.5)
        self.v = nn.Parameter(uniform_(torch.empty(out_dim, in_dim), bound))
        self.g = nn.Parameter(self.v.detach().norm())
        self.b = (nn.Parameter(uniform_(torch.empty(out_dim), bound))
                  if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # (x @ vᵀ)·s rather than x @ (s·v)ᵀ, as the JAX package does: the
        # scale multiplies the GEMM output and no scaled weight is formed
        y = F.linear(x, self.v) * (self.g / self.v.norm())
        if self.b is not None:
            y = y + self.b
        return y


class FCNet(nn.Module):
    """``[Dropout, WNLinear, Act]`` per layer (reference ``fc.py:10-34``);
    layers are named ``l0``, ``l1``, ... as in the JAX tree."""

    def __init__(self, dims: Sequence[int], act: str = "ReLU",
                 dropout: float = 0.0):
        super().__init__()
        self.dims = tuple(dims)
        self.act = act
        self.dropout = dropout
        for i in range(len(self.dims) - 1):
            self.add_module(f"l{i}", WNLinear(self.dims[i], self.dims[i + 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = get_activation(self.act)
        for i in range(len(self.dims) - 1):
            x = dropout(x, self.dropout, self.training)
            x = act(getattr(self, f"l{i}")(x))
        return x
