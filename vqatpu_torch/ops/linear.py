"""Linear layers and the FCNet MLP stack (``vqatpu/ops/linear.py:27-130``).

:class:`Linear` is a plain ``nn.Linear`` with the JAX tree's leaf names
``w`` and ``b`` (SAN's attention and heads), :class:`FCSTL` the single
``Dropout -> Linear -> Tanh`` layer.

``weight_norm(nn.Linear, dim=None)`` reparameterizes the whole weight by its
Frobenius norm, ``W = g * v / ||v||_F`` with a scalar ``g``.  The parameters
are stored as ``v``, ``g`` and ``b``, the names of the JAX param tree.

Under ``compute_dtype="bfloat16"`` the weight norm is taken in the
parameters' dtype (``vqatpu/ops/linear.py:55``), and a float32 input
against bf16 weights is promoted to float32, as jnp promotes ``x @ v.T``
(``:56``).

:class:`WNLinear`'s product is
:func:`~vqatpu_torch.kernels.linear.routed_linear`: the split-bf16 GEMM of
``csrc/linear_f32.cu`` for large float32 products on the card, else
``F.linear``.

Under tensor parallelism :class:`WNLinear` runs column- or row-parallel
(see its docstring), and :class:`FCNet` drops out a row-parallel layer's
split input with the whole input's mask.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vqatpu_torch.kernels.linear import routed_linear
from vqatpu_torch.numerics import promote
from vqatpu_torch.ops.activation import get_activation
from vqatpu_torch.ops.module import Ctx, dropout
from vqatpu_torch.parallel.collectives import (all_reduce_both, copy_to,
                                               reduce_from)


def frobenius(v: torch.Tensor, dim=None) -> torch.Tensor:
    """``sqrt(sum(v**2))`` over ``dim`` (all of ``v`` by default).  Not
    ``Tensor.norm``: on the CPU that loses about 2.5e-5 of a 2M-element
    float32 weight's norm, which moves every weight-normed layer by as much,
    where a plain sum stays within 1e-7."""
    return v.square().sum(dim).sqrt()


def uniform_(t: torch.Tensor, bound: float) -> torch.Tensor:
    """U(-bound, bound) in place: torch's default Linear/RNN init family."""
    with torch.no_grad():
        return t.uniform_(-bound, bound)


class WNLinear(nn.Module):
    """``weight_norm(nn.Linear(in_dim, out_dim), dim=None)``.

    Under tensor parallelism (``tp``, the model group, set by
    :func:`vqatpu_torch.parallel.sharding.shard_model`) ``v`` is a slice:
    ``tp_dim=0`` column-parallel (``v``, ``b`` split on the output dim; the
    input enters by ``copy_to``, the output stays split), ``tp_dim=1``
    row-parallel (``v`` split on the input dim; the partial products are
    summed by ``reduce_from`` before the scale and the bias).  The norm is
    always the whole matrix's, as JAX's ``weight_norm(dim=None)`` over a
    sharded ``v`` is: ``||v||^2`` is summed over the group.  The replicated
    ``g`` of a column-parallel layer enters by ``copy_to``, so that its
    gradient, a partial sum on each rank, is summed too."""

    tp = None
    tp_dim = None

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True):
        super().__init__()
        bound = 1.0 / (in_dim ** 0.5)
        self.v = nn.Parameter(uniform_(torch.empty(out_dim, in_dim), bound))
        self.g = nn.Parameter(frobenius(self.v.detach()))
        self.b = (nn.Parameter(uniform_(torch.empty(out_dim), bound))
                  if bias else None)

    def input_shard(self) -> Optional[Tuple[int, int]]:
        """``(n, i)`` where the input is split over the model group (a
        row-parallel layer), else None."""
        if self.tp is None or self.tp_dim != 1:
            return None
        return self.tp.size, self.tp.index

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # (x @ vᵀ)·s rather than x @ (s·v)ᵀ, as the JAX package does: the
        # scale multiplies the GEMM output and no scaled weight is formed
        if self.tp is None:
            y = routed_linear(*promote(x, self.v)) * (self.g / frobenius(self.v))
        elif self.tp_dim == 0:
            sq = all_reduce_both(self.v.square().sum(), self.tp)
            y = (routed_linear(*promote(copy_to(x, self.tp), self.v))
                 * (copy_to(self.g, self.tp) / sq.sqrt()))
        else:
            sq = reduce_from(self.v.square().sum(), self.tp)
            y = (reduce_from(routed_linear(*promote(x, self.v)), self.tp)
                 * (self.g / sq.sqrt()))
        if self.b is not None:
            y = y + self.b
        return y


class Linear(nn.Module):
    """Plain ``nn.Linear``, its leaves ``w`` [out, in] and ``b`` [out]."""

    def __init__(self, in_dim: int, out_dim: int, bias: bool = True):
        super().__init__()
        bound = 1.0 / (in_dim ** 0.5)
        self.w = nn.Parameter(uniform_(torch.empty(out_dim, in_dim), bound))
        self.b = (nn.Parameter(uniform_(torch.empty(out_dim), bound))
                  if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(*promote(x, self.w))
        return y if self.b is None else y + self.b


class FCSTL(nn.Module):
    """``Dropout -> Linear -> Tanh`` (reference ``fc.py:36-44``), the
    linear at ``l0``."""

    def __init__(self, in_dim: int, out_dim: int, dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.l0 = Linear(in_dim, out_dim)

    def forward(self, x: torch.Tensor,
                ctx: Optional[Ctx] = None) -> torch.Tensor:
        return torch.tanh(self.l0(dropout(x, self.dropout, ctx)))


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

    def forward(self, x: torch.Tensor,
                ctx: Optional[Ctx] = None) -> torch.Tensor:
        act = get_activation(self.act)
        for i in range(len(self.dims) - 1):
            layer = getattr(self, f"l{i}")
            x = dropout(x, self.dropout, ctx, layer.input_shard())
            x = act(layer(x))
        return x
