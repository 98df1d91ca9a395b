"""Compact Trilinear interaction, ``TCNet`` (``vqatpu/ops/trilinear.py:75-248``).

Tucker FCNets project v, q and a to ``d = h_dim * k``.  In the attention
regime (``d < 1024`` and not ``joint_only``) stacked per-rank nets project
each to [rank, h_sub], and the PARALIND core ``T_g`` joins them;
:meth:`TCNet.apply_with_weights` is the weighted trilinear pool that the
CTI joint embedding uses.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vqatpu_torch.kernels.trilinear import trilinear_pool
from vqatpu_torch.ops.activation import get_activation
from vqatpu_torch.ops.linear import FCNet, uniform_
from vqatpu_torch.ops.module import dropout

RANK_NET_GATE = 1024  # reference `if self.h_dim < 1024` (tc.py:27)


class _RankLinear(nn.Module):
    """``rank`` weight-normed linears [d -> h_sub] stacked: ``v`` [R, h_sub,
    d], ``g`` [R], ``b`` [R, h_sub] (the JAX package's vmapped FCNet)."""

    def __init__(self, rank: int, d: int, h_sub: int):
        super().__init__()
        bound = 1.0 / (d ** 0.5)
        self.v = nn.Parameter(uniform_(torch.empty(rank, h_sub, d), bound))
        self.g = nn.Parameter(self.v.detach().flatten(1).norm(dim=1))
        self.b = nn.Parameter(uniform_(torch.empty(rank, h_sub), bound))


class RankNets(nn.Module):
    """All rank nets of one stream as ONE [d, rank*h_sub] GEMM, with the
    per-rank Frobenius scales applied to the output columns
    (``vqatpu/ops/trilinear.py:143-185``, the fused branch): x [B, N, d] ->
    [B, N, rank, h_sub]."""

    def __init__(self, rank: int, d: int, h_sub: int, act: str, drop: float):
        super().__init__()
        self.act = act
        self.drop = drop
        self.l0 = _RankLinear(rank, d, h_sub)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.l0
        R, h_sub, d = p.v.shape
        scale = (p.g / p.v.flatten(1).norm(dim=1)).repeat_interleave(h_sub)
        x = dropout(x, self.drop, self.training)
        out = get_activation(self.act)(
            F.linear(x, p.v.reshape(R * h_sub, d)) * scale + p.b.reshape(-1))
        return out.reshape(*x.shape[:-1], R, h_sub)


class TCNet(nn.Module):
    def __init__(self, v_dim: int, q_dim: int, a_dim: int, h_dim: int,
                 h_out: int, rank: int, glimpse: int, act: str = "ReLU",
                 dropout: Tuple[float, float] = (0.2, 0.5), k: int = 1,
                 joint_only: bool = False):
        super().__init__()
        self.rank = rank
        self.d = h_dim * k
        self.h_sub = h_dim // rank
        self.ho_dim = h_out // rank if h_out > 1 else h_out
        self.has_rank_nets = (not joint_only) and self.d < RANK_NET_GATE
        self.v_tucker = FCNet((v_dim, self.d), act, dropout[1])
        self.q_tucker = FCNet((q_dim, self.d), act, dropout[0])
        self.a_tucker = FCNet((a_dim, self.d), act, dropout[0])
        if self.has_rank_nets:
            self.v_net = RankNets(rank, self.d, self.h_sub, act, dropout[1])
            self.q_net = RankNets(rank, self.d, self.h_sub, act, dropout[0])
            self.a_net = RankNets(rank, self.d, self.h_sub, act, dropout[0])
            h = self.h_sub
            self.T_g = nn.Parameter(
                torch.randn(rank, h, h, h, glimpse, self.ho_dim))

    def rank_projections(self, v, q, a):
        """-> (v_r [B,V,R,x], q_r, a_r, T [R,x,y,z,G]), the operands of the
        PARALIND contraction."""
        if not self.has_rank_nets:
            raise ValueError("rank projections need the rank-net regime")
        v_r = self.v_net(self.v_tucker(v))
        q_r = self.q_net(self.q_tucker(q))
        a_r = self.a_net(self.a_tucker(a))
        T = self.T_g[..., 0] if self.ho_dim == 1 else self.T_g.sum(-1)
        return v_r, q_r, a_r, T

    def apply_with_weights(self, v, q, a, w) -> torch.Tensor:
        """Joint embedding with attention ``w`` [B, V, Q, A] -> [B, d]
        (``tc.py:54-61``), through the trilinear pool kernel."""
        return trilinear_pool(self.v_tucker(v), self.q_tucker(q),
                              self.a_tucker(a), w)
