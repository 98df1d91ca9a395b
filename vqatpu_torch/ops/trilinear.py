"""Compact Trilinear interaction, ``TCNet`` (``vqatpu/ops/trilinear.py:75-248``).

Tucker FCNets project v, q and a to ``d = h_dim * k``.  In the attention
regime (``d < 1024`` and not ``joint_only``) stacked per-rank nets project
each to [rank, h_sub], and the PARALIND core ``T_g`` joins them.
:meth:`TCNet.forward` gives the attention logits [B, V, Q, A, G], and
:meth:`TCNet.apply_with_weights` is the weighted trilinear pool that the CTI
joint embedding uses.  Every method takes the training context ``ctx``
(:mod:`vqatpu_torch.ops.module`), None at eval.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vqatpu_torch.kernels.trilinear import attention_logits_ref, trilinear_pool
from vqatpu_torch.numerics import promote
from vqatpu_torch.ops.activation import get_activation
from vqatpu_torch.ops.linear import FCNet, frobenius, uniform_
from vqatpu_torch.ops.module import Ctx, dropout

RANK_NET_GATE = 1024  # reference `if self.h_dim < 1024` (tc.py:27)


class _RankLinear(nn.Module):
    """``rank`` weight-normed linears [d -> h_sub] stacked: ``v`` [R, h_sub,
    d], ``g`` [R], ``b`` [R, h_sub] (the JAX package's vmapped FCNet)."""

    def __init__(self, rank: int, d: int, h_sub: int):
        super().__init__()
        bound = 1.0 / (d ** 0.5)
        self.v = nn.Parameter(uniform_(torch.empty(rank, h_sub, d), bound))
        self.g = nn.Parameter(frobenius(self.v.detach().flatten(1), 1))
        self.b = nn.Parameter(uniform_(torch.empty(rank, h_sub), bound))


class RankNets(nn.Module):
    """All rank nets of one stream as ONE [d, rank*h_sub] GEMM, with the
    per-rank Frobenius scales applied to the output columns
    (``vqatpu/ops/trilinear.py:143-185``): x [B, N, d] -> [B, N, rank,
    h_sub].  Dropout draws one mask that all ranks share, as the JAX
    package does.  Under injected masks (``ctx.mask_source``) each rank
    takes its own mask, in rank order (``vqatpu/ops/trilinear.py:169-177``).
    """

    def __init__(self, rank: int, d: int, h_sub: int, act: str, drop: float):
        super().__init__()
        self.act = act
        self.drop = drop
        self.l0 = _RankLinear(rank, d, h_sub)

    def forward(self, x: torch.Tensor,
                ctx: Optional[Ctx] = None) -> torch.Tensor:
        p = self.l0
        R, h_sub, d = p.v.shape
        act = get_activation(self.act)
        scale = p.g / frobenius(p.v.flatten(1), 1)
        if ctx is not None and ctx.mask_source is not None:
            return torch.stack([
                act(F.linear(*promote(dropout(x, self.drop, ctx), p.v[r]))
                    * scale[r] + p.b[r]) for r in range(R)], dim=-2)
        x = dropout(x, self.drop, ctx)
        out = act(F.linear(*promote(x, p.v.reshape(R * h_sub, d)))
                  * scale.repeat_interleave(h_sub) + p.b.reshape(-1))
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

    def rank_projections(self, v, q, a, ctx: Optional[Ctx] = None):
        """-> (v_r [B,V,R,x], q_r, a_r, T [R,x,y,z,G]), the operands of the
        PARALIND contraction.  Dropout fires in the JAX order: the three
        tuckers, then the three rank nets."""
        if not self.has_rank_nets:
            raise ValueError("rank projections need the rank-net regime")
        v_t = self.v_tucker(v, ctx)
        q_t = self.q_tucker(q, ctx)
        a_t = self.a_tucker(a, ctx)
        v_r = self.v_net(v_t, ctx)
        q_r = self.q_net(q_t, ctx)
        a_r = self.a_net(a_t, ctx)
        T = self.T_g[..., 0] if self.ho_dim == 1 else self.T_g.sum(-1)
        return v_r, q_r, a_r, T

    def forward(self, v, q, a, ctx: Optional[Ctx] = None) -> torch.Tensor:
        """Attention logits [B, V, Q, A, G] (``vqatpu/ops/trilinear.py:
        205-215``) through the plain einsum chain."""
        return attention_logits_ref(*self.rank_projections(v, q, a, ctx))

    def apply_with_weights(self, v, q, a, w,
                           ctx: Optional[Ctx] = None) -> torch.Tensor:
        """Joint embedding with attention ``w`` [B, V, Q, A] -> [B, d]
        (``tc.py:54-61``), through the trilinear pool kernel.  At bf16
        compute ``v`` and the weights are bf16, ``q`` and ``a`` bf16 at
        the first glimpse and float32 after it; the pool is float32."""
        return trilinear_pool(self.v_tucker(v, ctx), self.q_tucker(q, ctx),
                              self.a_tucker(a, ctx), w)
