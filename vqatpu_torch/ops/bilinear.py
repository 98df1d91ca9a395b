"""Bilinear connect network, BAN's core op (``vqatpu/ops/bilinear.py:34-133``,
reference ``src/bc.py``).

Shapes: ``v`` [B, V, v_dim], ``q`` [B, Q, q_dim]; the hidden width is
``d = h_dim * k``.  ``h_out`` picks the regime (``bc.py:42-68``):

- ``None``: the joint embedding ``einsum("bvd,bqd->bd")`` as [B, 1, d];
- ``<= 32``: attention logits from the learned ``h_mat`` [1, G, 1, d] and
  ``h_bias`` [1, G, 1, 1], [B, G, V, Q] (:meth:`BCNet.forward`) or in the
  V-minor [B, G, Q, V] layout (:meth:`BCNet.apply_qv`);
- ``> 32``: ``h_net`` (a weight-normed linear) over the [B, V, Q, d] map.

Dropout fires in JAX's order: ``v_net`` and ``q_net`` at ``dropout[0]`` on
their inputs, then ``dropout[1]`` on ``v_`` in the attention regimes.
:meth:`BCNet.apply_with_weights` and ``apply_with_weights_qv`` are the
attention-weighted bilinear pooling with k-fold sum pooling
(``bc.py:70-78``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from vqatpu_torch.numerics import promote
from vqatpu_torch.ops.linear import FCNet, WNLinear
from vqatpu_torch.ops.module import Ctx, dropout

ATT_REGIME_MAX = 32  # reference ``self.c`` (bc.py:22)


class BCNet(nn.Module):
    def __init__(self, v_dim: int, q_dim: int, h_dim: int,
                 h_out: Optional[int], act: str = "ReLU",
                 dropout: Tuple[float, float] = (0.2, 0.5), k: int = 1):
        super().__init__()
        self.h_dim, self.h_out, self.k = h_dim, h_out, k
        self.dropout = tuple(dropout)
        d = h_dim * k
        self.v_net = FCNet((v_dim, d), act, self.dropout[0])
        self.q_net = FCNet((q_dim, d), act, self.dropout[0])
        if h_out is not None and h_out <= ATT_REGIME_MAX:
            self.h_mat = nn.Parameter(torch.randn(1, h_out, 1, d))
            self.h_bias = nn.Parameter(torch.randn(1, h_out, 1, 1))
        elif h_out is not None:
            self.h_net = WNLinear(d, h_out)

    def _operands(self, v, q, ctx):
        """``v_net(v)``, ``q_net(q)`` and, in the attention regimes,
        ``dropout[1]`` on ``v_``, in JAX's order."""
        v_ = self.v_net(v, ctx)
        q_ = self.q_net(q, ctx)
        if self.h_out is not None:
            v_ = dropout(v_, self.dropout[1], ctx)
        return promote(v_, q_)

    def _h(self, h_mat):
        if self.h_out is None or self.h_out > ATT_REGIME_MAX:
            raise ValueError("the attention logits need h_out <= "
                             f"{ATT_REGIME_MAX}, not {self.h_out}")
        return (self.h_mat if h_mat is None else h_mat)[0, :, 0, :]  # [G, d]

    def forward(self, v: torch.Tensor, q: torch.Tensor,
                ctx: Optional[Ctx] = None,
                h_mat: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, 1, d] (``h_out=None``) or [B, h_out, V, Q] logits.  ``h_mat``
        replaces the stored one: :class:`~vqatpu_torch.ops.attention.
        BiAttention`'s weight norm."""
        v_, q_ = self._operands(v, q, ctx)
        if self.h_out is None:
            return torch.einsum("bvd,bqd->bd", v_, q_)[:, None, :]
        if self.h_out > ATT_REGIME_MAX:
            joint = v_[:, :, None, :] * q_[:, None, :, :]  # [B, V, Q, d]
            return self.h_net(joint).permute(0, 3, 1, 2)
        v_, h, q_ = promote(v_, self._h(h_mat), q_)
        vh = v_[:, None] * h[None, :, None, :]  # [B, G, V, d]
        return vh @ q_[:, None].transpose(-1, -2) + self.h_bias

    def apply_qv(self, v: torch.Tensor, q: torch.Tensor,
                 ctx: Optional[Ctx] = None,
                 h_mat: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Attention-regime logits in the V-minor [B, G, Q, V] layout: the
        values of :meth:`forward` transposed."""
        h = self._h(h_mat)
        v_, q_ = self._operands(v, q, ctx)
        q_, h, v_ = promote(q_, h, v_)
        qh = q_[:, None] * h[None, :, None, :]  # [B, G, Q, d]
        return qh @ v_[:, None].transpose(-1, -2) + self.h_bias

    def _sum_pool(self, logits: torch.Tensor) -> torch.Tensor:
        if self.k > 1:
            logits = logits.unflatten(1, (self.h_dim, self.k)).sum(-1)
        return logits

    def apply_with_weights(self, v: torch.Tensor, q: torch.Tensor,
                           w: torch.Tensor,
                           ctx: Optional[Ctx] = None) -> torch.Tensor:
        """``v^T w q`` pooling with ``w`` [B, V, Q] -> [B, h_dim]."""
        v_ = self.v_net(v, ctx)
        q_ = self.q_net(q, ctx)
        v_, w, q_ = promote(v_, w, q_)
        return self._sum_pool(torch.einsum("bvd,bvq,bqd->bd", v_, w, q_))

    def apply_with_weights_qv(self, v: torch.Tensor, q: torch.Tensor,
                              w_qv: torch.Tensor,
                              ctx: Optional[Ctx] = None) -> torch.Tensor:
        """As :meth:`apply_with_weights` with ``w_qv`` [B, Q, V], one glimpse
        of the V-minor layout: ``(w_qv @ v_) * q_`` summed over Q."""
        v_ = self.v_net(v, ctx)
        q_ = self.q_net(q, ctx)
        wv = torch.bmm(*promote(w_qv, v_))  # [B, Q, d]
        return self._sum_pool((wv * q_).sum(1))
