"""Box masks, the NaN-safe masked softmax, and the bilinear, trilinear and
stacked attentions (``vqatpu/ops/attention.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from vqatpu_torch.kernels.trilinear import (fused_rank_softmax,
                                            masked_softmax_vqa, precontract_qa)
from vqatpu_torch.numerics import promote
from vqatpu_torch.ops.bilinear import BCNet
from vqatpu_torch.ops.linear import Linear, frobenius
from vqatpu_torch.ops.module import Ctx, dropout
from vqatpu_torch.ops.trilinear import TCNet


def box_mask_from_features(v: torch.Tensor) -> torch.Tensor:
    """True for real boxes, [B, V]: a padded box is all zeros."""
    return v.abs().sum(-1) != 0


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor,
                   axes) -> torch.Tensor:
    """Softmax over (flattened) ``axes`` with False-masked entries at -inf;
    a fully masked slice gives zeros instead of NaN."""
    neg = logits.masked_fill(~mask, float("-inf"))
    m = neg.amax(dim=axes, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.where(mask, torch.exp(neg - m), torch.zeros_like(neg))
    return e / e.sum(dim=axes, keepdim=True).clamp_min(1e-30)


class BiAttention(nn.Module):
    """BCNet(k=3, h_out=glimpse) whose ``h_mat`` is weight-normed with
    ``dim=None``, ``h_mat_g / ||h_mat||_F * h_mat``, and a masked softmax
    over the flattened (V, Q) grid per glimpse (``vqatpu/ops/attention.py:
    43-93``, reference ``attention.py:15-40``), in the V-minor layout
    ``BanModel`` uses."""

    def __init__(self, x_dim: int, y_dim: int, z_dim: int, glimpse: int,
                 dropout: Tuple[float, float] = (0.2, 0.5)):
        super().__init__()
        self.bc = BCNet(x_dim, y_dim, z_dim, glimpse, dropout=dropout, k=3)
        self.h_mat_g = nn.Parameter(frobenius(self.bc.h_mat.detach()))

    def _h_mat(self) -> torch.Tensor:
        h_v = self.bc.h_mat
        return (self.h_mat_g / frobenius(h_v)) * h_v

    def apply_gqv(self, v, q, v_mask=None, ctx: Optional[Ctx] = None):
        """-> (att, masked logits), both [B, G, Q, V], the logits of
        padded boxes at -inf."""
        if v_mask is None:
            v_mask = box_mask_from_features(v)
        logits = self.bc.apply_qv(v, q, ctx, h_mat=self._h_mat())
        mask = v_mask[:, None, None, :]
        att = masked_softmax(logits, mask, axes=(2, 3))
        return att, logits.masked_fill(~mask, float("-inf"))


class TriAttention(nn.Module):
    """TCNet rank projections, then a masked softmax over V*Q*A per
    glimpse: att [B, V, Q, A, G].

    ``forward(..., return_logits=False)`` runs the fused rank-contraction
    + softmax kernel (K1), never forms the logits and returns ``(att,
    None)``: the model's path.  ``return_logits=True`` forms the logits
    with the plain einsum chain, runs the masked softmax kernel (K3) and
    returns ``(att, masked_logits)`` with masked boxes at -inf, as the JAX
    package's ``apply`` does under ``kernel_backend="pallas"``.  The JAX
    default is ``return_logits=True``; the port's is False, the serving
    path."""

    def __init__(self, v_dim: int, q_dim: int, a_dim: int, h_dim: int,
                 h_out: int, rank: int, glimpse: int, k: int,
                 dropout: Tuple[float, float] = (0.2, 0.5)):
        super().__init__()
        self.tc = TCNet(v_dim, q_dim, a_dim, h_dim, h_out, rank, glimpse,
                        dropout=dropout, k=k)

    def forward(self, v, q, a, v_mask=None, ctx: Optional[Ctx] = None,
                return_logits: bool = False):
        if v_mask is None:
            v_mask = box_mask_from_features(v)
        if not return_logits:
            v_r, q_r, a_r, T = self.tc.rank_projections(v, q, a, ctx)
            att = fused_rank_softmax(v_r, precontract_qa(q_r, a_r, T), v_mask)
            return att, None
        logits = self.tc(v, q, a, ctx)
        att = masked_softmax_vqa(logits, v_mask)
        mask5 = v_mask[:, :, None, None, None]
        return att, logits.masked_fill(~mask5, float("-inf"))


class StackedAttention(nn.Module):
    """Classic SAN: ``num_stacks`` rounds of tanh-add attention
    (``vqatpu/ops/attention.py:164-232``, reference ``attention.py:62-152``).
    Each round's head is a matvec to [B, V] logits.  The boxes are masked
    where the round's image projection (``fc12`` and ``w{s}_i``, no bias)
    is an all-zero row, as the reference does, not by the batch's
    ``v_mask``."""

    def __init__(self, num_stacks: int, img_feat_size: int,
                 ques_feat_size: int, att_size: int, drop_ratio: float):
        super().__init__()
        self.num_stacks = num_stacks
        self.drop_ratio = drop_ratio
        self.fc11 = Linear(ques_feat_size, att_size)
        self.fc12 = Linear(img_feat_size, att_size, bias=False)
        self.fc13 = Linear(att_size, 1)
        self.fc14 = Linear(ques_feat_size, att_size)
        self.fc15 = Linear(img_feat_size, att_size, bias=False)
        for s in range(num_stacks - 1):
            self.add_module(f"w{s}_q", Linear(att_size, att_size))
            self.add_module(f"w{s}_i", Linear(img_feat_size, att_size,
                                              bias=False))
            self.add_module(f"w{s}_h", Linear(att_size, 1))

    def _round(self, head: Linear, h, img_emb, ctx):
        """Attention weights [B, V] of one round."""
        h = dropout(h, self.drop_ratio, ctx)
        h, w = promote(h, head.w[0])
        logits = h @ w + head.b[0]
        return masked_softmax(logits, img_emb.abs().sum(-1) != 0, axes=(1,))

    @staticmethod
    def _pool(p, img_emb):
        p, img_emb = promote(p, img_emb)
        return torch.bmm(p[:, None, :], img_emb)[:, 0]  # [B, att_size]

    def forward(self, img_feat: torch.Tensor, ques_feat: torch.Tensor,
                ctx: Optional[Ctx] = None) -> torch.Tensor:
        """``img_feat`` [B, V, img_dim], ``ques_feat`` [B, ques_dim] ->
        [B, att_size]."""
        ques_emb = self.fc11(ques_feat)
        img_emb = self.fc12(img_feat)
        p1 = self._round(self.fc13, torch.tanh(ques_emb[:, None, :] + img_emb),
                         img_emb, ctx)
        img_emb_1 = self.fc15(img_feat)
        u = self.fc14(ques_feat) + self._pool(p1, img_emb_1)
        for s in range(self.num_stacks - 1):
            q_s = getattr(self, f"w{s}_q")(u)
            i_s = getattr(self, f"w{s}_i")(img_feat)
            p_s = self._round(getattr(self, f"w{s}_h"),
                              torch.tanh(q_s[:, None, :] + i_s), i_s, ctx)
            u = u + self._pool(p_s, i_s)
        return u
