"""Box masks, the NaN-safe masked softmax and trilinear attention
(``vqatpu/ops/attention.py:25-40, 96-144``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from vqatpu_torch.kernels.trilinear import (fused_rank_softmax,
                                            masked_softmax_vqa, precontract_qa)
from vqatpu_torch.ops.module import Ctx
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
