"""Box masks, the NaN-safe masked softmax and trilinear attention
(``vqatpu/ops/attention.py:25-40, 96-144``)."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from vqatpu_torch.kernels.trilinear import fused_rank_softmax, precontract_qa
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
    """TCNet rank projections, then the fused rank-contraction + masked
    softmax kernel over V*Q*A per glimpse: att [B, V, Q, A, G].  The
    attention logits are never formed (the JAX package's
    ``apply(..., return_logits=False)`` under ``kernel_backend="pallas"``)."""

    def __init__(self, v_dim: int, q_dim: int, a_dim: int, h_dim: int,
                 h_out: int, rank: int, glimpse: int, k: int,
                 dropout: Tuple[float, float] = (0.2, 0.5)):
        super().__init__()
        self.tc = TCNet(v_dim, q_dim, a_dim, h_dim, h_out, rank, glimpse,
                        dropout=dropout, k=k)

    def forward(self, v, q, a, v_mask=None) -> torch.Tensor:
        if v_mask is None:
            v_mask = box_mask_from_features(v)
        v_r, q_r, a_r, T = self.tc.rank_projections(v, q, a)
        return fused_rank_softmax(v_r, precontract_qa(q_r, a_r, T), v_mask)
