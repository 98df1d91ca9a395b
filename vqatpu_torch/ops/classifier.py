"""Answer classifier (``vqatpu/ops/classifier.py:17-36``):
``WNLinear(in, hid) -> act -> Dropout -> WNLinear(hid, out)``; under
tensor parallelism ``l2`` may be split on the vocabulary, and its logits
are gathered."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vqatpu_torch.ops.activation import get_activation
from vqatpu_torch.ops.linear import WNLinear
from vqatpu_torch.ops.module import Ctx, dropout
from vqatpu_torch.parallel.collectives import gather_from


class SimpleClassifier(nn.Module):
    def __init__(self, in_dim: int, hid_dim: int, out_dim: int,
                 activation: str = "relu", dropout: float = 0.5):
        super().__init__()
        self.activation = activation
        self.dropout = dropout
        self.l1 = WNLinear(in_dim, hid_dim)
        self.l2 = WNLinear(hid_dim, out_dim)

    def forward(self, x: torch.Tensor,
                ctx: Optional[Ctx] = None) -> torch.Tensor:
        h = get_activation(self.activation)(self.l1(x))
        # a vocab-split l2 (tensor parallelism, where the vocabulary divides
        # the group) gives this rank's columns: gathered before the loss
        return gather_from(self.l2(dropout(h, self.dropout, ctx)),
                           self.l2.tp)
