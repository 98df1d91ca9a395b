"""Answer classifier (``vqatpu/ops/classifier.py:17-36``):
``WNLinear(in, hid) -> act -> Dropout -> WNLinear(hid, out)``."""

from __future__ import annotations

import torch
from torch import nn

from vqatpu_torch.ops.activation import get_activation
from vqatpu_torch.ops.linear import WNLinear
from vqatpu_torch.ops.module import dropout


class SimpleClassifier(nn.Module):
    def __init__(self, in_dim: int, hid_dim: int, out_dim: int,
                 activation: str = "relu", dropout: float = 0.5):
        super().__init__()
        self.activation = activation
        self.dropout = dropout
        self.l1 = WNLinear(in_dim, hid_dim)
        self.l2 = WNLinear(hid_dim, out_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = get_activation(self.activation)(self.l1(x))
        return self.l2(dropout(h, self.dropout, self.training))
