"""GRU question/answer encoder (``vqatpu/ops/rnn.py:124-213``, GRU only).

The JAX package keeps torch's gate order (r, z, n) and bias layout, so its
``fwd`` / ``fwd_l{n}`` weights are exactly ``nn.GRU``'s ``*_l0`` / ``*_l{n}``
parameters.  The LSTM and bidirectional variants are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn


class QuestionEmbedding(nn.GRU):
    """``forward`` (JAX's ``apply_all``): every step's hidden state,
    [B, T, H]; :meth:`forward_last` (``apply_last``): the last one, [B, H]."""

    def __init__(self, in_dim: int, num_hid: int, nlayers: int = 1,
                 dropout: float = 0.0):
        super().__init__(in_dim, num_hid, num_layers=nlayers,
                         dropout=dropout, batch_first=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x)[0]

    def forward_last(self, x: torch.Tensor) -> torch.Tensor:
        return self(x)[:, -1]
