"""GRU and LSTM question/answer encoders (``vqatpu/ops/rnn.py:124-213``,
reference ``language_model.py:50-98``).

The JAX package keeps torch's gate orders (GRU r, z, n; LSTM i, f, g, o)
and bias layout, so its ``fwd`` / ``bwd`` / ``fwd_l{n}`` / ``bwd_l{n}``
weights are exactly ``nn.GRU``'s / ``nn.LSTM``'s ``*_l0`` / ``*_l0_reverse``
/ ``*_l{n}`` / ``*_l{n}_reverse`` parameters, which
:class:`QuestionEmbedding` (an ``nn.RNNBase``) holds under those names.
A layer, both directions, is one cuDNN call on the card (``torch.gru`` /
``torch.lstm``, what ``nn.GRU`` / ``nn.LSTM`` call).  With ``nlayers > 1``
the layers run one by one, and the port's
:func:`~vqatpu_torch.ops.module.dropout` from the training context falls
between them (on every layer's output but the last, torch's ``dropout=``
placement): ``nn.GRU(dropout=...)`` would draw from torch's global
generator, where no mask can be injected.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vqatpu_torch.ops.module import Ctx, dropout


class QuestionEmbedding(nn.RNNBase):
    """``forward`` (JAX's ``apply_all``): every step's hidden state, [B, T,
    H * directions]; :meth:`forward_last` (``apply_last``): the forward
    direction's last state and, bidirectional, the backward direction's
    first, concatenated, [B, H * directions].  ``dropout`` is the rate
    between layers."""

    def __init__(self, in_dim: int, num_hid: int, nlayers: int = 1,
                 dropout: float = 0.0, bidirect: bool = False,
                 rnn_type: str = "GRU"):
        if rnn_type not in ("GRU", "LSTM"):
            raise ValueError(f"unknown rnn_type {rnn_type!r}")
        # nn.RNNBase's own dropout stays 0: the port draws it (forward)
        super().__init__(rnn_type, in_dim, num_hid, num_layers=nlayers,
                         batch_first=True, bidirectional=bidirect)
        self.inter_dropout = dropout

    def _layer(self, x: torch.Tensor, weights) -> torch.Tensor:
        """One layer, both directions, over ``x``: one cuDNN call on the
        card, the call ``nn.GRU`` / ``nn.LSTM`` make."""
        h0 = x.new_zeros(1 + self.bidirectional, x.shape[0], self.hidden_size)
        if self.mode == "GRU":
            return torch.gru(x, h0, weights, True, 1, 0.0, self.training,
                             self.bidirectional, True)[0]
        return torch.lstm(x, (h0, h0), weights, True, 1, 0.0, self.training,
                          self.bidirectional, True)[0]

    def forward(self, x: torch.Tensor,
                ctx: Optional[Ctx] = None) -> torch.Tensor:
        # by name, so that weights functional_call swaps in (bf16 compute)
        # are the ones used
        weights = [getattr(self, n) for n in self._flat_weights_names]
        n = len(weights) // self.num_layers
        out = x
        for i in range(0, len(weights), n):
            if i > 0:
                out = dropout(out, self.inter_dropout, ctx)
            out = self._layer(out, weights[i:i + n])
        return out

    def forward_last(self, x: torch.Tensor,
                     ctx: Optional[Ctx] = None) -> torch.Tensor:
        out = self(x, ctx)
        if not self.bidirectional:
            return out[:, -1]
        H = self.hidden_size
        return torch.cat([out[:, -1, :H], out[:, 0, H:]], -1)
