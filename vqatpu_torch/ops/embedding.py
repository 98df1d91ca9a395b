"""Word embedding with a pad row and the optional frozen-copy concat, op
``'c'`` (``vqatpu/ops/embedding.py:27-104``).

Lookups of the pad index (``ntoken``) are multiplied by ``x != ntoken``, as
in the JAX package, so they read zeros whatever the stored pad row holds.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from vqatpu_torch.ops.module import Ctx, dropout


class WordEmbedding(nn.Module):
    def __init__(self, ntoken: int, emb_dim: int = 300, dropout: float = 0.0,
                 op: str = ""):
        super().__init__()
        self.ntoken = ntoken
        self.dropout = dropout
        self.cat = "c" in op
        self.emb = nn.Parameter(self._table(ntoken, emb_dim))
        if self.cat:
            self.emb_ = nn.Parameter(self._table(ntoken, emb_dim))

    @staticmethod
    def _table(ntoken: int, emb_dim: int) -> torch.Tensor:
        t = torch.randn(ntoken + 1, emb_dim)  # nn.Embedding default N(0, 1)
        t[-1] = 0.0
        return t

    def pretrained_tables(self, weight_init) -> dict:
        """The tables with the GloVe matrix ``weight_init`` [ntoken, emb_dim]
        in their first ``ntoken`` rows and the pad row as it is, as numpy
        copies: ``emb`` and, with the concat, ``emb_`` (``load_pretrained``
        without tf-idf, ``vqatpu/ops/embedding.py:55-83``)."""
        w = np.asarray(weight_init, np.float32)
        if w.shape != (self.ntoken, self.emb.shape[1]):
            raise ValueError(f"GloVe init of shape {w.shape}, expected "
                             f"{(self.ntoken, self.emb.shape[1])}")
        tables = {}
        for name in ("emb", "emb_") if self.cat else ("emb",):
            t = getattr(self, name).detach().cpu().numpy().copy()
            t[:self.ntoken] = w
            tables[name] = t
        return tables

    @property
    def out_dim(self) -> int:
        return self.emb.shape[1] * (2 if self.cat else 1)

    def forward(self, x: torch.Tensor,
                ctx: Optional[Ctx] = None) -> torch.Tensor:
        out_mask = (x != self.ntoken).to(self.emb.dtype)[..., None]
        emb = self.emb[x] * out_mask
        if self.cat:
            emb = torch.cat([emb, self.emb_[x] * out_mask], dim=-1)
        return dropout(emb, self.dropout, ctx)
