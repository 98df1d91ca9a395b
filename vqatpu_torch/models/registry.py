"""Model factory keyed by name (``vqatpu/models/registry.py:32-41``).

Free-form (``task="ffoe"``): ``ban``, ``san`` (also named
``stacked_attention``) and ``cti``.  Multiple choice (``task="mc"``):
``ban``, ``san`` / ``stacked_attention``, and ``cti`` or ``tan`` (both
:class:`~vqatpu_torch.models.mc.TanModel`).
"""

from __future__ import annotations

from torch import nn

from vqatpu_torch.config import ModelConfig
from vqatpu_torch.models.ffoe import BanModel, CTIModel, StackedAttentionModel
from vqatpu_torch.models.mc import (BanModelMC, StackedAttentionModelMC,
                                    TanModel)

_FFOE = {
    "ban": BanModel,
    "san": StackedAttentionModel,
    "stacked_attention": StackedAttentionModel,
    "cti": CTIModel,
}
_MC = {
    "ban": BanModelMC,
    "san": StackedAttentionModelMC,
    "stacked_attention": StackedAttentionModelMC,
    "cti": TanModel,
    "tan": TanModel,
}


def build_model(cfg: ModelConfig) -> nn.Module:
    table = _MC if cfg.task == "mc" else _FFOE
    if cfg.task not in ("ffoe", "mc") or cfg.model not in table:
        raise ValueError(f"unknown model {cfg.model!r} for task {cfg.task!r}; "
                         f"choices: {sorted(table)}")
    return table[cfg.model](cfg)
