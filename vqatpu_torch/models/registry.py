"""Model factory keyed by name (``vqatpu/models/registry.py:32-41``).

The free-form models are ported: ``ban``, ``san`` (also named
``stacked_attention``) and ``cti``.  The multiple-choice ones raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from torch import nn

from vqatpu_torch.config import ModelConfig
from vqatpu_torch.models.ffoe import BanModel, CTIModel, StackedAttentionModel

_FFOE = {
    "ban": BanModel,
    "san": StackedAttentionModel,
    "stacked_attention": StackedAttentionModel,
    "cti": CTIModel,
}
_MC = ("ban", "san", "stacked_attention", "cti", "tan")


def build_model(cfg: ModelConfig) -> nn.Module:
    if cfg.task == "ffoe" and cfg.model in _FFOE:
        return _FFOE[cfg.model](cfg)
    if cfg.task == "mc" and cfg.model in _MC:
        raise NotImplementedError(
            f"model {cfg.model!r} for task 'mc' is not ported to vqatpu_torch "
            "yet: ROADMAP queue A item 7 (MC)")
    raise ValueError(f"unknown model {cfg.model!r} for task {cfg.task!r}")
