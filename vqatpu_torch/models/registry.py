"""Model factory keyed by name (``vqatpu/models/registry.py:32-41``).

Only the free-form CTI model is ported.  The others raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from vqatpu_torch.config import ModelConfig
from vqatpu_torch.models.ffoe import CTIModel

_NOT_PORTED = {
    ("ffoe", "ban"): "queue A item 5 (BAN)",
    ("ffoe", "san"): "queue A item 6 (SAN)",
    ("ffoe", "stacked_attention"): "queue A item 6 (SAN)",
    ("mc", "ban"): "queue A item 7 (MC)",
    ("mc", "cti"): "queue A item 7 (MC)",
    ("mc", "tan"): "queue A item 7 (MC)",
    ("mc", "san"): "queue A item 7 (MC)",
    ("mc", "stacked_attention"): "queue A item 7 (MC)",
}


def build_model(cfg: ModelConfig) -> CTIModel:
    if cfg.task == "ffoe" and cfg.model == "cti":
        return CTIModel(cfg)
    item = _NOT_PORTED.get((cfg.task, cfg.model))
    if item is None:
        raise ValueError(f"unknown model {cfg.model!r} for task {cfg.task!r}")
    raise NotImplementedError(
        f"model {cfg.model!r} for task {cfg.task!r} is not ported to "
        f"vqatpu_torch yet: ROADMAP {item}")
