"""Loss functions (``vqatpu/ops/losses.py``).

``bce_with_logits_sum`` is ``nn.BCEWithLogitsLoss(reduction='sum')``, the
reference training criterion, in the JAX package's formula.
``distillation_loss`` comes with BAN (ROADMAP queue A item 5): CTI ignores
the distillation criterion.
"""

from __future__ import annotations

import torch


def bce_with_logits_sum(logits: torch.Tensor,
                        targets: torch.Tensor) -> torch.Tensor:
    """``max(x, 0) - x*z + log(1 + exp(-|x|))``, summed."""
    per = (logits.clamp_min(0.0) - logits * targets
           + torch.log1p(torch.exp(-logits.abs())))
    return per.sum()
