"""Loss functions (``vqatpu/ops/losses.py``).

- ``bce_with_logits_sum`` is ``nn.BCEWithLogitsLoss(reduction='sum')``, the
  reference training criterion, in the JAX package's formula.
- ``distillation_loss`` is Hinton's knowledge distillation
  (``src/loss_function.py:20-25``), the criterion of BAN and SAN with
  ``TrainConfig.distillation``; the CTI step ignores it, as JAX's does.
"""

from __future__ import annotations

import torch


def bce_with_logits_sum(logits: torch.Tensor,
                        targets: torch.Tensor) -> torch.Tensor:
    """``max(x, 0) - x*z + log(1 + exp(-|x|))``, summed."""
    per = (logits.clamp_min(0.0) - logits * targets
           + torch.log1p(torch.exp(-logits.abs())))
    return per.sum()


def distillation_loss(student_logits: torch.Tensor,
                      teacher_logits: torch.Tensor, targets: torch.Tensor,
                      T: float, alpha: float) -> torch.Tensor:
    """``KL(softmax(t/T) || log_softmax(s/T))`` summed over the answers and
    averaged over the batch, times ``alpha T^2``, plus ``(1 - alpha)`` times
    the per-sample BCE sum.  ``log t`` reads 0 where ``t`` underflows to 0,
    as ``nn.KLDivLoss`` does."""
    s = torch.log_softmax(student_logits / T, dim=1)
    t = torch.softmax(teacher_logits / T, dim=1)
    log_t = torch.where(t > 0, torch.log(t.clamp_min(1e-38)),
                        torch.zeros_like(t))
    kl = (t * (log_t - s)).sum(1).mean()
    bce = bce_with_logits_sum(student_logits, targets) / student_logits.shape[0]
    return kl * (alpha * T * T) + bce * (1.0 - alpha)
