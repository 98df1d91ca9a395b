"""Optimizer stack (``vqatpu/train/optim.py``): torch-semantics Adamax, the
flat-gradient global-norm clip and the reference's epoch LR schedule.

- Adamax adds eps inside the infinity-norm max (``u = max(b2*u, |g| +
  eps)``) and divides by the bias correction ``1 - b1**t``, as
  ``torch.optim.Adamax`` does.  It is written out with ``torch._foreach``
  ops so that ``state_dtype=torch.bfloat16`` can store m and u rounded to
  nearest even while the math runs in float32 (``optim.py:37-41, 63-65``).
- ``clip_flat_grads`` scales every gradient by ``min(max_norm / (norm +
  1e-6), 1)`` of the concatenated gradient's norm (``utils.py:323-328``).
- ``lr_for_epoch``: warmup factors on the first epochs, then a decay every
  ``lr_decay_step`` epochs (``FFOE/train.py:26-31, 62-69``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

from vqatpu_torch.config import TrainConfig


class Adamax:
    """Adamax over ``params`` (the trainable tensors; frozen ones get no
    state).  :meth:`step` takes the gradients explicitly and updates the
    params in place, with no host sync: ``lr`` may be a float or a 0-d
    tensor on the params' device."""

    def __init__(self, params: Sequence[torch.Tensor], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 state_dtype: Optional[torch.dtype] = None):
        self.params = list(params)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.state_dtype = state_dtype
        self.count = 0  # updates taken, on the host: no readback needed
        dt = state_dtype
        self.m = [torch.zeros_like(p, dtype=dt or p.dtype) for p in self.params]
        self.u = [torch.zeros_like(p, dtype=dt or p.dtype) for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor],
             lr: Union[float, torch.Tensor]) -> None:
        self.count += 1
        b1, b2 = self.b1, self.b2
        bias_corr = 1.0 - b1 ** self.count
        if self.state_dtype is None:
            m, u = self.m, self.u
        else:
            m = [x.float() for x in self.m]
            u = [x.float() for x in self.u]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, torch._foreach_mul(grads, 1.0 - b1))
        absg = torch._foreach_abs(grads)
        torch._foreach_add_(absg, self.eps)
        torch._foreach_mul_(u, b2)
        torch._foreach_maximum_(u, absg)
        out = torch._foreach_div(m, torch._foreach_mul(u, bias_corr))
        if isinstance(lr, torch.Tensor):
            torch._foreach_mul_(out, -lr)
        else:
            torch._foreach_mul_(out, -float(lr))
        torch._foreach_add_(self.params, out)
        if self.state_dtype is not None:
            for dst, src in zip(self.m + self.u, m + u):
                dst.copy_(src)  # round to nearest even


def global_grad_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """The L2 norm of all gradients concatenated, a 0-d tensor."""
    return torch.sqrt(sum(g.square().sum() for g in grads))


def clip_flat_grads(grads: Sequence[torch.Tensor], max_norm: float
                    ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """-> (the gradients scaled by ``min(max_norm / (norm + 1e-6), 1)``,
    the pre-clip norm)."""
    norm = global_grad_norm(grads)
    coef = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return torch._foreach_mul(list(grads), coef), norm


def lr_for_epoch(cfg: TrainConfig, epoch: int) -> float:
    warm = cfg.warmup_factors
    if epoch < len(warm):
        return cfg.lr * warm[epoch]
    lr = cfg.lr * warm[-1]
    for e in range(cfg.lr_decay_start, cfg.lr_decay_end, cfg.lr_decay_step):
        if e <= epoch:
            lr *= cfg.lr_decay_rate
    return lr
