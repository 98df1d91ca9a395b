"""Inverted dropout with ``torch.nn.Dropout`` semantics
(``vqatpu/ops/module.py:143-167``).

At eval (``train=False``, the serving path) it is the identity.  The
training context of the JAX package (``Ctx``, mask replay, ``MaskSource``)
comes with the training slice of the port.
"""

from __future__ import annotations

from typing import Optional

import torch


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    if rate <= 0.0 or not train:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))
