"""Inverted dropout with ``torch.nn.Dropout`` semantics and the training
context that drives it (``vqatpu/ops/module.py:32-167``).

- :class:`Ctx` carries the train flag, an explicit ``torch.Generator`` on
  the model's device, ``mask_bits`` and an optional :class:`MaskSource`.
  No dropout draws from torch's global generator.
- :func:`dropout` is the identity when ``ctx`` is None or not training:
  that is the serving path.
- :class:`MaskSource` replays injected 0/1 masks, so that a test can feed
  the port and the JAX package the same masks (their generators never
  agree).
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Optional

import torch


class MaskSource:
    """Injected 0/1 dropout masks, one FIFO per shape: two implementations
    pair up as long as their same-shape sites fire in the same relative
    order."""

    def __init__(self, masks: Iterable):
        self._fifo: dict = {}
        for m in masks:
            self._fifo.setdefault(tuple(m.shape), deque()).append(m)

    def next_mask(self, shape):
        q = self._fifo.get(tuple(shape))
        if not q:
            raise ValueError(f"no injected dropout mask left for shape "
                             f"{tuple(shape)}")
        return q.popleft()

    def assert_exhausted(self) -> None:
        left = {s: len(q) for s, q in self._fifo.items() if q}
        if left:
            raise AssertionError(f"unconsumed injected dropout masks: {left}")


class Ctx:
    """Per-step context.  ``mask_bits=16`` thresholds 16-bit draws instead
    of float32 uniforms, with the inverted scale taken from the exact
    realized keep probability (``vqatpu/ops/module.py:114-118``)."""

    def __init__(self, train: bool = False,
                 generator: Optional[torch.Generator] = None,
                 mask_bits: int = 32,
                 mask_source: Optional[MaskSource] = None):
        if mask_bits not in (16, 32):
            raise ValueError(f"mask_bits must be 16 or 32, not {mask_bits}")
        self.train = train
        self.generator = generator
        self.mask_bits = mask_bits
        self.mask_source = mask_source


def dropout(x: torch.Tensor, rate: float,
            ctx: Optional[Ctx]) -> torch.Tensor:
    if rate <= 0.0 or ctx is None or not ctx.train:
        return x
    keep = 1.0 - rate
    if ctx.mask_source is not None:
        mask = torch.as_tensor(ctx.mask_source.next_mask(x.shape),
                               dtype=x.dtype, device=x.device)
        return x * mask / keep
    if ctx.generator is None:
        raise ValueError("Ctx needs a torch.Generator for dropout in training")
    if ctx.mask_bits == 16:
        thresh = max(round(keep * 65536.0), 1)
        bits = torch.randint(0, 65536, x.shape, generator=ctx.generator,
                             device=x.device, dtype=torch.int32)
        return torch.where(bits < thresh, x * (65536.0 / thresh),
                           torch.zeros_like(x))
    mask = torch.rand(x.shape, generator=ctx.generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))
