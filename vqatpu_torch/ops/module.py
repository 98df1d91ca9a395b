"""Inverted dropout with ``torch.nn.Dropout`` semantics and the training
context that drives it (``vqatpu/ops/module.py:32-167``).

- :class:`Ctx` carries the train flag, an explicit ``torch.Generator`` on
  the model's device, ``mask_bits`` and an optional :class:`MaskSource`.
  No dropout draws from torch's global generator.
- :func:`dropout` is the identity when ``ctx`` is None or not training:
  that is the serving path.  With ``ctx.mask_replay`` it keeps no mask for
  the backward: it keeps the generator's state and draws the mask again
  there (JAX's ``_dropout_replay``, ``vqatpu/ops/module.py:123-140``).
- :class:`MaskSource` replays injected 0/1 masks, so that a test can feed
  the port and the JAX package the same masks (their generators never
  agree).
- :func:`checkpoint_with_dropout` runs a function under
  ``torch.utils.checkpoint`` so that its recompute draws the masks its
  forward drew (``jax.checkpoint`` of a function that takes its dropout
  key as an argument, ``vqatpu/models/ffoe.py:294-312``).
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Iterable, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint


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


class _Recorder(MaskSource):
    """Pops from ``source`` and keeps what it popped, in order."""

    def __init__(self, source: MaskSource):
        self.source = source
        self.popped: List = []

    def next_mask(self, shape):
        m = self.source.next_mask(shape)
        self.popped.append(m)
        return m


class Ctx:
    """Per-step context.  ``mask_bits=16`` thresholds 16-bit draws instead
    of float32 uniforms, with the inverted scale taken from the exact
    realized keep probability (``vqatpu/ops/module.py:114-118``).
    ``mask_replay`` draws each mask again in the backward instead of
    keeping it (:class:`_ReplayDropout`)."""

    def __init__(self, train: bool = False,
                 generator: Optional[torch.Generator] = None,
                 mask_bits: int = 32,
                 mask_source: Optional[MaskSource] = None,
                 mask_replay: bool = False):
        if mask_bits not in (16, 32):
            raise ValueError(f"mask_bits must be 16 or 32, not {mask_bits}")
        self.train = train
        self.generator = generator
        self.mask_bits = mask_bits
        self.mask_source = mask_source
        self.mask_replay = mask_replay


def _whole_shape(x: torch.Tensor, shard: Optional[Tuple[int, int]]):
    """The shape of the unsplit tensor that ``x`` is a ``shard`` of."""
    shape = tuple(x.shape)
    return shape if shard is None else shape[:-1] + (shape[-1] * shard[0],)


def _local(m: torch.Tensor, x: torch.Tensor,
           shard: Optional[Tuple[int, int]]) -> torch.Tensor:
    """This rank's slice of the whole's mask ``m``."""
    if shard is None:
        return m
    return m.narrow(-1, shard[1] * x.shape[-1], x.shape[-1])


def _masked_apply(x: torch.Tensor, keep: float, mask_bits: int,
                  generator: torch.Generator,
                  shard: Optional[Tuple[int, int]]) -> torch.Tensor:
    """Draw the mask of the whole (``shard``: the unsplit last dim) from
    ``generator`` and apply this slice of it to ``x`` with the inverted
    scale.  The same generator state and shape give the same mask, which
    :class:`_ReplayDropout` relies on."""
    shape = _whole_shape(x, shard)
    if mask_bits == 16:
        thresh = max(round(keep * 65536.0), 1)
        bits = torch.randint(0, 65536, shape, generator=generator,
                             device=x.device, dtype=torch.int32)
        return torch.where(_local(bits, x, shard) < thresh,
                           x * (65536.0 / thresh), torch.zeros_like(x))
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    return torch.where(_local(mask, x, shard), x / keep, torch.zeros_like(x))


class _ReplayDropout(torch.autograd.Function):
    """:func:`_masked_apply` that keeps the generator's state taken before
    the draw, and no mask, for the backward.  The backward sets a fresh
    generator to that state, draws the same mask and applies it to the
    cotangent as the plain path's autograd does (``where(mask, g, 0)``,
    then the scale), so both directions are bit-equal to it.  A CUDA
    generator's state is its seed and offset on the host: no sync."""

    @staticmethod
    def forward(fctx, x, keep, mask_bits, generator, shard):
        fctx.state = generator.get_state()
        fctx.draw = (keep, mask_bits, generator.device, shard)
        return _masked_apply(x, keep, mask_bits, generator, shard)

    @staticmethod
    def backward(fctx, g):
        keep, mask_bits, device, shard = fctx.draw
        gen = torch.Generator(device=device)
        gen.set_state(fctx.state)
        return (_masked_apply(g, keep, mask_bits, gen, shard),
                None, None, None, None)


def dropout(x: torch.Tensor, rate: float, ctx: Optional[Ctx],
            shard: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """``shard=(n, i)``: ``x`` is slice ``i`` of ``n`` along its last dim of
    a tensor that the other ranks of a tensor-parallel group hold the rest
    of; the mask of the whole is drawn (the group's generators agree) and
    this slice of it applied, so that the masks are those of the unsplit
    layer."""
    if rate <= 0.0 or ctx is None or not ctx.train:
        return x
    keep = 1.0 - rate
    if ctx.mask_source is not None:
        mask = torch.as_tensor(
            ctx.mask_source.next_mask(_whole_shape(x, shard)),
            dtype=x.dtype, device=x.device)
        return x * _local(mask, x, shard) / keep
    if ctx.generator is None:
        raise ValueError("Ctx needs a torch.Generator for dropout in training")
    if ctx.mask_replay:
        return _ReplayDropout.apply(x, keep, ctx.mask_bits, ctx.generator,
                                    shard)
    return _masked_apply(x, keep, ctx.mask_bits, ctx.generator, shard)


def checkpoint_with_dropout(fn: Callable, ctx: Optional[Ctx], *args):
    """``fn(sub_ctx, *args)`` under ``torch.utils.checkpoint``
    (``use_reentrant=False``): only ``args`` and the output are kept for
    the backward, which runs ``fn`` again.  Both runs draw the same dropout
    masks.  A generator's state is taken before the first run and each run
    draws from a copy of it; the caller's generator then moves on past those
    draws (no host sync: a CUDA generator's state lives on the host).
    Injected masks (``ctx.mask_source``) are popped once, by the first run,
    and replayed to the recompute.  Without grad (serving) ``fn`` just runs
    with ``ctx``."""
    if not torch.is_grad_enabled():
        return fn(ctx, *args)
    if ctx is None or not ctx.train:
        return checkpoint(fn, ctx, *args, use_reentrant=False)
    inject = ctx.mask_source is not None
    if not inject and ctx.generator is None:
        raise ValueError("Ctx needs a torch.Generator for dropout in training")
    state = None if inject else ctx.generator.get_state()
    runs: List[Ctx] = []  # each run's context, the forward's first

    def run(*xs):
        if inject:
            source = (MaskSource(runs[0].mask_source.popped) if runs
                      else _Recorder(ctx.mask_source))
            sub = Ctx(train=True, mask_bits=ctx.mask_bits, mask_source=source,
                      mask_replay=ctx.mask_replay)
        else:
            gen = torch.Generator(device=ctx.generator.device)
            gen.set_state(state)
            sub = Ctx(train=True, generator=gen, mask_bits=ctx.mask_bits,
                      mask_replay=ctx.mask_replay)
        runs.append(sub)
        return fn(sub, *xs)

    out = checkpoint(run, *args, use_reentrant=False)
    if not inject:
        ctx.generator.set_state(runs[0].generator.get_state())
    return out
