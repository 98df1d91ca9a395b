"""Profiling hooks (``vqatpu/train/profiling.py:21-61``), on
``torch.profiler`` where JAX's use ``jax.profiler``.

- :func:`trace`: a context manager that profiles the enclosed block into a
  directory (a no-op for None); :func:`start_trace` / :func:`stop_trace`
  are its halves, for a window that spans loop iterations (the epoch loop's
  ``profile_dir``).  The file is a Chrome trace named as
  ``torch.profiler.tensorboard_trace_handler`` names it
  (``{host}_{pid}.{ns}.pt.trace.json``), which TensorBoard's profiler
  plugin and ``chrome://tracing`` load.  On a CUDA machine the CUDA
  activity (kernel launches and their device times) is recorded too.
- :func:`annotate`: a named range, a ``record_function`` in the trace and,
  on the card, an NVTX range.
- :class:`StepTimer`: rows per second over the steps after a warm-up,
  synchronizing the card at its measure points (``sync_value``'s device),
  as JAX's blocks on a value.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import torch
from torch.profiler import (ProfilerActivity, profile, record_function,
                            tensorboard_trace_handler)


def start_trace(log_dir: str) -> profile:
    """Start profiling into ``log_dir``; -> the profiler for
    :func:`stop_trace`."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(log_dir))
    prof.start()
    return prof


def stop_trace(prof: profile) -> None:
    """Wait for the card, stop ``prof`` and write its trace."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()


@contextlib.contextmanager
def trace(log_dir: Optional[str]) -> Iterator[None]:
    """Profile the enclosed block into ``log_dir`` (a no-op when None)."""
    if not log_dir:
        yield
        return
    prof = start_trace(log_dir)
    try:
        yield
    finally:
        stop_trace(prof)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named range: in the profiler's trace and, on the card, NVTX."""
    with record_function(name):
        if not torch.cuda.is_available():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


def _sync(value) -> None:
    if isinstance(value, torch.Tensor) and value.is_cuda:
        torch.cuda.synchronize(value.device)


class StepTimer:
    """Rolling samples/sec with a device sync at the measure points: the
    clock starts at step ``warmup`` and counts the rows of every later
    step."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self.count = 0
        self.rows = 0
        self._t0: Optional[float] = None

    def step(self, batch_rows: int, sync_value=None) -> None:
        self.count += 1
        if self.count == self.warmup:
            _sync(sync_value)
            self._t0 = time.perf_counter()
            self.rows = 0
        elif self.count > self.warmup:
            self.rows += batch_rows

    def samples_per_sec(self, sync_value=None) -> float:
        if self._t0 is None or self.rows == 0:
            return 0.0
        _sync(sync_value)
        return self.rows / (time.perf_counter() - self._t0)
