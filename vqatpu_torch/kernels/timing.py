"""Device times of one call on a CUDA card, for ``chip_smoke.py`` and
:mod:`vqatpu_torch.kernels.probe`."""

from __future__ import annotations

import statistics
import time

import torch


def sleep_cycles_per_ms() -> float:
    """The rate of ``torch.cuda._sleep`` on this card, in cycles per ms."""
    torch.cuda._sleep(1000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    return 10_000_000 / start.elapsed_time(end)


def time_ms(fn, flush: torch.Tensor, cycles_per_ms: float, runs: int = 30):
    """Median device time of ``fn`` in ms, cold L2 (``flush`` is zeroed
    before each run; make it larger than the L2), and the host's time to
    enqueue it once in ms.  Each run parks the card in a sleep of twice
    that enqueue time (at least 1M cycles), so all of ``fn`` is queued
    before the start event fires and the host's pace stays out of the
    window."""
    for _ in range(3):
        fn()
    enqueue = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        enqueue.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    cycles = max(1_000_000, int(2 * max(enqueue) * cycles_per_ms))
    times = []
    for _ in range(runs):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), max(enqueue)
