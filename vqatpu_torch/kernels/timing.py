"""Device times on a CUDA card, for ``chip_smoke.py`` and
:mod:`vqatpu_torch.kernels.probe`: of one call (:func:`time_ms`, which
includes the launch and event floor) and of many calls back to back over
rotating input copies (:func:`time_back_to_back_ms`, without it)."""

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


ROTATION_BYTES = 3 * 50 * 2**20  # three times the H100's 50 MB L2


def copies_for(nbytes: int) -> int:
    """How many copies of a call's ``nbytes`` (inputs and outputs) make a
    rotation that moves more than ``ROTATION_BYTES``: at least 2."""
    return max(2, -(-ROTATION_BYTES // max(nbytes, 1)))


def time_back_to_back_ms(calls, cycles_per_ms: float, rounds: int = 5) -> float:
    """Device time per call of ``calls`` run once each, back to back,
    between two CUDA events: the median over ``rounds`` of the window over
    ``len(calls)``.  Each call should read its own copy of the inputs and
    the copies together should exceed the L2 (:func:`copies_for`), so each
    call still reads cold; their results are held until the window closes,
    so each call also writes a buffer of its own.  The card sleeps for
    twice the host's time to enqueue them all, so the host's pace stays out
    of the window and only the launches' own gaps remain."""
    for c in calls:  # warm up, and fill the allocator's cache
        c()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    held = [c() for c in calls]
    enqueue = time.perf_counter() - t0
    del held
    torch.cuda.synchronize()
    cycles = max(1_000_000, int(2 * enqueue * 1e3 * cycles_per_ms))
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        held = [c() for c in calls]
        end.record()
        end.synchronize()
        del held
        times.append(start.elapsed_time(end) / len(calls))
    return statistics.median(times)
