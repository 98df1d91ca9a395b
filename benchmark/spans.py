"""Spans recorded from the benchmark's own calls into the program, and the
reduction of a ``torch.profiler`` trace to busy time, idle gaps and
kernel times.

A stretch without the profiler records each span's host time (the host
clock) and, for the spans given a device side, the time between CUDA
events recorded on the compute stream before and after it.  A profiled
stretch marks the same calls on the wall clock, on which the trace's
device operations are placed too."""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 160  # of a kernel's name in the breakdown


class Spans:
    """Host and device times of named spans over one stretch."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.host: Dict[str, List[float]] = defaultdict(list)
        self._events: Dict[str, list] = defaultdict(list)
        self.device: Dict[str, List[float]] = {}

    def mark(self):
        """A CUDA event recorded now on the compute stream (None off the
        card)."""
        if not self.cuda:
            return None
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def pair(self, name: str, start, end) -> None:
        if start is not None:
            self._events[name].append((start, end))

    @contextlib.contextmanager
    def host_span(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.host[name].append((time.perf_counter() - t) * 1e3)

    def finish(self) -> None:
        """Read the device times (ms) once the stretch is synchronized."""
        if self.cuda:
            torch.cuda.synchronize()
        self.device = {k: [a.elapsed_time(b) for a, b in v]
                       for k, v in self._events.items()}
        self._events.clear()


def median(xs) -> Optional[float]:
    return statistics.median(xs) if xs else None


class Marks:
    """Host spans on the wall clock (``time.time_ns``), the clock that a
    trace's ``baseTimeNanoseconds`` is on: they name the device's idle gaps
    in a profiled stretch."""

    def __init__(self):
        self.spans: List[tuple] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t, time.time_ns()))


def label(marks: Optional[Marks], name: str):
    """``marks(name)`` in a profiled stretch, else nothing."""
    return marks(name) if marks is not None else contextlib.nullcontext()


def profiled(fn):
    """Run ``fn(marks)`` under ``torch.profiler`` tracing the card alone
    (tracing the host's every operation would slow a host-paced step
    severalfold), synchronized at both ends.  -> (``fn``'s result, the
    reduced trace, :func:`reduce_trace`)."""
    from torch.profiler import ProfilerActivity, profile

    marks = Marks()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time_ns()
        out = fn(marks)
        torch.cuda.synchronize()
        t1 = time.time_ns()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    base = trace.get("baseTimeNanoseconds")
    if base is None:
        return out, None
    return out, reduce_trace(trace["traceEvents"], (t0 - base) / 1e3,
                             (t1 - base) / 1e3,
                             [(n, (a - base) / 1e3, (b - base) / 1e3)
                              for n, a, b in marks.spans])


def reduce_trace(events: list, t0: float, t1: float,
                 host: list) -> Optional[dict]:
    """Chrome-trace events, the stretch [``t0``, ``t1``) and the host's
    spans ``(name, start, end)``, all in the trace's microseconds ->
    ``window_s``, ``busy_s`` (the union of device operations in the
    stretch), ``kernels`` (each device operation's name and seconds),
    ``device_ops`` (the ten names of most device time) and ``idle_gaps``
    (idle device time summed by the innermost host span open when the gap
    began, the ten largest).  None if no device operation fell inside."""
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                 for e in events if e.get("ph") == "X" and "dur" in e
                 and e.get("cat") in DEVICE_CATS
                 and t0 <= float(e["ts"]) < t1)
    if not dev:
        return None
    ranges = sorted((s, e, n) for n, s, e in host)
    busy, gaps, end = 0.0, defaultdict(float), t0
    for s, e, _ in dev:
        e = min(e, t1)
        if s > end:
            gaps[_innermost(ranges, end)] += s - end
            end = s
        if e > end:
            busy += e - end
            end = e
    if t1 > end:
        gaps[_innermost(ranges, end)] += t1 - end
    per_op = defaultdict(float)
    for s, e, name in dev:
        per_op[name[:NAME_CHARS]] += (min(e, t1) - s) / 1e6
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(((k, v / 1e6) for k, v in gaps.items()),
                  key=lambda kv: -kv[1])[:10]
    return {"window_s": (t1 - t0) / 1e6, "busy_s": busy / 1e6,
            "kernels": [(n, (min(e, t1) - s) / 1e6) for s, e, n in dev],
            "device_ops": [list(kv) for kv in top],
            "idle_gaps": [list(kv) for kv in idle]}


def _innermost(ranges, t: float) -> str:
    """The latest-starting range that holds ``t``: what the host was in."""
    found = "outside the benchmark's spans"
    for s, e, name in ranges:
        if s > t:
            break
        if t < e:
            found = name
    return found
