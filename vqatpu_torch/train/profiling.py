"""Profiling hooks (``vqatpu/train/profiling.py:21-61``), on
``torch.profiler`` where JAX's use ``jax.profiler``, and the port's spans.

- :func:`trace`: a context manager that profiles the enclosed block into a
  directory (a no-op for None); :func:`start_trace` / :func:`stop_trace`
  are its halves, for a window that spans loop iterations (the epoch loop's
  ``profile_dir``).  The file is a Chrome trace named as
  ``torch.profiler.tensorboard_trace_handler`` names it
  (``{host}_{pid}.{ns}.pt.trace.json``), which TensorBoard's profiler
  plugin and ``chrome://tracing`` load.  On a CUDA machine the CUDA
  activity (kernel launches and their device times) is recorded too.
- :func:`span`: a named phase of the program (the train step's
  ``train_step``, ``train_step.forward``, ``.backward`` and
  ``.optimizer``; the feed's ``feed.expand``, ``feed.upload``,
  ``feed.upload_wait``, ``feed.gather`` and ``feed.loader_wait``).  Off,
  which is the default, it is one check of a module flag and returns a
  shared no-op context.  Between :func:`start_trace` and :func:`stop_trace`
  it is a ``record_function`` range in the trace and, on the card, an NVTX
  range.  Under :func:`tracing` it is recorded in memory (the tracer takes
  precedence over the profiler's ranges where both are on).
- :func:`tracing`: a context manager that yields a :class:`Tracer`.  Each
  span gets its name, its parent (a stack per thread), the index of the
  microbatch it belongs to (the number of ``train_step`` spans closed
  before it opened, so the feed's spans carry the index of the step that
  consumes them) and its host start and end on ``time.time_ns``, the clock
  of a profiler trace's ``baseTimeNanoseconds``.  A span opened with
  ``device=True`` also records a CUDA event pair on the current stream.
  Counters (:func:`count`; ``sync_reported``, the synchronising operations
  that ``torch.cuda.set_sync_debug_mode("warn")`` reports; and the
  deltas of :func:`step_counters` over each ``train_step``) are attributed
  to the innermost open span; outside every span nothing is counted.
  :meth:`Tracer.export` synchronises once and gives the spans with their
  self times, and the counters.
"""

from __future__ import annotations

import contextlib
import threading
import time
import warnings
from collections import defaultdict
from typing import Callable, Iterator, Optional

import torch
from torch.profiler import (ProfilerActivity, profile, record_function,
                            tensorboard_trace_handler)

STEP = "train_step"  # the span whose end closes a microbatch
SYNC_WARNING = "called a synchronizing CUDA operation"
# the caching allocator's cumulative counts, under the counters' names
MEMORY_STATS = {"device_alloc": "num_device_alloc",
                "device_free": "num_device_free",
                "alloc_retries": "num_alloc_retries"}


class _Off:
    """The shared no-op context of a span while nothing traces."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()
_profiling = False  # between start_trace and stop_trace
_tracer: Optional["Tracer"] = None
_open: Optional[Callable] = None  # the span factory while either is on


def span(name: str, device: bool = False):
    """A named phase: the enclosed block's host time and, with ``device``
    under :func:`tracing` on the card, its time on the current stream."""
    if _open is None:
        return _OFF
    return _open(name, device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span (under
    :func:`tracing` only)."""
    if _tracer is not None:
        _tracer.count(name, n)


def _reopen() -> None:
    global _open
    _open = (_tracer.open if _tracer is not None
             else _Range if _profiling else None)


class _Range:
    """A ``record_function`` range and, on the card, an NVTX range."""

    __slots__ = ("name", "rf")

    def __init__(self, name: str, device: bool = False):
        self.name = name
        self.rf = record_function(name)

    def __enter__(self):
        self.rf.__enter__()
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_push(self.name)

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_pop()
        return self.rf.__exit__(*exc)


def start_trace(log_dir: str) -> profile:
    """Start profiling into ``log_dir``, spans as ranges; -> the profiler
    for :func:`stop_trace`."""
    global _profiling
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(log_dir))
    prof.start()
    _profiling = True
    _reopen()
    return prof


def stop_trace(prof: profile) -> None:
    """Wait for the card, stop ``prof`` and write its trace."""
    global _profiling
    _profiling = False
    _reopen()
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


def step_counters() -> dict:
    """The cumulative counts read at each ``train_step``'s boundaries: the
    hand-written kernels' ``launches`` and, on the card, the caching
    allocator's ``cudaMalloc`` calls, ``cudaFree`` calls and retries (a
    free or a retry synchronises the device)."""
    from vqatpu_torch.kernels.trilinear import launches

    out = {"launches": sum(launches.values())}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        stats = torch.cuda.memory_stats()
        out.update({k: stats.get(v, 0) for k, v in MEMORY_STATS.items()})
    return out


class _Traced:
    """One span under a :class:`Tracer`.  Its record: ``[name, parent
    record, microbatch, host start ns, host end ns, start event, end
    event]``."""

    __slots__ = ("tr", "name", "device", "rec", "before")

    def __init__(self, tr: "Tracer", name: str, device: bool):
        self.tr, self.name, self.device = tr, name, device

    def __enter__(self):
        tr = self.tr
        stack = tr.stack()
        if self.name == STEP:
            self.before = tr.counters()
        rec = self.rec = [self.name, stack[-1] if stack else None, tr.micro,
                          time.time_ns(), None, None, None]
        if self.device:
            rec[5] = torch.cuda.Event(enable_timing=True)
            rec[5].record()
        tr.records.append(rec)
        stack.append(rec)

    def __exit__(self, *exc):
        tr, rec = self.tr, self.rec
        if self.device:
            rec[6] = torch.cuda.Event(enable_timing=True)
            rec[6].record()
        rec[4] = time.time_ns()
        tr.stack().pop()
        if self.name == STEP:
            for k, v in tr.counters().items():
                if v != self.before.get(k, 0):
                    tr.counts[(k, id(rec))] += v - self.before.get(k, 0)
            tr.micro += 1
        return False


class Tracer:
    """The spans and counters of one traced stretch, kept in memory until
    :meth:`export`.  ``device``: spans opened with ``device=True`` record
    CUDA events (on the card only).  ``counters``: a zero-argument callable
    -> cumulative counts, read at each ``train_step``'s boundaries
    (:func:`step_counters`)."""

    def __init__(self, device: bool = True,
                 counters: Callable[[], dict] = step_counters):
        self.device = device and torch.cuda.is_available()
        self.counters = counters
        self.records: list = []
        self.counts: dict = defaultdict(int)  # (counter, id(record)) -> n
        self.micro = 0  # train_step spans closed so far
        self._local = threading.local()

    def stack(self) -> list:
        """This thread's open span records, innermost last."""
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def open(self, name: str, device: bool = False) -> _Traced:
        return _Traced(self, name, device and self.device)

    def count(self, name: str, n: int = 1) -> None:
        stack = self.stack()
        if stack:
            self.counts[(name, id(stack[-1]))] += n

    def _show(self, show):
        """``warnings.showwarning`` that counts torch's reports of a
        synchronising operation (printing none) and shows the rest."""
        def showwarning(message, category, filename, lineno, file=None,
                        line=None):
            if SYNC_WARNING in str(message):
                self.count("sync_reported")
            else:
                show(message, category, filename, lineno, file, line)
        return showwarning

    def export(self) -> dict:
        """Synchronise once and resolve the events ->

        - ``spans``: a dict per closed span, in the order they opened:
          ``name``, ``parent`` (an index in this list, or None), ``micro``,
          ``start_ns`` and ``end_ns`` (``time.time_ns``), ``host_ms``,
          ``host_self_ms`` (less what its children cover), ``device_ms``
          and ``device_self_ms`` (between its CUDA events, less its
          children's; None without events);
        - ``counters``: ``{"name", "span", "micro", "value"}`` per counter
          and span."""
        recs = [r for r in self.records if r[4] is not None]
        if any(r[5] is not None for r in recs):
            torch.cuda.synchronize()
        index = {id(r): i for i, r in enumerate(recs)}
        spans = []
        for name, parent, micro, t0, t1, e0, e1 in recs:
            host = (t1 - t0) / 1e6
            dev = e0.elapsed_time(e1) if e0 is not None else None
            spans.append({"name": name, "micro": micro,
                          "parent": None if parent is None
                          else index.get(id(parent)),
                          "start_ns": t0, "end_ns": t1,
                          "host_ms": host, "device_ms": dev,
                          "host_self_ms": host, "device_self_ms": dev})
        for s in spans:  # children nest and follow one another
            if s["parent"] is not None:
                up = spans[s["parent"]]
                up["host_self_ms"] -= s["host_ms"]
                if up["device_ms"] is not None and s["device_ms"] is not None:
                    up["device_self_ms"] -= s["device_ms"]
        counters = [{"name": name, "span": index[key],
                     "micro": spans[index[key]]["micro"], "value": n}
                    for (name, key), n in self.counts.items() if key in index]
        return {"spans": spans, "counters": counters}


@contextlib.contextmanager
def tracing(device: bool = True,
            counters: Callable[[], dict] = step_counters
            ) -> Iterator[Tracer]:
    """Record the port's spans and counters over the enclosed block into
    the yielded :class:`Tracer` (see the module docstring).  On the card
    torch's sync debug mode is ``"warn"`` inside, and its reports are
    counted as ``sync_reported``, never printed; the mode, the warning
    filters and the previous tracer are restored on exit."""
    global _tracer
    tr = Tracer(device, counters)
    previous = _tracer
    cuda = torch.cuda.is_available()
    with warnings.catch_warnings():
        warnings.filterwarnings("always", message=f".*{SYNC_WARNING}")
        # torch warns at each switch that the mode is a prototype, which
        # misses some synchronising operations: sync_reported is a floor
        warnings.filterwarnings("ignore", message="Synchronization debug mode")
        warnings.showwarning = tr._show(warnings.showwarning)
        mode = torch.cuda.get_sync_debug_mode() if cuda else None
        if cuda:
            torch.cuda.set_sync_debug_mode("warn")
        _tracer = tr
        _reopen()
        try:
            yield tr
        finally:
            _tracer = previous
            _reopen()
            if cuda:
                torch.cuda.set_sync_debug_mode(mode)
