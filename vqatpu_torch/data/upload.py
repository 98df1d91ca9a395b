"""Host-to-card uploads of batches from page-locked memory.

A pageable ``torch.as_tensor(x).to("cuda")`` makes the host wait for the
copy (10.5 ms for a float32 batch of 105 MB at B=256 on the H100 host,
PERF.md §5).  :class:`PinnedUploader` copies from page-locked buffers with
``non_blocking=True`` on a stream of its own, so that the upload of batch
*n+1* runs while the card computes step *n*; the compute stream waits for
the copy by an event, not the host.

Two buffers (``DEPTH``) take turns.  A buffer is refilled only after the
event of its last copy has completed; where it has not yet, the host waits
in a ``feed.upload_wait`` span, counted as ``upload_blocked``
(:mod:`vqatpu_torch.train.profiling`; each call is a ``feed.upload``
span).  A source already in page-locked memory (a pinned ring buffer of
:class:`~vqatpu_torch.data.native.NativeBatchLoader`) is copied from where
it lies, and the uploader holds it until its copy is done: so long the
native loader does not hand its buffers to the C++ worker again.  Values
are copied byte for byte.  On a CPU device a batch becomes tensors
without a copy, as the steps' own ``torch.as_tensor`` would make them.
"""

from __future__ import annotations

import torch

from vqatpu_torch.train.profiling import count, span

DEPTH = 2  # staging buffers that take turns


class PinnedUploader:
    """``uploader(batch) -> {key: tensor on device}`` for a dict of numpy
    arrays or host tensors."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.uploads = 0
        self.staged_bytes = 0  # bytes that went through a staging copy
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(self.device)
            self._staging = [{} for _ in range(DEPTH)]
            self._done = [None] * DEPTH
            self._sources = [[] for _ in range(DEPTH)]

    def __call__(self, batch: dict) -> dict:
        with span("feed.upload"):
            return self._upload(batch)

    def _upload(self, batch: dict) -> dict:
        self.uploads += 1
        if self.device.type != "cuda":
            return {k: torch.as_tensor(x).to(self.device)
                    for k, x in batch.items()}
        slot = self.uploads % DEPTH
        done = self._done[slot]
        if done is not None and not done.query():
            # the slot's last copies must be done before it is refilled
            with span("feed.upload_wait"):
                count("upload_blocked")
                done.synchronize()
        staging, sources, out = self._staging[slot], [], {}
        with torch.cuda.stream(self._stream):
            for k, x in batch.items():
                src = torch.as_tensor(x)
                if src.is_pinned():
                    sources.append(x)  # held until its copy is done
                else:
                    buf = staging.get(k)
                    if (buf is None or buf.shape != src.shape
                            or buf.dtype != src.dtype):
                        buf = staging[k] = torch.empty(
                            src.shape, dtype=src.dtype, pin_memory=True)
                    buf.copy_(src)
                    self.staged_bytes += buf.numel() * buf.element_size()
                    src = buf
                out[k] = src.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        self._done[slot], self._sources[slot] = done, sources
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(done)
        for t in out.values():
            # allocated on the copy stream, used on the compute stream
            t.record_stream(compute)
        return out
