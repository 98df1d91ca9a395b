"""The logits sweep of ``ffoe_test``: the program's ``get_logits`` over the
split's batches in order, the features gathered on the card by the store,
each batch's logits read back to the host before the next is sent (as
``get_logits`` does).  Batches come from a prefetch thread, as the
loader's do.  ``get_logits`` runs once a batch and returns that batch's
logits, so the window can end after any batch; the split's questions
repeat from its start when a window outlasts them.

A sample of the window's batches, drawn from the seed (every
``stride``-th from a drawn phase), keeps its logits; once the window has
closed and the program's state is freed, the plain reference computes the
same rows from the seed's weights and table.

The workload file's keys (besides those of ``benchmark.gen`` and
``benchmark.store``): ``batch``, the questions of a sweep's batch.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import compare, gen, spans, store, weights
from benchmark.reference import features
from benchmark.reference import train as ref_train
from benchmark.traffic.train import build_model, make_store, shape_of
from vqatpu_torch.data.batching import PrefetchLoader
from vqatpu_torch.eval.ffoe import get_logits

WARMUP_BATCHES = 3
STRIDE = (16, 33)  # the sample: one batch in 16 to 32


class _TimedStore:
    """The store, its gathers timed (host clock and CUDA events) and
    labelled."""

    def __init__(self, store_, sp, marks):
        self.store, self.sp, self.marks = store_, sp, marks

    def gather(self, ds_idx):
        sp = self.sp
        e0 = sp.mark() if sp else None
        with spans.label(self.marks, "gather"):
            out = self.store.gather(ds_idx)
        if sp:
            sp.pair("gather", e0, sp.mark())
        return out


class Session:
    train = False

    def __init__(self, cell, seed: int, device, laps=None):
        lap = laps or (lambda stage: None)
        self.cell, self.seed = cell, seed
        self.device = torch.device(device)
        m, wl, tr = cell.model, cell.workload, cell.config["train"]
        self.shape = shape_of(cell)
        self.flop_per_sample = cell.arch.model_flop(
            m, wl["max_boxes"], self.shape["Q"], self.shape["A"], train=False)
        self.compute_dtype = tr["compute_dtype"]
        self.transfer_dtype = tr["transfer_dtype"]
        w = weights.make(cell.arch.leaves(m), gen.derive(seed, gen.WEIGHTS),
                         self.device)
        self.model = build_model(cell, w, self.device, laps).eval()
        del w
        lap("weights loaded")
        self.store = make_store(store.make(wl, m["v_dim"], seed, self.device))
        lap("store")
        self.stream = gen.Stream(gen.fields(m, cell.config["shapes"], wl, seed),
                                 m["num_ans_candidates"], wl["batch"], seed,
                                 shuffle=False)
        self.it = iter(PrefetchLoader(self.stream))
        rng = np.random.default_rng(gen.derive(seed, gen.SAMPLE))
        self.stride = int(rng.integers(*STRIDE))
        self.phase = int(rng.integers(0, self.stride))
        self.kept, self.count = [], 0
        lap("fields")
        for _ in range(WARMUP_BATCHES):
            self._one(keep=False)
        self.kept, self.count = [], 0
        lap("warm-up")

    def _one(self, sp=None, marks=None, keep=True) -> int:
        with spans.label(marks, "batch"):
            b = next(self.it)
        b["valid"] = np.ones(len(b["q"]), bool)
        asked = b["qid"]
        dev_store = (self.store if sp is None and marks is None
                     else _TimedStore(self.store, sp, marks))
        e0 = sp.mark() if sp else None
        t = time.perf_counter()
        with spans.label(marks, "get_logits"):
            pred, qids = get_logits(self.model, [b], self.compute_dtype,
                                    self.transfer_dtype, dev_store=dev_store)
        if sp:
            sp.host["call"].append((time.perf_counter() - t) * 1e3)
            sp.pair("call", e0, sp.mark())
        if keep and self.count % self.stride == self.phase:
            self.kept.append((asked, pred, qids))
        self.count += 1
        return len(asked)

    def window(self, seconds: float, sp=None, marks=None) -> dict:
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        n = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            n += self._one(sp, marks, keep=marks is None)
        t = time.perf_counter() - t0  # each batch's logits are on the host
        return {"seconds": t, "samples": n, "steps": n // self.shape["B"],
                "failed": 0}

    def close(self) -> None:
        self.stream.stop()
        gen.drain(self.it)
        del self.it, self.model, self.store
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "float32", alter=None) -> list:
        """The plain reference's logits of the kept batches; ``precision``
        ``tf32`` is the control, ``alter`` a planted fault."""
        cell, seed, dev = self.cell, self.seed, self.device
        m, wl = cell.model, cell.workload
        tf32 = precision == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            w = weights.make(cell.arch.leaves(m),
                             gen.derive(seed, gen.WEIGHTS), dev)
            table = store.make(wl, m["v_dim"], seed, dev)
            f = gen.fields(m, cell.config["shapes"], wl, seed)

            def rows():
                for asked, _, _ in self.kept:
                    b = gen.batch(f, asked, m["num_ans_candidates"])
                    v, v_mask = features.gather(table, b["ds_idx"])
                    yield {"v": v, "v_mask": v_mask,
                           "q": torch.as_tensor(b["q"], device=dev).long(),
                           "a": torch.as_tensor(b["a"], device=dev).long()}

            out = [x.numpy() for x in ref_train.logits(cell.arch, w, m, rows())]
            return out if alter is None else [alter(x) for x in out]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    def readings(self, ref: list) -> dict:
        return compare.logit_readings([p for _, p, _ in self.kept], ref,
                                      [q for _, _, q in self.kept],
                                      [a for a, _, _ in self.kept])

    def check(self):
        """-> (the compared numbers, sampled rows whose logits are not
        finite)."""
        bad = int(sum((~np.isfinite(p)).any(1).sum() for _, p, _ in self.kept))
        if not self.kept:
            return {"logit_gap": float("inf"), "rows_misplaced": 0.0}, bad
        return self.readings(self.reference()), bad
