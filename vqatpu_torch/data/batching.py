"""Static-shape batch iteration, a copy of ``vqatpu.data.batching``
(``vqatpu/data/batching.py:18-239``): the same batches, bit for bit, in the
same order.

Replaces the reference's ``DataLoader`` + ``trim_collate``
(``utils.py:120-169``), which pads each batch's box dim to the batch max.
Here every sample is already padded to ``max_boxes`` (see
``FeatureStore.get``), so batches stack to one static shape; the final
partial batch is zero-padded to ``batch_size`` with a ``valid`` row mask so
eval stays exact.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


def stack_samples(samples) -> Dict[str, np.ndarray]:
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples], 0) for k in keys}


def max_target_labels(dataset) -> int:
    """Upper bound on labeled target entries per sample (<=10 for VQA-2.0:
    ten human answers per question, ``tools/compute_softscore`` semantics),
    for sizing the sparse-target wire.  ConcatDataset aware; entries
    without an answer dict (test splits) count 0.

    Also guards the sparse wire's add-densify semantics: duplicate labels
    within one entry would sum on device but last-win in the dense
    ``_target`` scatter — softscore/TDIUC/VG entries never have them, and
    a dataset that did must use the dense wire."""
    members = list(getattr(dataset, "datasets", [])) or [dataset]
    k = 1
    for d in members:
        for e in d.entries:
            a = e.get("answer")
            if a is not None and a.get("labels") is not None:
                labels = a["labels"]
                assert len(set(labels)) == len(labels), \
                    f"duplicate target labels in entry {e.get('question_id')}"
                k = max(k, len(labels))
    return k


def sparsify_target(sample: dict, k: int) -> dict:
    """Replace a sample's dense ``target [n_ans]`` with ``t_label [k]``
    int32 + ``t_score [k]`` f32 (``np.nonzero`` order; zero-padded — pads
    land on column 0 with score 0.0, an exact no-op under the device-side
    one-hot densify, :func:`vqatpu_torch.train.steps.densify_target`)."""
    t = sample.pop("target")
    nz = np.nonzero(t)[0]
    assert nz.size <= k, (nz.size, k)
    lab = np.zeros((k,), np.int32)
    sc = np.zeros((k,), np.float32)
    lab[:nz.size] = nz
    sc[:nz.size] = t[nz]
    sample["t_label"] = lab
    sample["t_score"] = sc
    return sample


class BatchLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 1204, drop_last: bool = False,
                 pad_final: bool = True, fields_only: bool = False,
                 sparse_target_k: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.pad_final = pad_final
        # fields_only: skip the feature slabs (v/b/v_mask) and ship the
        # dataset sample index as ``ds_idx`` instead: the wire of a
        # card-resident feature store, where v/b never cross the host wire.
        # The shuffle order is the full loader's (same RNG, same seed).
        # The RNG is drawn once an epoch and belongs to the loader: a run
        # resumed with a fresh loader starts again at the first order, as
        # JAX's does.
        self.fields_only = fields_only
        # >0: ship targets sparse (t_label/t_score [k] per row) instead of
        # dense [n_ans] — the device step densifies (steps.densify_target).
        # Only meaningful with fields_only (the device-store wire).
        self.sparse_target_k = sparse_target_k
        self._rng = np.random.RandomState(seed)
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    @property
    def num_samples(self) -> int:
        return len(self.dataset)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(order)
        self._epoch += 1
        bs = self.batch_size
        stop = (n // bs) * bs if self.drop_last else n
        for start in range(0, stop, bs):
            idx = order[start:start + bs]
            if self.fields_only:
                k = self.sparse_target_k
                if k and hasattr(self.dataset, "sample_fields_sparse"):
                    # entry-direct sparse targets: the [num_ans]-wide host
                    # densify never runs
                    samples = [self.dataset.sample_fields_sparse(int(i), k)
                               for i in idx]
                else:
                    samples = [self.dataset.sample_fields(int(i))
                               for i in idx]
                    if k:
                        samples = [sparsify_target(s, k) for s in samples]
                batch = stack_samples(samples)
                batch["ds_idx"] = idx.astype(np.int64)
            else:
                samples = [self.dataset.sample(int(i)) for i in idx]
                batch = stack_samples(samples)
            valid = np.ones((len(idx),), bool)
            if len(idx) < bs and self.pad_final:
                pad = bs - len(idx)
                batch = {
                    k: np.concatenate(
                        [v, np.zeros((pad,) + v.shape[1:], v.dtype)], 0)
                    for k, v in batch.items()
                }
                valid = np.concatenate([valid, np.zeros((pad,), bool)])
                if self.fields_only:
                    # padded rows must gather the all-zero sentinel boxes,
                    # not image 0's features (wire parity: zero rows)
                    batch["ds_idx"][len(idx):] = -1
            batch["valid"] = valid
            yield batch


class PrefetchLoader:
    """Background-thread prefetch wrapper around any batch iterable.

    Overlaps host-side batch assembly (python sample stacking; streaming
    HDF5 reads in ``FeatureStore(in_memory=False)`` mode) with the card's
    compute, so an epoch costs about max(assembly, step) instead of their
    sum, where the step leaves the host idle.  Stacking is numpy, which
    releases the interpreter lock in its copies; the rest of the host's
    Python work contends with the training step for the lock.

    Order and values are exactly the inner loader's: the worker runs the
    inner iterator one epoch at a time into a bounded queue (``depth``
    batches ahead).  Every yielded batch is freshly allocated by the inner
    loader (``stack_samples``/``np.concatenate``), never rewritten, so it
    is safe to alias with ``torch.from_numpy``.

    An abandoned epoch iterator leaves its daemon worker parked on the
    queue; it holds one epoch's iterator until process exit (the train/eval
    loops always drain full epochs).
    """

    def __init__(self, inner, depth: int = 2):
        assert depth >= 1
        self.inner = inner
        self.depth = depth

    def __len__(self) -> int:
        return len(self.inner)

    @property
    def num_samples(self) -> int:
        return self.inner.num_samples

    @property
    def dataset(self):
        return self.inner.dataset

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        end = object()
        failure = []

        def _worker():
            try:
                for b in self.inner:
                    q.put(b)
            except BaseException as e:  # propagate to the consumer
                failure.append(e)
            finally:
                q.put(end)

        threading.Thread(target=_worker, daemon=True,
                         name="vqatpu_torch-prefetch").start()
        while True:
            b = q.get()
            if b is end:
                if failure:
                    raise failure[0]
                return
            yield b


def make_eval_loader(dataset, batch_size: int, fields_only: bool = False):
    """Sequential-sweep loader for eval and inference: no shuffle, the final
    batch padded with a ``valid`` row mask, assembled on a prefetch thread
    (``vqatpu/data/batching.py:201-239``).  JAX's native C++ loader, which
    yields the same bytes, is ROADMAP queue A item 4b; the int8 wire is
    quantized by ``wire_cast``.  ``fields_only=True`` ships ``ds_idx``
    instead of the v/b slabs (targets stay dense: eval scores them on the
    host)."""
    return PrefetchLoader(BatchLoader(dataset, batch_size,
                                      fields_only=fields_only))
