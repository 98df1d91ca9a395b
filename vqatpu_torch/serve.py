"""Inference session: checkpoint -> answer strings (``vqatpu/serve.py``).

- :class:`InferenceSession` (``:146-298``) packs requests into the smallest
  batch bucket (1, 8, 32, 128 by default) with the padded rows fully
  masked, and chunks a request larger than the largest bucket.  Boxes
  beyond ``max_boxes`` are cut, fewer are zero-padded, and a box is real
  where its features are not all zero.  The forward runs under
  ``torch.inference_mode()`` on ``device`` (``cuda`` unless the caller asks
  for ``cpu``) with the math policy of :mod:`vqatpu_torch.numerics`, which
  the session sets and checks on every forward.
- ``transfer_dtype`` narrows the features on the host before they are
  copied to the card: float16, bfloat16 (rounded to nearest even by
  torch: numpy has no bf16) or int8 (per-box symmetric quantization with a
  float32 scale, dequantized on the card).  The spatials ``b``, where a
  request has them, ship in the wire's dtype (float16 on the int8 wire,
  ``vqatpu/serve.py:283-290``) and are cast to the compute dtype on the
  card.  BAN with the counter needs them; CTI needs answer tokens; BAN and
  SAN take none (the model's ``inputs``).
- ``compute_dtype="bfloat16"`` runs the forward on a bf16 copy of the
  model that the session holds, cast once; features and spatials are cast
  on the card and the logits come back float32.
- By-id serving (:meth:`InferenceSession.attach_features`,
  :class:`ResidentFeatures`, ``:39-143, 300-404``): the features stay with
  the server, and a request carries image ids and tokens.  With
  ``placement="device"`` the int8 (or float32) box rows, their scales, the
  spatials and an all-zero sentinel row live on the card, and each request
  ships only its ``[N, max_boxes]`` row indices.
- :class:`MicroBatcher` (``:459-625``) coalesces concurrent requests into
  one bucketed forward.

Multiple choice (Visual7W, ``:406-456``): :meth:`InferenceSession.
mc_scores` and :meth:`~InferenceSession.answer_mc` (and the
``MicroBatcher``'s) expand each question over its candidates on the host,
the spatials too, and score each candidate by its class-0 ("match")
softmax probability.

Usage::

    sess = InferenceSession.from_checkpoint(ckpt, model_cfg, label2ans)
    answers = sess.answer(features, spatials, question_tokens, answer_tokens)

(``answer_tokens`` for CTI only, ``spatials`` where the model reads them).
"""

from __future__ import annotations

import bisect
import copy
import os
import pickle
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from vqatpu_torch.config import ModelConfig
from vqatpu_torch.data.device_store import store_flat_arrays, store_rows_table
from vqatpu_torch.data.features import FeatureStore
from vqatpu_torch.data.native import quantize_rows
from vqatpu_torch.models import build_model
from vqatpu_torch.numerics import check_f32_math, require_f32_math
from vqatpu_torch.train.steps import wire_cast
from vqatpu_torch.weights import load_jax_params, load_params_file


def wire_name(transfer_dtype) -> str:
    """The wire ``transfer_dtype`` names: float32 (None), float16, bfloat16
    or int8, given as a name, a numpy type or a torch dtype."""
    if transfer_dtype is None:
        return "float32"
    name = (str(transfer_dtype).replace("torch.", "")
            if isinstance(transfer_dtype, (str, torch.dtype))
            else np.dtype(transfer_dtype).name)
    if name not in ("float32", "float16", "bfloat16", "int8"):
        raise ValueError(f"unknown transfer_dtype {transfer_dtype!r}; expected "
                         "float32, float16, bfloat16 or int8")
    return name


class ResidentFeatures:
    """Server-resident image features for by-id serving: a split's
    :class:`~vqatpu_torch.data.features.FeatureStore` and its image-id
    index."""

    def __init__(self, store: FeatureStore, img_id2idx: dict,
                 max_boxes: int = 50):
        self.store = store
        self.img_id2idx = img_id2idx
        self.max_boxes = max_boxes

    @classmethod
    def from_dataroot(cls, dataroot: str, split: str = "val",
                      max_boxes: int = 50,
                      quantize: bool = False) -> "ResidentFeatures":
        """``{split}_imgid2idx.pkl`` with ``{split}.hdf5`` (needs h5py) or
        ``{split}.npz``, the adaptive layout, else the fixed-36
        ``{split}36`` files.  ``quantize`` keeps the features int8."""
        for suffix, adaptive in (("", True), ("36", False)):
            idx_path = os.path.join(dataroot, f"{split}{suffix}_imgid2idx.pkl")
            if not os.path.exists(idx_path):
                continue
            with open(idx_path, "rb") as f:
                img_id2idx = pickle.load(f)
            h5 = os.path.join(dataroot, f"{split}{suffix}.hdf5")
            if os.path.exists(h5):
                store = FeatureStore.from_hdf5(h5, adaptive=adaptive,
                                               quantize=quantize)
            else:
                store = FeatureStore.from_npz(
                    os.path.join(dataroot, f"{split}{suffix}.npz"))
                if quantize:
                    store = store.quantize()
            return cls(store, img_id2idx, max_boxes)
        raise FileNotFoundError(
            f"no {split}_imgid2idx.pkl or {split}36_imgid2idx.pkl under "
            f"{dataroot}")

    def image_index(self, image_ids: Sequence[int]) -> np.ndarray:
        try:
            return np.asarray([self.img_id2idx[int(i)] for i in image_ids],
                              np.int64)
        except KeyError as e:
            raise KeyError(f"unknown image_id {e.args[0]}: not in this "
                           "split's imgid2idx") from None

    def gather(self, image_ids: Sequence[int]):
        """Host gather and pad: -> (v [N, max_boxes, v_dim] float32,
        b [N, max_boxes, s_dim] float32)."""
        vs, bs = [], []
        for idx in self.image_index(image_ids):
            v, b, _ = self.store.get(int(idx), self.max_boxes)
            vs.append(v)
            bs.append(b)
        return np.stack(vs, 0), np.stack(bs, 0)

    def device_tables(self, quantize: bool = True):
        """The gather tables by-id serving puts on the card: -> ``(feats
        [T+1, v_dim] int8 (float32 when ``quantize`` is False on a float32
        store), scales [T+1] float32 or None, spats [T+1, s_dim], rows_table
        [n_images, max_boxes] int32, sentinel T)``.  Row T is all zero and
        pads every image's row indices."""
        flat_f, scales, flat_sp = store_flat_arrays(self.store)
        if quantize and scales is None:
            flat_f, scales = quantize_rows(flat_f)
        T = flat_f.shape[0]
        feats = np.concatenate(
            [flat_f, np.zeros((1, flat_f.shape[1]), flat_f.dtype)], 0)
        spats = np.concatenate(
            [flat_sp, np.zeros((1, flat_sp.shape[1]), flat_sp.dtype)], 0)
        if scales is not None:
            scales = np.concatenate(
                [np.asarray(scales, np.float32), np.ones((1,), np.float32)])
        rows_table = store_rows_table(self.store, self.max_boxes, sentinel=T)
        return feats, scales, spats, rows_table, T


class InferenceSession:
    def __init__(self, model: torch.nn.Module, label2ans: Sequence[str],
                 batch_buckets: Sequence[int] = (1, 8, 32, 128),
                 max_boxes: int = 50, transfer_dtype=None,
                 compute_dtype: str = "float32", device="cuda"):
        if compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown compute_dtype {compute_dtype!r}; "
                             "expected float32 or bfloat16")
        self.transfer_dtype = wire_name(transfer_dtype)
        require_f32_math()
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self._act = (torch.bfloat16 if compute_dtype == "bfloat16"
                     else torch.float32)
        if compute_dtype == "bfloat16":
            model = copy.deepcopy(model).to(self.device, torch.bfloat16)
        self.model = model.to(self.device).eval()
        self.label2ans = list(label2ans)
        self.batch_buckets = sorted(batch_buckets)
        self.max_boxes = max_boxes
        # forwards run, in all and per bucket size
        self.forwards = 0
        self.bucket_calls: Dict[int, int] = {}
        self._lock = threading.Lock()
        # by-id serving (attach_features)
        self.features: Optional[ResidentFeatures] = None
        self._placement: Optional[str] = None
        self._tables = None  # (feats, scales or None, spats) on the card
        self._rows_table: Optional[np.ndarray] = None
        self._sentinel = -1

    @classmethod
    def from_checkpoint(cls, path: str, cfg: ModelConfig,
                        label2ans: Sequence[str], **kw) -> "InferenceSession":
        model = load_jax_params(build_model(cfg), load_params_file(path))
        return cls(model, label2ans, **kw)

    @property
    def num_classes(self) -> int:
        return self.model.cfg.num_classes

    def _bucket_for(self, n: int) -> int:
        i = bisect.bisect_left(self.batch_buckets, n)
        return self.batch_buckets[min(i, len(self.batch_buckets) - 1)]

    def check_inputs(self, b, a) -> None:
        """Raise where the model needs answer tokens (CTI) or spatials (BAN
        with the counter) that a request lacks."""
        needs = self.model.inputs
        if "a" in needs and a is None:
            raise ValueError(f"{self.model.cfg.model} needs answer tokens")
        if "b" in needs and b is None:
            raise ValueError(f"{self.model.cfg.model} with the counter needs "
                             "spatials")

    def logits(self, v: np.ndarray, b: Optional[np.ndarray], q: np.ndarray,
               a: Optional[np.ndarray] = None) -> np.ndarray:
        """Batched raw logits [N, num_classes] float32.  ``v`` [N, boxes,
        v_dim], ``b`` [N, boxes, s_dim] spatials or None, ``q`` [N, Q] and
        ``a`` [N, A] int tokens or None (:meth:`check_inputs`).  N may
        exceed the largest bucket."""
        self.check_inputs(b, a)
        n = v.shape[0]
        if n == 0:
            return np.zeros((0, self.num_classes), np.float32)
        largest = self.batch_buckets[-1]
        # every chunk is enqueued before the first is read back, so the
        # host packs chunk i+1 while the card runs chunk i
        outs = []
        for s in range(0, n, largest):
            host, rows = self.pack(
                v[s:s + largest], q[s:s + largest],
                None if a is None else a[s:s + largest],
                None if b is None else b[s:s + largest])
            outs.append(self.forward(self.upload(host))[:rows])
        return torch.cat(outs).cpu().numpy()

    def pack(self, v, q, a=None, b=None):
        """One chunk's host arrays as the wire ships them: -> (dict of
        ``v`` (and ``v_scale`` on the int8 wire), ``v_mask``, ``q`` and,
        where the model reads them, ``a`` and ``b``, padded to the bucket;
        the number of real rows)."""
        v = v[:, :self.max_boxes]
        n, boxes = v.shape[:2]
        bucket = self._bucket_for(n)
        vp = np.zeros((bucket, self.max_boxes, v.shape[2]), np.float32)
        vp[:n, :boxes] = v
        mask = np.zeros((bucket, self.max_boxes), bool)
        mask[:n, :boxes] = np.abs(v).sum(-1) != 0
        qp = np.zeros((bucket, q.shape[1]), np.int64)
        qp[:n] = q
        host = {"v": vp, "v_mask": mask, "q": qp}
        needs = self.model.inputs
        if a is not None and "a" in needs:
            host["a"] = np.zeros((bucket, a.shape[1]), np.int64)
            host["a"][:n] = a
        if b is not None and "b" in needs:
            b = np.asarray(b, np.float32)[:, :self.max_boxes]
            host["b"] = np.zeros((bucket, self.max_boxes, b.shape[2]),
                                 np.float32)
            host["b"][:n, :b.shape[1]] = b
        return wire_cast(host, self.transfer_dtype), n

    def upload(self, host: dict) -> dict:
        """Copy :meth:`pack`'s arrays to the session's device."""
        return {k: torch.as_tensor(x).to(self.device) for k, x in host.items()}

    def forward(self, batch: dict) -> torch.Tensor:
        """float32 logits of a bucket on the device; the wire's ``v`` is
        dequantized or cast to the compute dtype there, and so is ``b``
        (``vqatpu/serve.py:197-204``)."""
        act = self._act
        v = batch["v"]
        if "v_scale" in batch:
            v = v.to(act) * batch["v_scale"][..., None].to(act)
        elif v.dtype != act:
            v = v.to(act)
        b = batch.get("b")
        if b is not None and b.dtype != act:
            b = b.to(act)
        bucket = v.shape[0]
        with self._lock, torch.inference_mode():
            check_f32_math("serving path")
            logits, _ = self.model(v, batch["q"], batch.get("a"),
                                   batch["v_mask"], b=b)
            self.forwards += 1
            self.bucket_calls[bucket] = self.bucket_calls.get(bucket, 0) + 1
        return logits.float()

    def answer(self, v, b, q, a=None) -> List[str]:
        """Argmax answer strings for a batch of requests."""
        logits = self.logits(v, b, q, a)
        return [self.label2ans[int(i)] for i in logits.argmax(1)]

    def answer_by_embedding(self, v, b, q, ans_emb: np.ndarray,
                            a=None) -> List[str]:
        """Embedding-distance decoding (``FFOE/test.py:68-75``): the model
        output is an embedding, answered with the nearest row of ``ans_emb
        [num_ans, D]``."""
        pred = self.logits(v, b, q, a)
        d = np.linalg.norm(pred[:, None, :] - ans_emb[None, :, :], axis=2)
        return [self.label2ans[int(i)] for i in d.argmin(1)]

    def mc_scores(self, v, b, q, ans_mc: np.ndarray) -> np.ndarray:
        """Candidate match probabilities of a multiple-choice (2-class)
        model: ``ans_mc`` [N, C, A] candidate tokens -> [N, C]
        (:func:`mc_scores`)."""
        return mc_scores(self.logits, v, b, q, ans_mc)

    def answer_mc(self, v, b, q, ans_mc: np.ndarray,
                  candidates: Optional[Sequence[Sequence[str]]] = None):
        """Each question's best candidate: indices [N], or with
        ``candidates`` ([N][C] strings, which come with the request) the
        strings."""
        return answer_mc(self.logits, v, b, q, ans_mc, candidates)

    # -- by-id serving ----------------------------------------------------
    def attach_features(self, features: ResidentFeatures,
                        placement: str = "device",
                        quantize: bool = True) -> None:
        """Enable :meth:`logits_by_id` and :meth:`answer_by_id`.
        ``placement="device"`` copies the store's gather tables to the card
        once (int8 rows unless ``quantize`` is False on a float32 store);
        ``placement="host"`` gathers on the host and takes the upload
        path."""
        if placement not in ("device", "host"):
            raise ValueError(f"placement {placement!r}: device or host")
        if features.max_boxes != self.max_boxes:
            raise ValueError(f"the features pad to {features.max_boxes} "
                             f"boxes, the session to {self.max_boxes}")
        self.features = features
        self._placement = placement
        self._tables = self._rows_table = None
        if placement == "device":
            feats, scales, spats, self._rows_table, self._sentinel = (
                features.device_tables(quantize=quantize))
            self._tables = tuple(
                None if x is None else torch.from_numpy(x).to(self.device)
                for x in (feats, scales, spats))

    def logits_by_id(self, image_ids: Sequence[int], q: np.ndarray,
                     a: Optional[np.ndarray] = None) -> np.ndarray:
        """Batched raw logits from server-resident features: ``image_ids``
        [N] (the split's image ids), ``q`` [N, Q] tokens and ``a`` [N, A]
        where the model reads them.  Chunked like :meth:`logits`.  On the
        card each bucket's boxes and spatials are gathered from the
        resident rows, dequantized, and masked where a row index is the
        sentinel (``vqatpu/serve.py:333-351``)."""
        if self.features is None:
            raise RuntimeError("call attach_features() first")
        self.check_inputs(True, a)  # the spatials are resident
        if len(image_ids) == 0:
            return np.zeros((0, self.num_classes), np.float32)
        if self._placement == "host":
            v, b = self.features.gather(image_ids)
            return self.logits(v, b, q, a)
        rows_all = self._rows_table[self.features.image_index(image_ids)]
        largest = self.batch_buckets[-1]
        outs = []
        for s in range(0, rows_all.shape[0], largest):
            rows, qc = rows_all[s:s + largest], q[s:s + largest]
            m = rows.shape[0]
            bucket = self._bucket_for(m)
            rp = np.full((bucket, rows.shape[1]), self._sentinel, np.int32)
            rp[:m] = rows
            qp = np.zeros((bucket, qc.shape[1]), np.int64)
            qp[:m] = qc
            ap = None
            if a is not None:
                ap = np.zeros((bucket, a.shape[1]), np.int64)
                ap[:m] = a[s:s + largest]
            outs.append(self.forward_by_id(
                *(None if x is None else torch.from_numpy(x).to(self.device)
                  for x in (rp, qp, ap)))[:m])
        return torch.cat(outs).cpu().numpy()

    def forward_by_id(self, rows: torch.Tensor, q: torch.Tensor,
                      a: Optional[torch.Tensor] = None) -> torch.Tensor:
        """float32 logits of one bucket whose boxes are ``rows`` [bucket,
        max_boxes] into the resident tables, on the device."""
        feats, scales, spats = self._tables
        flat = rows.reshape(-1).long()
        v = feats.index_select(0, flat).view(*rows.shape, feats.shape[1])
        act = self._act
        if scales is not None:
            v = v.to(act) * scales.index_select(0, flat).view(rows.shape)[
                ..., None].to(act)
        elif v.dtype != act:
            v = v.to(act)
        batch = {"v": v, "q": q, "v_mask": rows != self._sentinel}
        if "b" in self.model.inputs:
            batch["b"] = spats.index_select(0, flat).view(*rows.shape, -1)
        if a is not None:
            batch["a"] = a
        return self.forward(batch)

    def answer_by_id(self, image_ids: Sequence[int], q: np.ndarray,
                     a: Optional[np.ndarray] = None) -> List[str]:
        logits = self.logits_by_id(image_ids, q, a)
        return [self.label2ans[int(i)] for i in logits.argmax(1)]


def mc_scores(logits_fn, v, b, q, ans_mc: np.ndarray) -> np.ndarray:
    """The candidate expansion and class-0 softmax over any ``logits(v, b,
    q, a)`` (``vqatpu/serve.py:439-452``): each question's ``v``, ``b``
    and ``q`` repeat once per candidate, the spatials too (JAX's fix of the
    reference's BAN, which forgets them), and ``ans_mc`` [N, C, A]
    flattens to the rows' answer tokens -> [N, C] match probabilities."""
    ans_mc = np.asarray(ans_mc)
    n, c = ans_mc.shape[:2]
    vx = np.repeat(v, c, axis=0)
    bx = None if b is None else np.repeat(b, c, axis=0)
    qx = np.repeat(q, c, axis=0)
    logits = logits_fn(vx, bx, qx, ans_mc.reshape(n * c, -1))
    z = logits - logits.max(1, keepdims=True)
    p = np.exp(z)
    p /= p.sum(1, keepdims=True)
    return p[:, 0].reshape(n, c)


def answer_mc(logits_fn, v, b, q, ans_mc, candidates=None):
    """The argmax of :func:`mc_scores` per question: indices, or the
    ``candidates`` strings."""
    pick = mc_scores(logits_fn, v, b, q, ans_mc).argmax(1)
    if candidates is None:
        return pick.tolist()
    return [candidates[i][j] for i, j in enumerate(pick)]


class MicroBatcher:
    """Coalesces concurrent requests into one bucketed forward of an
    :class:`InferenceSession` (``vqatpu/serve.py:459-625``).

    The HTTP server runs a thread per connection; without coalescing, K
    concurrent single-row requests run K bucket-1 forwards one after
    another.  The batcher parks each caller on an event, drains the queue
    up to ``max_batch`` rows (waiting at most ``max_wait_ms`` after the
    first request), runs one forward per compatibility group (requests that
    agree on spatials and answer tokens being present, question width,
    feature width and answer width) and hands each caller its rows.  A
    malformed request fails only its own caller, and the worker thread
    never dies.  By-id requests carry no features and bypass it."""

    def __init__(self, session: InferenceSession, max_batch: int = 32,
                 max_wait_ms: float = 3.0):
        self.session = session
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self._q: queue.Queue = queue.Queue()
        self._stop = False
        self.batches_run = 0  # forwards dispatched
        self.rows_served = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="vqatpu-torch-microbatcher")
        self._thread.start()

    # -- caller side ------------------------------------------------------
    def logits(self, v, b, q, a=None) -> np.ndarray:
        """Blocking; the contract of ``InferenceSession.logits``."""
        v = np.asarray(v, np.float32)
        done = threading.Event()
        slot: dict = {}
        self._q.put((v, b, q, a, done, slot))
        done.wait()
        if "err" in slot:
            raise slot["err"]
        return slot["out"]

    def answer(self, v, b, q, a=None) -> List[str]:
        logits = self.logits(v, b, q, a)
        return [self.session.label2ans[int(i)] for i in logits.argmax(1)]

    def mc_scores(self, v, b, q, ans_mc) -> np.ndarray:
        """As :meth:`InferenceSession.mc_scores`; the expanded rows
        coalesce with the other queued requests."""
        return mc_scores(self.logits, v, b, q, ans_mc)

    def answer_mc(self, v, b, q, ans_mc, candidates=None):
        return answer_mc(self.logits, v, b, q, ans_mc, candidates)

    @property
    def features(self):
        return self.session.features

    def logits_by_id(self, image_ids, q, a=None):
        return self.session.logits_by_id(image_ids, q, a)

    def answer_by_id(self, image_ids, q, a=None):
        return self.session.answer_by_id(image_ids, q, a)

    def close(self):
        self._stop = True
        self._q.put(None)  # wake the worker
        self._thread.join(timeout=5)

    # -- worker side ------------------------------------------------------
    def _drain(self, first):
        """Up to max_batch rows, waiting at most max_wait after the first
        request arrived."""
        items = [first]
        rows = first[0].shape[0]
        deadline = time.monotonic() + self.max_wait
        while rows < self.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                item = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if item is None:  # close(): requeue for the loop
                self._q.put(None)
                break
            items.append(item)
            rows += item[0].shape[0]
        return items

    @staticmethod
    def _group_key(v, b, q, a):
        return (b is None, a is None, q.shape[1],
                v.shape[2] if v.ndim == 3 else -1,
                None if a is None else np.asarray(a).shape[1])

    def _run_group(self, items):
        sess = self.session

        def pad_boxes(x):
            if x.shape[1] >= sess.max_boxes:
                return x[:, :sess.max_boxes]
            pad = np.zeros((x.shape[0], sess.max_boxes - x.shape[1])
                           + x.shape[2:], x.dtype)
            return np.concatenate([x, pad], 1)

        # assembly is inside the try: a malformed request must fail its
        # waiting callers, not kill the worker thread
        try:
            counts = [it[0].shape[0] for it in items]
            V = np.concatenate([pad_boxes(it[0]) for it in items], 0)
            b0 = items[0][1]
            B = (None if b0 is None else np.concatenate(
                [pad_boxes(np.asarray(it[1], np.float32)) for it in items], 0))
            Q = np.concatenate([np.asarray(it[2], np.int32) for it in items], 0)
            a0 = items[0][3]
            A = (None if a0 is None else np.concatenate(
                [np.asarray(it[3], np.int32) for it in items], 0))
            out = sess.logits(V, B, Q, A)
            self.batches_run += 1
            self.rows_served += sum(counts)
        except Exception as e:
            for _v, _b, _q, _a, done, slot in items:
                slot["err"] = e
                done.set()
            return
        at = 0
        for (_v, _b, _q, _a, done, slot), n in zip(items, counts):
            slot["out"] = out[at:at + n]
            at += n
            done.set()

    def _loop(self):
        while True:
            item = self._q.get()
            if item is None:
                if self._stop:
                    return
                continue
            items = self._drain(item)
            groups: dict = {}
            for it in items:
                try:
                    key = self._group_key(*it[:4])
                except Exception as e:  # malformed: fail only its caller
                    it[5]["err"] = e
                    it[4].set()
                    continue
                groups.setdefault(key, []).append(it)
            for group in groups.values():
                try:
                    self._run_group(group)
                except BaseException as e:  # the worker must never die:
                    # parked callers would wait forever
                    for _v, _b, _q, _a, done, slot in group:
                        slot.setdefault("err", e)
                        done.set()
