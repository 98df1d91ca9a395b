"""The card-resident feature store (``vqatpu/data/device_store.py``): the
feature table goes to the card once, and each batch's boxes are gathered
there by index.

Without it, every training step ships the batch's ``[B, boxes, 2048]``
feature slab from host memory (105 MB at B=256 in float32).  With it:

- the whole store lives on the card as flat box-row tables, int8 rows with
  a float32 scale per row when the wire is int8 (about 10 GB for VQA-2.0
  trainval adaptive at 2048-d), plus one all-zero sentinel row that pads
  every image to ``max_boxes``;
- per batch the host ships only the ``rows`` slab (``[B, max_boxes]``
  int32 flat row indices, 50 KB at B=256), from a page-locked double
  buffer (:class:`vqatpu_torch.data.upload.PinnedUploader`), beside the
  question, answer and target fields; ``index_select`` on the card
  materializes ``v``/``v_scale``/``b``/``v_mask``.

The gathered batch is bit for bit the wire path's for every
``transfer_dtype``: the tables are cast by the wire's own host cast
(``train.steps.wire_cast``), once at build instead of once a batch.  So trajectories with the store equal those without.

The helpers :func:`store_flat_arrays` and :func:`store_rows_table` also
give by-id serving its tables (:class:`vqatpu_torch.serve.
ResidentFeatures`).  The decision helpers follow JAX's: ``auto`` builds the
store where the dataset can take it and its estimated size fits the
budget, half the card's free memory (``VQATPU_DEVSTORE_BUDGET_MB``
overrides it; 4 GiB on a CPU device).

The row-sharded store (``shard=True``, ``vqatpu/data/device_store.py:
340-366, 429-470``) is for tables larger than one card: each rank of the
mesh's data axis holds ``t_local = ceil(T / n)`` consecutive rows of the
tables (the sentinel among them, the last rank's padded with zero rows).
Each gather all-gathers the ranks' index slabs, gathers and dequantizes to
float32 the rows it owns, zeroes the others, and a reduce-scatter over the
batch axis hands each rank its own rows.  Every row is owned by exactly
one rank and the others add exact zeros, so ``v`` and ``b`` equal the
replicated store's after the step's upcast, bit for bit; they come out
float32, with no ``v_scale``, as JAX's do.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from vqatpu_torch.data.native import dataset_members
from vqatpu_torch.data.upload import PinnedUploader
from vqatpu_torch.parallel.collectives import Group
from vqatpu_torch.train.steps import wire_cast

# box rows cast or quantized at a time while a store is built, so that no
# float32 copy of the whole table is ever made on the host
BUILD_CHUNK_ROWS = 1 << 16


def store_flat_arrays(store) -> Tuple[np.ndarray, Optional[np.ndarray],
                                      np.ndarray]:
    """-> ``(flat_f [T, v_dim], scales [T] or None, flat_sp [T, s_dim])``.
    Adaptive stores are already flat; fixed ``[N, K, ...]`` stores reshape."""
    if store.adaptive:
        flat_f = np.asarray(store.features)
        flat_sp = np.asarray(store.spatials)
        scales = store.feat_scales
        if scales is not None:
            scales = np.asarray(scales, np.float32)
    else:
        f = np.asarray(store.features)
        flat_f = f.reshape(-1, f.shape[-1])
        flat_sp = np.asarray(store.spatials).reshape(-1, store.s_dim)
        scales = (None if store.feat_scales is None
                  else np.asarray(store.feat_scales, np.float32).reshape(-1))
    return flat_f, scales, flat_sp


def store_rows_table(store, max_boxes: int, row_offset: int = 0, *,
                     sentinel: int) -> np.ndarray:
    """Per-image ``[n_images, max_boxes]`` int32 table of flat row indices
    (``row_offset`` added, for stores concatenated into one table), padded
    with ``sentinel`` (an all-zero row).  The box selection is
    :meth:`FeatureStore.get`'s: adaptive images clip to ``max_boxes`` boxes
    from ``pos_boxes``, fixed images take the first ``min(K, max_boxes)``."""
    if store.adaptive:
        pos = np.asarray(store.pos_boxes)
        n_images = pos.shape[0]
        table = np.full((n_images, max_boxes), sentinel, np.int32)
        for i, (lo, hi) in enumerate(pos):
            c = min(int(hi) - int(lo), max_boxes)
            table[i, :c] = row_offset + np.arange(int(lo), int(lo) + c)
    else:
        n_images, k = np.asarray(store.features).shape[:2]
        c = min(k, max_boxes)
        table = np.full((n_images, max_boxes), sentinel, np.int32)
        table[:, :c] = (row_offset + np.arange(n_images)[:, None] * k
                        + np.arange(c)[None, :])
    return table


def _unique_stores(dataset) -> list:
    stores, seen = [], set()
    for d in dataset_members(dataset):
        if id(d.store) not in seen:
            seen.add(id(d.store))
            stores.append(d.store)
    return stores


def devstore_capable(dataset, task: str = "ffoe") -> Tuple[bool, str]:
    """Whether :meth:`DeviceFeatureStore.build` can take this dataset: every
    member (of a ``ConcatDataset`` too) has an in-memory FeatureStore and
    entries with image indices.  The multiple-choice ``V7WDataset``
    qualifies too: its loader ships ``ds_idx``, which the ``x4`` expansion
    repeats, and the gather of the repeated indices gives the expanded
    slabs (:func:`~vqatpu_torch.data.mc_dataset.expand_mc_batch`)."""
    if task not in ("ffoe", "mc"):
        return False, f"device_features does not support task {task!r}"
    for d in dataset_members(dataset):
        if not (hasattr(d, "store") and hasattr(d, "entries")):
            return False, "dataset has no FeatureStore/entries"
        if not getattr(d.store, "in_memory", True):
            return False, ("streaming store (--stream_features) can't be "
                           "uploaded to HBM — drop one of the two flags")
    return True, ""


def normalize_device_features(value) -> str:
    """The tri-state ``--device_features``: ``"auto"`` (the default: build
    where the dataset can take it and the tables fit the budget), ``"on"``
    (build, declining with the reason where it cannot), ``"off"``.  True
    and False mean on and off."""
    if value is True:
        return "on"
    if value is False or value is None:
        return "off"
    v = str(value).lower()
    if v not in ("auto", "on", "off"):
        raise ValueError(
            f"device_features must be auto/on/off, got {value!r}")
    return v


def _want_int8(stores, transfer_dtype: str) -> bool:
    """int8 rows and scales under the int8 wire, and under the float32 wire
    when every store is int8-resident (dequantized on the card, as the host
    path's ``FeatureStore.get`` does)."""
    return transfer_dtype == "int8" or (
        transfer_dtype == "float32"
        and all(s.feat_scales is not None for s in stores))


def estimate_hbm_bytes(dataset, transfer_dtype: str = "float32") -> int:
    """The card memory :meth:`DeviceFeatureStore.build` takes, from the
    shapes alone (its dtype rules, without the one sentinel row): what the
    ``auto`` decision weighs against the budget before anything is
    allocated."""
    stores = _unique_stores(dataset)
    want_int8 = _want_int8(stores, transfer_dtype)
    wire_width = {"float32": 4, "float16": 2, "bfloat16": 2, "int8": 1}
    total = 0
    for s in stores:
        f_shape = np.shape(s.features)
        rows = f_shape[0] if s.adaptive else f_shape[0] * f_shape[1]
        v_dim = f_shape[-1]
        s_dim = np.shape(s.spatials)[-1]
        per_feat = (v_dim + 4) if want_int8 \
            else v_dim * wire_width[transfer_dtype]
        per_sp = s_dim * (2 if transfer_dtype != "float32" else 4)
        total += rows * (per_feat + per_sp)
    return int(total)


def hbm_budget_bytes(device=None) -> Tuple[int, str]:
    """(budget, its source) of the ``auto`` decision: the
    ``VQATPU_DEVSTORE_BUDGET_MB`` override if set; on a CUDA device half of
    its free memory (``torch.cuda.mem_get_info`` plus what PyTorch's
    allocator holds unused), leaving room for what the step allocates
    later; else 4 GiB."""
    env = os.environ.get("VQATPU_DEVSTORE_BUDGET_MB")
    if env:
        return int(float(env) * 2**20), "VQATPU_DEVSTORE_BUDGET_MB"
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda":
        free, _ = torch.cuda.mem_get_info(dev)
        cached = (torch.cuda.memory_reserved(dev)
                  - torch.cuda.memory_allocated(dev))
        return (free + cached) // 2, "50% of free device memory"
    return 4 * 2**30, "4 GiB default (no device memory stats)"


def devstore_decision(dataset, mode, transfer_dtype: str,
                      task: str = "ffoe", shard: bool = False,
                      device=None) -> Tuple[bool, str]:
    """The tri-state knob -> ``(build?, reason if not)``.  ``off``: (False,
    "").  ``on`` (or ``shard``, which implies it): the capability check
    only.  ``auto``: the capability check and the estimate against
    :func:`hbm_budget_bytes` of ``device``."""
    mode = normalize_device_features(mode)
    if shard:
        mode = "on"
    if mode == "off":
        return False, ""
    ok, why = devstore_capable(dataset, task)
    if not ok:
        return False, why
    if mode == "auto":
        est = estimate_hbm_bytes(dataset, transfer_dtype)
        budget, src = hbm_budget_bytes(device)
        if est > budget:
            return False, (
                f"auto: estimated tables {est / 2**20:.0f} MiB exceed the "
                f"budget {budget / 2**20:.0f} MiB ({src}) — force with "
                "--device_features on, or row-shard across the mesh with "
                "--shard_feature_store")
    return True, ""


def _to(x, device) -> torch.Tensor:
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


_TORCH_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                 "bfloat16": torch.bfloat16}


class DeviceFeatureStore:
    """The card's gather tables and the per-batch gather (replicated mode,
    ``vqatpu/data/device_store.py:218-428``).  Build with :meth:`build`;
    per batch call :meth:`gather` with the loader's ``ds_idx`` (dataset
    sample indices) for the ``v``/``v_scale``/``b``/``v_mask`` tensors the
    train and eval steps take.  ``rows_table`` covers the images of every
    member dataset, each distinct store once (the VisualGenome member
    shares its split's store)."""

    def __init__(self, feats: torch.Tensor, scales: Optional[torch.Tensor],
                 spats: torch.Tensor, rows_table: np.ndarray,
                 sample_img: np.ndarray, sentinel: int, group=None):
        self.feats = feats           # [T + 1, v_dim] on the card (sharded:
        self.scales = scales         # [T + 1] float32, or None   this rank's
        self.spats = spats           # [T + 1, s_dim]          t_local rows)
        self.rows_table = rows_table  # host [n_images_total, max_boxes]
        self.sample_img = sample_img  # host [n_samples] -> rows_table row
        self.sentinel = int(sentinel)
        self.group = group  # the data axis of a sharded store, else None
        self.device = feats.device
        self._upload = PinnedUploader(self.device)

    @property
    def sharded(self) -> bool:
        return self.group is not None

    @classmethod
    def build(cls, dataset, transfer_dtype: str = "float32", device="cuda",
              shard: bool = False, mesh=None) -> "DeviceFeatureStore":
        """Put the dataset's store(s) on ``device`` as gather tables, in the
        wire's dtypes (``train.steps.wire_cast``), so that gathered batches
        are the host-shipped ones bit for bit:

        - ``int8``: int8 rows and float32 scales (a float32 store quantized
          by the wire's C++ quantizer, an int8-resident one as it is),
          float16 spatials;
        - ``float16``/``bfloat16``: rows and spatials cast by the wire (an
          int8-resident store dequantized first, as the host path's
          ``FeatureStore.get`` does);
        - ``float32``: float32 rows, unless every store is int8-resident
          (``--quantize_store``): then the rows stay int8 and the step
          dequantizes them on the card (the same ``q * s`` product).

        The tables are filled ``BUILD_CHUNK_ROWS`` rows at a time.
        ``shard``: this rank's rows only, over ``mesh``'s data axis (one
        rank without a mesh; see the module docstring)."""
        if transfer_dtype not in ("float32", "float16", "bfloat16", "int8"):
            raise ValueError(f"unknown transfer_dtype {transfer_dtype!r}")
        device = torch.device(device)
        members = dataset_members(dataset)
        stores = _unique_stores(dataset)
        max_boxes = {d.max_boxes for d in members}
        if len(max_boxes) != 1:
            raise ValueError(f"members disagree on max_boxes: {max_boxes}")
        max_boxes = max_boxes.pop()

        flats = [store_flat_arrays(s) for s in stores]
        want_int8 = _want_int8(stores, transfer_dtype)
        n_rows = sum(f[0].shape[0] for f in flats)
        v_dim, s_dim = flats[0][0].shape[1], flats[0][2].shape[1]
        sentinel = n_rows  # the all-zero row after the last store's rows
        group = None
        if shard:
            group = (mesh.data if mesh is not None
                     else Group(None, [0], 0, None))
        n_dev = 1 if group is None else group.size
        t_local = -(-(n_rows + 1) // n_dev)  # this rank's rows
        base = 0 if group is None else group.index * t_local
        # b's dtype follows the wire alone: float16 under int8, untouched
        # under float32 (also when the resident v stays int8)
        spat_dtype = "float16" if transfer_dtype == "int8" else transfer_dtype
        spats = torch.zeros((t_local, s_dim),
                            dtype=_TORCH_DTYPES[spat_dtype], device=device)
        if want_int8:
            feats = torch.zeros((t_local, v_dim), dtype=torch.int8,
                                device=device)
            scales = torch.ones((t_local,), dtype=torch.float32,
                                device=device)
        else:
            feats = torch.zeros((t_local, v_dim),
                                dtype=_TORCH_DTYPES[transfer_dtype],
                                device=device)
            scales = None
        off = -base  # a store's first row, in this rank's table
        for flat_f, sc, flat_sp in flats:
            rows = flat_f.shape[0]
            for lo in range(max(0, -off), min(rows, t_local - off),
                            BUILD_CHUNK_ROWS):
                hi = min(rows, t_local - off, lo + BUILD_CHUNK_ROWS)
                chunk = {"v": flat_f[lo:hi], "b": flat_sp[lo:hi]}
                if sc is not None and want_int8:
                    chunk["v_scale"] = sc[lo:hi]  # resident: wired already
                elif sc is not None:  # FeatureStore.get's dequantization
                    chunk["v"] = chunk["v"].astype(np.float32) * sc[lo:hi, None]
                chunk = wire_cast(chunk, transfer_dtype)
                feats[off + lo:off + hi] = _to(chunk["v"], device)
                spats[off + lo:off + hi] = _to(chunk["b"], device)
                if want_int8:
                    scales[off + lo:off + hi] = _to(chunk["v_scale"], device)
            off += flat_f.shape[0]

        # per-image row tables, one block per distinct store
        tables, row_off, img_off = [], 0, {}
        for s, flat in zip(stores, flats):
            img_off[id(s)] = sum(t.shape[0] for t in tables)
            tables.append(store_rows_table(s, max_boxes, row_off,
                                           sentinel=sentinel))
            row_off += flat[0].shape[0]
        rows_table = np.concatenate(tables, 0)
        # dataset sample index -> row of rows_table, in ConcatDataset order
        sample_img = np.concatenate([
            np.asarray([e["image"] for e in d.entries], np.int64)
            + img_off[id(d.store)] for d in members])
        return cls(feats, scales, spats, rows_table, sample_img, sentinel,
                   group)

    @property
    def hbm_bytes(self) -> int:
        return int(sum(t.numel() * t.element_size()
                       for t in (self.feats, self.scales, self.spats)
                       if t is not None))

    def describe(self) -> str:
        dtype = str(self.feats.dtype).replace("torch.", "")
        kind = ("replicated" if self.group is None else
                f"sharded, rank {self.group.index} of {self.group.size}")
        return (f"{self.feats.shape[0]} box rows x {self.feats.shape[1]}d "
                f"{dtype}, {self.hbm_bytes / 2**20:.1f} MiB on "
                f"{self.device} ({kind}), {self.rows_table.shape[0]} "
                "images")

    def rows_for(self, ds_idx) -> np.ndarray:
        """The host half: dataset sample indices ``[B]`` -> flat row indices
        ``[B, max_boxes]`` int32.  A negative index (the loader's padding of
        a final batch) maps to all-sentinel rows: zero boxes, an all-False
        mask, as the wire path's zero-padded rows."""
        ds_idx = np.asarray(ds_idx, np.int64)
        rows = self.rows_table[self.sample_img[np.maximum(ds_idx, 0)]]
        if (ds_idx < 0).any():
            rows = np.where(ds_idx[:, None] < 0, np.int32(self.sentinel),
                            rows)
        return rows

    def gather(self, ds_idx) -> dict:
        """The batch's slabs on the card: ``{"v", "b", "v_mask"[,
        "v_scale"]}`` in the dtypes the wire ships (see :meth:`build`).
        The ``rows`` slab goes up from a page-locked double buffer."""
        rows = self._upload({"rows": self.rows_for(ds_idx)})["rows"]
        if self.group is not None:
            return self._gather_sharded(rows)
        flat = rows.reshape(-1)
        shape = tuple(rows.shape)
        out = {"v": self.feats.index_select(0, flat).view(*shape, -1),
               "b": self.spats.index_select(0, flat).view(*shape, -1),
               "v_mask": rows != self.sentinel}
        if self.scales is not None:
            out["v_scale"] = self.scales.index_select(0, flat).view(shape)
        return out

    def _gather_sharded(self, rows: torch.Tensor) -> dict:
        """The row-sharded gather: ``rows`` are this rank's ``[b,
        max_boxes]``; -> float32 ``v``, ``b`` and ``v_mask`` for them."""
        group, t_local = self.group, self.feats.shape[0]
        rows_all = group.all_gather(rows, 0)  # every rank's, in rank order
        loc = rows_all.long() - group.index * t_local
        owned = ((loc >= 0) & (loc < t_local))[..., None]
        flat = loc.clamp(0, t_local - 1).reshape(-1)
        shape = tuple(rows_all.shape)
        v = self.feats.index_select(0, flat).view(*shape, -1).float()
        if self.scales is not None:
            v = v * self.scales.index_select(0, flat).view(shape)[..., None]
        sp = self.spats.index_select(0, flat).view(*shape, -1).float()
        zero = torch.zeros((), dtype=torch.float32, device=v.device)
        return {"v": group.reduce_scatter(torch.where(owned, v, zero), 0),
                "b": group.reduce_scatter(torch.where(owned, sp, zero), 0),
                "v_mask": rows != self.sentinel}
