"""Region-feature store, a copy of ``vqatpu.data.features.FeatureStore``
(``vqatpu/data/features.py:76-206``).

Layouts:
- fixed:    ``image_features [N, K, v_dim]``, ``spatial_features [N, K, 6]``;
- adaptive: ``image_features [total_boxes, v_dim]`` with ``pos_boxes
  [N, 2]`` (start, end) rows per image, 10-100 boxes each.

Every sample is padded to a static ``max_boxes`` (:meth:`FeatureStore.get`).
``quantize`` keeps the resident features int8 with a float32 scale per box
row (the C++ :func:`vqatpu_torch.data.native.quantize_rows`), 4x less
memory.
``from_hdf5(in_memory=False)`` keeps the file open and reads each image's
rows when it is asked for (the streaming mode, for hosts with less memory
than the split), with the small ``pos_boxes`` table resident; ``close``
closes the file and ``materialize`` reads it whole.  ``.npz`` files need
only numpy; ``.hdf5`` files need ``h5py``, imported when one is opened.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from vqatpu_torch.data.native import quantize_rows

# float32 bytes of the HDF5 features quantized at a time by
# from_hdf5(quantize=True), so the float32 block is never whole in memory
QUANTIZE_CHUNK_BYTES = 1 << 26


class ZeroArray:
    """A lazy all-zero stand-in for spatials that are zero by construction
    (the Visual7W grid path, ``vqatpu/data/features.py:39-60``): a
    streaming store gets no features-sized block of zeros.  Takes the
    integer and slice indexing of the leading axis that
    :meth:`FeatureStore.get` uses; ``np.asarray`` of it is a real block of
    zeros (:meth:`FeatureStore.materialize`, the C++ store's
    registration)."""

    def __init__(self, shape):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = np.dtype(np.float32)

    def __getitem__(self, idx):
        if isinstance(idx, (int, np.integer)):
            return np.zeros(self.shape[1:], np.float32)
        if isinstance(idx, slice):
            n = len(range(*idx.indices(self.shape[0])))
            return np.zeros((n,) + self.shape[1:], np.float32)
        raise TypeError(f"ZeroArray takes an int or a slice, not {idx!r}")

    def __array__(self, dtype=None, copy=None):
        return np.zeros(self.shape, dtype or self.dtype)


def _h5py():
    try:
        import h5py
    except ImportError:
        raise ImportError("reading .hdf5 features needs h5py, which is not "
                          "installed; store the split as .npz "
                          "(image_features, spatial_features, pos_boxes)") from None
    return h5py


class FeatureStore:
    def __init__(self, features, spatials,
                 pos_boxes: Optional[np.ndarray] = None, h5file=None,
                 feat_scales: Optional[np.ndarray] = None):
        self.features = features
        self.spatials = spatials
        self.pos_boxes = pos_boxes
        self._h5 = h5file  # the open file of a streaming store
        # int8-resident mode: per-box-row scales ([total_boxes] adaptive,
        # [N, K] fixed); None for float32 stores
        self.feat_scales = feat_scales

    @property
    def adaptive(self) -> bool:
        return self.pos_boxes is not None

    @property
    def quantized(self) -> bool:
        """True when the resident features are int8 (with ``feat_scales``)."""
        return self.feat_scales is not None

    @property
    def in_memory(self) -> bool:
        """False when features and spatials are open HDF5 datasets."""
        return self._h5 is None

    @property
    def v_dim(self) -> int:
        return int(self.features.shape[1 if self.adaptive else 2])

    @property
    def s_dim(self) -> int:
        return int(self.spatials.shape[1 if self.adaptive else 2])

    @classmethod
    def from_hdf5(cls, path: str, adaptive: bool = True,
                  in_memory: bool = True, quantize: bool = False
                  ) -> "FeatureStore":
        """With ``quantize`` the features are quantized chunk by chunk as
        they are read, so the float32 block is never whole in memory (a
        resident store only).  ``in_memory=False`` streams: the file stays
        open until :meth:`close`."""
        if quantize and not in_memory:
            raise ValueError(
                "quantize=True requires a resident store: the int8 store is "
                "the low-memory mode (4x less memory than float32)")
        if not in_memory:
            hf = _h5py().File(path, "r")
            pos_boxes = np.asarray(hf.get("pos_boxes")) if adaptive else None
            return cls(hf["image_features"], hf["spatial_features"],
                       pos_boxes, h5file=hf)
        with _h5py().File(path, "r") as hf:
            feats = hf["image_features"]
            spatials = np.asarray(hf.get("spatial_features"))
            pos_boxes = np.asarray(hf.get("pos_boxes")) if adaptive else None
            if not quantize:
                return cls(np.asarray(feats), spatials, pos_boxes)
            q = np.empty(feats.shape, np.int8)
            scales = np.empty(feats.shape[:-1], np.float32)
            chunk = max(1, QUANTIZE_CHUNK_BYTES // max(
                1, int(np.prod(feats.shape[1:])) * 4))
            for lo in range(0, feats.shape[0], chunk):
                hi = min(feats.shape[0], lo + chunk)
                q[lo:hi], scales[lo:hi] = quantize_rows(feats[lo:hi])
        return cls(q, spatials, pos_boxes, feat_scales=scales)

    @classmethod
    def from_npz(cls, path: str) -> "FeatureStore":
        with np.load(path) as data:
            pos = data["pos_boxes"] if "pos_boxes" in data.files else None
            return cls(data["image_features"], data["spatial_features"], pos)

    def quantize(self) -> "FeatureStore":
        """An int8-resident copy of a float32 resident store (itself when
        already quantized)."""
        if self.quantized:
            return self
        if not self.in_memory:
            raise ValueError("quantize a streaming store with "
                             "from_hdf5(quantize=True)")
        q, scales = quantize_rows(self.features)
        return FeatureStore(q, self.spatials, self.pos_boxes,
                            feat_scales=scales)

    def materialize(self) -> "FeatureStore":
        """A resident copy of a streaming store (itself when resident)."""
        if self.in_memory:
            return self
        return FeatureStore(np.asarray(self.features),
                            np.asarray(self.spatials), self.pos_boxes)

    def close(self) -> None:
        """Close a streaming store's file; a resident store has none."""
        if self._h5 is not None:
            self._h5.close()
            self._h5 = None

    def get(self, image_idx: int, max_boxes: int
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """-> (features [max_boxes, v_dim] float32, spatials [max_boxes,
        s_dim], mask [max_boxes] bool); padded rows are zero."""
        if self.adaptive:
            s, e = self.pos_boxes[image_idx]
            e = min(int(e), int(s) + max_boxes)
            feats = self.features[int(s):e]
            spats = self.spatials[int(s):e]
            if self.quantized:
                feats = (feats.astype(np.float32)
                         * self.feat_scales[int(s):e, None])
        else:
            feats = self.features[int(image_idx)][:max_boxes]
            spats = self.spatials[int(image_idx)][:max_boxes]
            if self.quantized:
                feats = (feats.astype(np.float32)
                         * self.feat_scales[int(image_idx)][:max_boxes, None])
        n = feats.shape[0]
        out_f = np.zeros((max_boxes, feats.shape[1]), np.float32)
        out_s = np.zeros((max_boxes, spats.shape[1]), np.float32)
        out_f[:n] = feats
        out_s[:n] = spats
        mask = np.zeros((max_boxes,), bool)
        mask[:n] = True
        return out_f, out_s, mask
