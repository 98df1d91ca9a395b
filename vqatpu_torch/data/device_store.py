"""Flat box-row tables of a :class:`~vqatpu_torch.data.features.FeatureStore`,
the serving half of ``vqatpu/data/device_store.py:48-90``: by-id serving
(:class:`vqatpu_torch.serve.ResidentFeatures`) puts them on the card and
gathers each request's boxes there.  The training store built on them
(``DeviceFeatureStore``) waits for the datasets of ROADMAP queue A item 4.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


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


def store_rows_table(store, max_boxes: int, sentinel: int) -> np.ndarray:
    """Per-image ``[n_images, max_boxes]`` int32 table of flat row indices,
    padded with ``sentinel`` (an all-zero row).
    The box selection is :meth:`FeatureStore.get`'s: adaptive images clip
    to ``max_boxes`` boxes from ``pos_boxes``, fixed images take the first
    ``min(K, max_boxes)``."""
    if store.adaptive:
        pos = np.asarray(store.pos_boxes)
        n_images = pos.shape[0]
        table = np.full((n_images, max_boxes), sentinel, np.int32)
        for i, (lo, hi) in enumerate(pos):
            c = min(int(hi) - int(lo), max_boxes)
            table[i, :c] = np.arange(int(lo), int(lo) + c)
    else:
        n_images, k = np.asarray(store.features).shape[:2]
        c = min(k, max_boxes)
        table = np.full((n_images, max_boxes), sentinel, np.int32)
        table[:, :c] = (np.arange(n_images)[:, None] * k
                        + np.arange(c)[None, :])
    return table
