"""The card-resident feature table, made on the device from the seed in
the layout of the program's ``DeviceFeatureStore``: flat box rows (float32,
or int8 with a float32 scale a row), one all-zero sentinel row after them,
spatials, the per-image ``[images, max_boxes]`` table of row indices (the
padded slots at the sentinel) and each question's image.

A workload file's keys read here: ``images``; ``boxes`` ``[lo, hi]``
(bottom-up features: each image has a number of boxes drawn uniformly
from lo to hi, of which at most ``max_boxes`` are used) or ``grid`` (that
many cells an image, all real, spatials zero); ``max_boxes``; ``store``
(``float32`` or ``int8``); ``questions`` (spread evenly over the
images)."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.gen import STORE, derive

S_DIM = 6  # x1, y1, x2, y2, w, h


def make(wl: dict, v_dim: int, seed: int, device) -> dict:
    rng = np.random.default_rng(derive(seed, STORE))
    gen = torch.Generator(device=device).manual_seed(derive(seed, STORE, 1))
    n_img, max_boxes = wl["images"], wl["max_boxes"]
    if "grid" in wl:
        n_boxes = np.full(n_img, wl["grid"], np.int64)
    else:
        n_boxes = rng.integers(wl["boxes"][0], wl["boxes"][1] + 1, n_img)
    starts = np.cumsum(n_boxes) - n_boxes
    total = int(n_boxes.sum())
    if wl["store"] == "int8":
        feats = torch.randint(0, 128, (total + 1, v_dim), generator=gen,
                              device=device, dtype=torch.int8)
        scales = (torch.rand(total + 1, generator=gen, device=device)
                  + 0.5) / 127.0
    else:
        feats = torch.rand((total + 1, v_dim), generator=gen, device=device)
        scales = None
    feats[total] = 0
    spats = torch.zeros((total + 1, S_DIM), device=device)
    if "grid" not in wl:
        xy = torch.rand((total, 2), generator=gen, device=device) * 0.8
        wh = torch.rand((total, 2), generator=gen, device=device) * 0.15 + 0.05
        spats[:total] = torch.cat([xy, xy + wh, wh], 1)
    slot = np.arange(max_boxes)[None, :]
    rows_table = np.where(slot < np.minimum(n_boxes, max_boxes)[:, None],
                          starts[:, None] + slot, total).astype(np.int32)
    n_q = wl["questions"]
    sample_img = (np.arange(n_q, dtype=np.int64) * n_img) // n_q
    return {"feats": feats, "scales": scales, "spats": spats,
            "rows_table": rows_table, "sample_img": sample_img,
            "sentinel": total}
