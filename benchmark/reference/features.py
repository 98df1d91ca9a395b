"""The plain gather of a batch's boxes from the feature table that the
benchmark made: sample -> image -> its rows of the table, the padded
slots pointing at the all-zero sentinel row."""

from __future__ import annotations

import numpy as np
import torch


def gather(table: dict, ds_idx: np.ndarray):
    """-> (``v`` [rows, max_boxes, v_dim] float32, ``v_mask`` [rows,
    max_boxes] bool) of the samples ``ds_idx``; int8 rows are multiplied
    by their float32 scale."""
    rows = table["rows_table"][table["sample_img"][np.asarray(ds_idx)]]
    idx = torch.as_tensor(rows.astype(np.int64), device=table["feats"].device)
    v = table["feats"][idx].to(torch.float32)
    if table["scales"] is not None:
        v = v * table["scales"][idx][..., None]
    return v, idx != table["sentinel"]
