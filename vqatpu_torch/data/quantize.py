"""The host's per-row int8 quantizer, a copy of the numpy branch of JAX's
``quantize_rows_any`` (``vqatpu/data/native.py:129-146``).

``scale = absmax(row) / 127`` (float32, one per minor row), ``q =
rint(v / scale)`` int8 with round-half-even, and an all-zero row (box
padding) takes scale 1 and stays exactly zero.  The largest error an
element takes is ``absmax / 254``.  Quantization is idempotent:
re-quantizing ``q * scale`` gives ``(q, scale)`` back bit for bit.

This is the plain version, which the tests hold the main path's quantizer
to: :func:`vqatpu_torch.data.native.quantize_rows`, the port's C++ copy of
the JAX package's, which reads each row once and gives the same bytes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def quantize_rows(v: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """-> (q int8 of ``v``'s shape, scale float32 of ``v.shape[:-1]``)."""
    v = np.asarray(v, np.float32)
    amax = np.maximum(v.max(axis=-1), -v.min(axis=-1))
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.rint(v * (1.0 / scale)[..., None]).astype(np.int8)
    return q, scale
