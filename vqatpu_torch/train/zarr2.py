"""zarr v2 arrays over a key-value store, the array format of JAX's
``.orbax`` checkpoints (``"use_zarr3": false``).

An array ``name`` is the key ``{name}/.zarray`` (JSON: ``shape``,
``chunks``, ``dtype``, ``compressor``, ``fill_value``, ``order``,
``dimension_separator``) and one key a chunk of the grid, ``{name}/i.j``
(``i/j`` with separator ``/``; ``0`` for a zero-dimension array), each chunk
the C-order bytes of a whole chunk, zstd-compressed or raw.  A chunk that
is missing reads as the fill value (zero for ``null``).

Stores have ``get(key) -> bytes or None``: :class:`DirStore`, a directory
(orbax's plain layout, ``"use_ocdbt": false``, which also has ``put``) and
:class:`~vqatpu_torch.train.ocdbt.OcdbtStore`.  ``bfloat16`` arrays read
as float32 (exact; numpy has no bfloat16) and are written from their
uint16 bit patterns.
"""

from __future__ import annotations

import json
import math
import os
from typing import Optional

import numpy as np

from vqatpu_torch.train import zstd

BF16 = "bfloat16"
ZSTD_LEVEL = 1  # orbax's


class DirStore:
    """Keys are paths relative to the directory ``root``."""

    def __init__(self, root: str):
        self.root = root

    def get(self, key: str) -> Optional[bytes]:
        try:
            with open(os.path.join(self.root, key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def put(self, key: str, data: bytes) -> None:
        path = os.path.join(self.root, key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            f.write(data)


def _dtype(text: str, name: str) -> np.dtype:
    """The numpy dtype a chunk's bytes are read as."""
    if text == BF16:
        return np.dtype("<u2")
    try:
        dtype = np.dtype(text)
    except TypeError:
        dtype = None
    if (dtype is None or dtype.kind not in "biuf"
            or dtype.byteorder not in "<|="):
        raise ValueError(f"zarr array {name}: dtype {text!r} is not read")
    return dtype


def _fill(value, dtype: np.dtype, name: str):
    if value is None:
        return 0
    if isinstance(value, str):  # zarr's spelling of non-finite floats
        spelled = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}
        if value not in spelled or dtype.kind != "f":
            raise ValueError(f"zarr array {name}: fill_value {value!r}")
        return spelled[value]
    return value


def read_array(store, name: str) -> np.ndarray:
    """The array ``name`` of ``store``."""
    raw = store.get(f"{name}/.zarray")
    if raw is None:
        raise KeyError(f"zarr array {name}: no .zarray")
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise ValueError(f"zarr array {name}: zarr_format "
                         f"{meta.get('zarr_format')!r}, 2 expected")
    if meta.get("order", "C") != "C" or meta.get("filters"):
        raise ValueError(f"zarr array {name}: order {meta.get('order')!r}, "
                         f"filters {meta.get('filters')!r}; only C order "
                         "without filters is read")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"zarr array {name}: compressor "
                         f"{compressor.get('id')!r}; only zstd or none is "
                         "read")
    sep = meta.get("dimension_separator", ".")
    if sep not in "./" or len(sep) != 1:
        raise ValueError(f"zarr array {name}: dimension_separator {sep!r}")
    dtype = _dtype(meta["dtype"], name)
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(chunks) != len(shape) or any(c < 1 for c in chunks):
        raise ValueError(f"zarr array {name}: chunks {list(chunks)} for "
                         f"shape {list(shape)}")
    nbytes = math.prod(chunks) * dtype.itemsize
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    out = None
    for index in np.ndindex(*grid):
        data = store.get(f"{name}/" + (sep.join(map(str, index)) or "0"))
        if data is None:
            continue
        if compressor is not None:
            data = zstd.decompress(data, nbytes)
        elif len(data) != nbytes:
            raise ValueError(f"zarr array {name}: chunk {index} of "
                             f"{len(data)} bytes, {nbytes} expected")
        chunk = np.frombuffer(data, dtype).reshape(chunks)
        if chunks == shape:  # one whole chunk: no copy of a decompressed one
            out = chunk if chunk.flags.writeable else chunk.copy()
            break
        if out is None:
            out = np.full(shape, _fill(meta.get("fill_value"), dtype, name),
                          dtype)
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(index, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start)
                                  for r in region)]
    if out is None:
        out = np.full(shape, _fill(meta.get("fill_value"), dtype, name),
                      dtype)
    if meta["dtype"] == BF16:
        return (out.astype(np.uint32) << 16).view(np.float32)
    return out


def write_array(store, name: str, array: np.ndarray,
                dtype: Optional[str] = None) -> None:
    """``array`` as the array ``name`` of ``store``, one chunk, zstd at
    orbax's level; ``dtype`` names the zarr dtype where it is not the
    array's own (``"bfloat16"`` for uint16 bit patterns)."""
    array = np.asarray(array, order="C")
    meta = {"chunks": [max(1, s) for s in array.shape],
            "compressor": {"id": "zstd", "level": ZSTD_LEVEL},
            "dimension_separator": ".",
            "dtype": dtype or array.dtype.str, "fill_value": None,
            "filters": None, "order": "C", "shape": list(array.shape),
            "zarr_format": 2}
    _dtype(meta["dtype"], name)
    store.put(f"{name}/.zarray",
              json.dumps(meta, sort_keys=True, separators=(",", ":")).encode())
    if array.size:
        key = ".".join("0" for _ in array.shape) or "0"
        store.put(f"{name}/{key}", zstd.compress(array, ZSTD_LEVEL))
