"""The port's C++ host runtime (``vqatpu_torch/native/vqadata.cc``) and its
ctypes binding, the counterpart of ``vqatpu/data/native.py:29-444``.

- :func:`quantize_rows`: the per-row int8 quantizer of the main path (the
  int8 wire's ``wire_cast``, int8 serving, ``FeatureStore.quantize``), one
  pass per row; bit for bit the numpy plain version
  :func:`vqatpu_torch.data.quantize.quantize_rows`.
- :class:`NativeFeatureStore`: a float32 or int8-resident
  :class:`~vqatpu_torch.data.features.FeatureStore` registered for gather
  and pad in C++.
- :class:`NativeBatchLoader`: the training and eval loader whose batch
  assembly and prefetch run on C++ threads; the same batches as the Python
  ``BatchLoader``, bit for bit and in the same shuffled order.

The source is compiled at first use with the host's C++ compiler (``$CXX``,
else ``g++``) into ``vqatpu_torch/_build/libvqadata-<hash>.so``; the hash
covers the source, the compiler, the flags and the CPU that
``-march=native`` targets.  The build writes a temporary file and renames
it, so processes that build at once never load a partial library.  The
flags always hold ``-ffp-contract=off``: a fused multiply-add in the
quantizer's rounding would leave ``np.rint`` on ties.  A failed build
raises with the compiler's output; nothing falls back to numpy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

SOURCE = Path(__file__).resolve().parents[1] / "native" / "vqadata.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
             "-Wextra", "-pthread", "-shared", "-ffp-contract=off")
# quantize_rows' threads: at most QUANTIZE_THREADS, one for each
# ROWS_PER_THREAD rows (a thread's start costs about what it saves on fewer)
QUANTIZE_THREADS = min(8, os.cpu_count() or 1)
ROWS_PER_THREAD = 400

_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# every entry point and its argument types (restype None unless listed)
ENTRY_POINTS = {
    "vqadata_store_create": ([_P, _P, _P, _I64, _I64, _I64, _I64], _P),
    "vqadata_store_create_q8": ([_P, _P, _P, _P, _I64, _I64, _I64, _I64], _P),
    "vqadata_store_destroy": ([_P], None),
    "vqadata_assemble": ([_P, _P, _I64, _I64, _P, _P, _P, _I64], None),
    "vqadata_assemble_q8": ([_P, _P, _I64, _I64, _P, _P, _P, _P, _I64], None),
    "vqadata_loader_create": ([_P, _P, _I64, _I64, _I64, _INT, _I64], _P),
    "vqadata_loader_create_multi": (
        [ctypes.POINTER(_P), _I64, _P, _P, _I64, _I64, _I64, _INT, _I64], _P),
    "vqadata_loader_set_quantize": ([_P, _INT], None),
    "vqadata_loader_register_slot": ([_P, _P, _P, _P, _P], None),
    "vqadata_loader_register_slot_q8": ([_P, _P, _P, _P, _P, _P], None),
    "vqadata_loader_swap_vb": ([_P, _I64, _P, _P], None),
    "vqadata_loader_swap_vq8": ([_P, _I64, _P, _P, _P], None),
    "vqadata_loader_push_order": ([_P, _P, _I64], None),
    "vqadata_loader_next": ([_P, _I64, _P], _I64),
    "vqadata_loader_destroy": ([_P], None),
    "vqadata_quantize_rows": ([_P, _I64, _I64, _P, _P, _I64], None),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def compiler() -> str:
    """The host C++ compiler: ``$CXX``, else ``g++`` on the PATH."""
    name = os.environ.get("CXX", "g++")
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f"the C++ compiler {name!r} is not on the PATH; "
                           "the host runtime (vqatpu_torch/native/vqadata.cc) "
                           "cannot be built")
    return found


def build_command(output: str) -> list:
    return [compiler(), *CXX_FLAGS, "-o", output, str(SOURCE)]


def library_path() -> Path:
    """``_build/libvqadata-<hash>.so``: the hash covers the source, the
    compiler's version, the flags and what ``-march=native`` means on this
    CPU, so a copy of the build directory on another machine builds anew."""
    cxx = compiler()
    ident = subprocess.run([cxx, "--version"], capture_output=True,
                           text=True).stdout
    target = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True).stdout
    key = hashlib.sha256(b"\0".join(
        [SOURCE.read_bytes(), cxx.encode(), ident.encode(), target.encode(),
         " ".join(CXX_FLAGS).encode()])).hexdigest()[:16]
    return BUILD_DIR / f"libvqadata-{key}.so"


def build() -> Tuple[Path, str]:
    """Compile the runtime unless it is built; -> (library, compiler output,
    empty when it was built already).  Raises if the build fails."""
    path = library_path()
    if path.exists():
        return path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(
        f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(build_command(str(tmp)), capture_output=True,
                          text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE} failed ({proc.returncode}):\n"
                           f"{' '.join(build_command(str(tmp)))}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path, proc.stdout + proc.stderr


def load() -> ctypes.CDLL:
    """The loaded runtime, built first if needed, its entry points bound."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            for name, (argtypes, restype) in ENTRY_POINTS.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _lib = lib
        return _lib


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.c_void_p)


def quantize_threads(rows: int) -> int:
    return max(1, min(QUANTIZE_THREADS, rows // ROWS_PER_THREAD))


def quantize_rows(v, num_threads: Optional[int] = None
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """C++ per-row int8 quantization (``vqadata_quantize_rows``): ``scale =
    absmax(row) / 127`` float32 (1 for an all-zero row), ``q = rint(v /
    scale)`` int8, round half to even; -> (q of ``v``'s shape, scale of
    ``v.shape[:-1]``).  Bit for bit :func:`vqatpu_torch.data.quantize.
    quantize_rows`; each row is read once, on ``num_threads`` threads
    (:func:`quantize_threads` of the rows by default)."""
    lib = load()
    v = np.ascontiguousarray(v, np.float32)
    rows = int(np.prod(v.shape[:-1])) if v.ndim > 1 else 1
    q = np.empty(v.shape, np.int8)
    scale = np.empty(v.shape[:-1], np.float32)
    lib.vqadata_quantize_rows(_ptr(v), rows, v.shape[-1], _ptr(q),
                              _ptr(scale), num_threads or
                              quantize_threads(rows))
    return q, scale


def dataset_members(dataset) -> list:
    """The member datasets of a ``ConcatDataset``, or the dataset itself."""
    return list(getattr(dataset, "datasets", [])) or [dataset]


def _aligned_empty(shape, dtype, align: int = 64) -> np.ndarray:
    """An uninitialized array whose data pointer is ``align``-byte aligned
    (``vqatpu/data/native.py:153-166``)."""
    size = int(np.prod(shape)) * np.dtype(dtype).itemsize
    buf = np.empty(size + align, np.uint8)
    off = (-buf.ctypes.data) % align
    return buf[off:off + size].view(dtype).reshape(shape)


def _pinned_empty(shape, dtype) -> np.ndarray:
    """An uninitialized array in page-locked memory (``torch.empty(...,
    pin_memory=True)``, page-aligned), for copies to the card that do not
    wait for the host.  The array keeps its tensor alive."""
    size = int(np.prod(shape)) * np.dtype(dtype).itemsize
    buf = torch.empty(max(size, 1), dtype=torch.uint8, pin_memory=True)
    return buf.numpy()[:size].view(dtype).reshape(shape)


class NativeFeatureStore:
    """A :class:`~vqatpu_torch.data.features.FeatureStore`'s arrays
    registered with the runtime (``vqatpu/data/native.py:168-227``): float32
    or int8-resident (``feat_scales``), adaptive or fixed layout."""

    def __init__(self, store):
        lib = load()
        self._lib = lib
        self.quantized = store.quantized
        # the handle points into these arrays: they live as long as it does
        if self.quantized:
            self.features = np.ascontiguousarray(store.features, np.int8)
            self.feat_scales = np.ascontiguousarray(
                store.feat_scales, np.float32).reshape(-1)
        else:
            self.features = np.ascontiguousarray(store.features, np.float32)
        self.spatials = np.ascontiguousarray(store.spatials, np.float32)
        self.adaptive = store.adaptive
        if self.adaptive:
            self.pos_boxes = np.ascontiguousarray(store.pos_boxes, np.int64)
            pos_ptr, n_images, fixed = (_ptr(self.pos_boxes),
                                        self.pos_boxes.shape[0], 0)
        else:
            self.pos_boxes, pos_ptr = None, None
            n_images, fixed = self.features.shape[:2]
        self.v_dim = self.features.shape[-1]
        self.s_dim = self.spatials.shape[-1]
        if self.quantized:
            self._handle = lib.vqadata_store_create_q8(
                _ptr(self.features), _ptr(self.feat_scales),
                _ptr(self.spatials), pos_ptr, n_images, fixed, self.v_dim,
                self.s_dim)
        else:
            self._handle = lib.vqadata_store_create(
                _ptr(self.features), _ptr(self.spatials), pos_ptr,
                n_images, fixed, self.v_dim, self.s_dim)

    def assemble(self, image_idx, max_boxes: int, num_threads: int = 8):
        """Gather and pad images -> (v [n, max_boxes, v_dim] float32 (an
        int8-resident store dequantized), b, v_mask bool), as
        ``FeatureStore.get`` row by row."""
        idx = np.ascontiguousarray(image_idx, np.int64)
        n = len(idx)
        out_v = np.empty((n, max_boxes, self.v_dim), np.float32)
        out_b = np.empty((n, max_boxes, self.s_dim), np.float32)
        out_m = np.empty((n, max_boxes), np.uint8)
        self._lib.vqadata_assemble(self._handle, _ptr(idx), n, max_boxes,
                                   _ptr(out_v), _ptr(out_b), _ptr(out_m),
                                   num_threads)
        return out_v, out_b, out_m.astype(bool)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.vqadata_store_destroy(self._handle)
            self._handle = None


class NativeBatchLoader:
    """The loader with C++ batch assembly and prefetch
    (``vqatpu/data/native.py:229-444``), over a dataset of the ``sample``/
    ``sample_fields`` protocol or a ``ConcatDataset`` of them: ``v``/``b``/
    ``v_mask`` are assembled by a C++ worker into a ring of slots, the small
    per-row fields (``q``, ``a``, ``target``, ``qid``, ...) are stacked once
    and sliced per batch.  ``quantize=True`` assembles the int8 wire (``v``
    int8 with ``v_scale``) straight out of the store.

    The epoch's row order is drawn here, from the same seeded
    ``np.random.RandomState`` as ``BatchLoader``'s, so both loaders yield
    the same batches in the same order.

    A yielded batch keeps its big arrays (``v``, ``b``, ``v_scale``) for as
    long as anything refers to them: before a slot is recycled the consumer
    side swaps fresh buffers into it, and a retired set is reused only once
    nothing but the loader refers to it.  A ``torch.from_numpy`` tensor
    refers to its array, and so does whoever copies from it asynchronously
    until the copy is done (:class:`vqatpu_torch.data.upload.
    PinnedUploader`).  Where CUDA is available the buffers are page-locked,
    so that the card copies them without a staging copy on the host.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 seed: int = 1204, drop_last: bool = False,
                 assemble_threads: int = 0, quantize: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.quantize = quantize
        self._empty = (_pinned_empty if torch.cuda.is_available()
                       else _aligned_empty)
        if assemble_threads <= 0:
            # leave one core for the consumer
            assemble_threads = max(1, (os.cpu_count() or 1) - 1)
        self._rng = np.random.RandomState(seed)  # BatchLoader's draw
        lib = load()
        self._lib = lib
        # one NativeFeatureStore per distinct member store (VisualGenome
        # shares the VQA splits' stores) and a (store, image) per row
        members = dataset_members(dataset)
        self.stores = []
        member_store = []
        store_index: Dict[int, int] = {}
        for d in members:
            if id(d.store) not in store_index:
                store_index[id(d.store)] = len(self.stores)
                self.stores.append(NativeFeatureStore(d.store))
            member_store.append(store_index[id(d.store)])
        self.store = self.stores[0]
        if any((s.v_dim, s.s_dim) != (self.store.v_dim, self.store.s_dim)
               for s in self.stores):
            raise ValueError("concatenated stores must share v_dim and s_dim")
        self.max_boxes = dataset.max_boxes

        n = len(dataset)
        self._row_to_image = np.empty(n, np.int64)
        self._row_to_store = np.empty(n, np.int32)
        rows = []
        off = 0
        for mi, d in enumerate(members):
            m = len(d)
            self._row_to_image[off:off + m] = [
                d.entries[i]["image"] for i in range(m)]
            self._row_to_store[off:off + m] = member_store[mi]
            rows.extend(d.sample_fields(i) for i in range(m))
            off += m
        if any(set(r) != set(rows[0]) for r in rows):
            raise ValueError("concatenated datasets must give the same fields")
        self._fields: Dict[str, np.ndarray] = {
            key: np.stack([r[key] for r in rows], 0) for key in rows[0]}

        if len(self.stores) == 1:
            self._handle = lib.vqadata_loader_create(
                self.store._handle, _ptr(self._row_to_image), n, batch_size,
                self.max_boxes, int(drop_last), assemble_threads)
        else:
            handles = (ctypes.c_void_p * len(self.stores))(
                *[s._handle for s in self.stores])
            self._handle = lib.vqadata_loader_create_multi(
                handles, len(self.stores), _ptr(self._row_to_image),
                _ptr(self._row_to_store), n, batch_size, self.max_boxes,
                int(drop_last), assemble_threads)
        if quantize:
            lib.vqadata_loader_set_quantize(self._handle, 1)
        register = (lib.vqadata_loader_register_slot_q8 if quantize
                    else lib.vqadata_loader_register_slot)
        # the ring: rotating buffers (v, b; v_q, v_scale, b in int8 mode)
        # and the slot-resident mask and row indices, which next_batch
        # copies out
        self._slots = []
        for _ in range(3):
            rot = self._alloc_rot()
            mask = np.zeros((batch_size, self.max_boxes), np.uint8)
            idx = np.zeros((batch_size,), np.int64)
            register(self._handle, *(_ptr(a) for a in rot), _ptr(mask),
                     _ptr(idx))
            self._slots.append((rot, mask, idx))
        self._held_slot = -1
        self._retired: list = []  # rotating buffer sets handed out earlier

    def _alloc_rot(self):
        shape_v = (self.batch_size, self.max_boxes, self.store.v_dim)
        b = self._empty((self.batch_size, self.max_boxes, self.store.s_dim),
                        np.float32)
        if self.quantize:
            return (self._empty(shape_v, np.int8),
                    self._empty((self.batch_size, self.max_boxes),
                                np.float32), b)
        return (self._empty(shape_v, np.float32), b)

    def _fresh_rot(self):
        """A retired buffer set that nothing else refers to (a refcount of
        3: the list's entry, the loop variable and getrefcount's argument),
        else a new one."""
        for i, bufs in enumerate(self._retired):
            if all(sys.getrefcount(a) == 3 for a in bufs):
                self._retired.pop(i)
                return bufs
        if len(self._retired) > 8:  # its last holder frees it
            self._retired.pop(0)
        return self._alloc_rot()

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else \
            (n + self.batch_size - 1) // self.batch_size

    @property
    def num_samples(self) -> int:
        return len(self.dataset)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.dataset), dtype=np.int64)
        if self.shuffle:
            self._rng.shuffle(order)  # BatchLoader.__iter__'s draw
        order = np.ascontiguousarray(order)
        self._lib.vqadata_loader_push_order(self._handle, _ptr(order),
                                            len(order))
        for _ in range(len(self)):
            yield self.next_batch()

    def next_batch(self) -> Dict[str, np.ndarray]:
        bs = self.batch_size
        rows_out = np.zeros((1,), np.int64)
        prev = self._held_slot
        if prev >= 0:
            # the previous batch keeps its buffers; its slot gets fresh ones
            # before the worker may assemble into it again
            fresh = self._fresh_rot()
            swap = (self._lib.vqadata_loader_swap_vq8 if self.quantize
                    else self._lib.vqadata_loader_swap_vb)
            swap(self._handle, prev, *(_ptr(a) for a in fresh))
            old_rot, m, idx = self._slots[prev]
            self._slots[prev] = (fresh, m, idx)
            self._retired.append(old_rot)
        slot = self._lib.vqadata_loader_next(self._handle, prev,
                                             _ptr(rows_out))
        if slot < 0:
            raise RuntimeError("the native loader was stopped")
        self._held_slot = slot
        rows = int(rows_out[0])
        rot, out_m, out_idx = self._slots[slot]
        # a partial final batch arrives with zeroed tails, as
        # BatchLoader(pad_final=True) pads it
        if self.quantize:
            out_v, out_scale, out_b = rot
            batch = {"v": out_v, "v_scale": out_scale, "b": out_b,
                     "v_mask": out_m.astype(bool)}
        else:
            out_v, out_b = rot
            batch = {"v": out_v, "b": out_b, "v_mask": out_m.astype(bool)}
        valid = np.zeros((bs,), bool)
        valid[:rows] = True
        idx = out_idx[:rows]
        for key, table in self._fields.items():
            field = np.zeros((bs,) + table.shape[1:], table.dtype)
            field[:rows] = table[idx]
            batch[key] = field
        batch["valid"] = valid
        return batch

    def close(self):
        """Stop and join the C++ worker; the stores go after it."""
        if getattr(self, "_handle", None):
            self._lib.vqadata_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
