"""zstd frames through ``ctypes`` on the system's ``libzstd.so.1``, the codec
of JAX's ``.orbax`` checkpoints (their OCDBT nodes and zarr chunks).

The library ships with every Debian or Ubuntu image (dpkg and apt depend on
it); it is loaded at the first call.  A missing library raises an
``OSError`` that names it: there is no pure-Python stand-in.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

LIBRARY = "libzstd.so.1"
# ZSTD_getFrameContentSize's two sentinels
_UNKNOWN = 2**64 - 1
_ERROR = 2**64 - 2


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    try:
        lib = ctypes.CDLL(LIBRARY)
    except OSError as e:
        raise OSError(f"{LIBRARY} not found: the port reads and writes .orbax "
                      f"checkpoints through the system's zstd ({e})") from e
    size_t, buf = ctypes.c_size_t, ctypes.c_void_p
    for name, res, args in (
            ("ZSTD_getFrameContentSize", ctypes.c_ulonglong, [buf, size_t]),
            ("ZSTD_decompress", size_t, [buf, size_t, buf, size_t]),
            ("ZSTD_compress", size_t, [buf, size_t, buf, size_t,
                                       ctypes.c_int]),
            ("ZSTD_compressBound", size_t, [size_t]),
            ("ZSTD_createDStream", buf, []),
            ("ZSTD_freeDStream", size_t, [buf]),
            ("ZSTD_decompressStream", size_t, [buf, buf, buf]),
            ("ZSTD_DStreamOutSize", size_t, []),
            ("ZSTD_isError", ctypes.c_uint, [size_t]),
            ("ZSTD_getErrorName", ctypes.c_char_p, [size_t])):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


class _Buffer(ctypes.Structure):
    """``ZSTD_inBuffer`` and ``ZSTD_outBuffer``: pointer, size, position."""
    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


def _check(lib, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"zstd {what}: "
                         f"{lib.ZSTD_getErrorName(code).decode()}")
    return code


def decompress(data, size: int = None) -> np.ndarray:
    """The content of the zstd frame ``data`` (a bytes-like object), as
    uint8.  Its size comes from the frame header where the frame records
    it, else from ``size`` (orbax's zarr chunks record none: the caller
    knows it from the chunk's shape and dtype), else the frame is
    decompressed by streaming.  A frame whose content is not ``size`` bytes
    raises."""
    lib = _lib()
    src = np.frombuffer(data, np.uint8)
    known = lib.ZSTD_getFrameContentSize(src.ctypes.data, src.size)
    if known == _ERROR:
        raise ValueError("zstd: not a zstd frame")
    if known != _UNKNOWN:
        if size is not None and size != known:
            raise ValueError(f"zstd: the frame holds {known} bytes, "
                             f"{size} expected")
        size = known
    elif size is None:
        return _stream(lib, src)
    out = np.empty(size, np.uint8)
    got = _check(lib, lib.ZSTD_decompress(out.ctypes.data, size,
                                          src.ctypes.data, src.size),
                 "decompress")
    if got != size:
        raise ValueError(f"zstd: the frame holds {got} bytes, {size} "
                         "expected")
    return out


def _stream(lib, src: np.ndarray) -> np.ndarray:
    """One frame of unrecorded size, decompressed by streaming."""
    stream = lib.ZSTD_createDStream()
    if not stream:
        raise MemoryError("zstd: ZSTD_createDStream failed")
    try:
        step = lib.ZSTD_DStreamOutSize()
        inb = _Buffer(src.ctypes.data, src.size, 0)
        parts = []
        while True:
            chunk = np.empty(step, np.uint8)
            outb = _Buffer(chunk.ctypes.data, step, 0)
            left = _check(lib, lib.ZSTD_decompressStream(
                stream, ctypes.byref(outb), ctypes.byref(inb)), "decompress")
            parts.append(chunk[:outb.pos])
            if left == 0:
                break
            if inb.pos == inb.size and outb.pos < step:
                raise ValueError("zstd decompress: truncated frame")
    finally:
        lib.ZSTD_freeDStream(stream)
    if inb.pos != inb.size:
        raise ValueError("zstd decompress: bytes after the frame")
    return np.concatenate(parts)


def compress(data, level: int = 1) -> bytes:
    """One zstd frame of ``data`` (a contiguous bytes-like object) at
    ``level``; the frame records its content size."""
    lib = _lib()
    src = np.frombuffer(data, np.uint8)
    bound = lib.ZSTD_compressBound(src.size)
    out = np.empty(bound, np.uint8)
    got = _check(lib, lib.ZSTD_compress(out.ctypes.data, bound,
                                        src.ctypes.data, src.size, level),
                 "compress")
    return out[:got].tobytes()
