"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled with
``nvcc`` for ``sm_90a`` into ``vqatpu_torch/_build/lib<name>-<hash>.so`` at
first use (the hash covers the source, the shared ``csrc/*.cuh`` headers and
the flags, so an edited source builds anew) and loaded with ``ctypes``, its
entry points bound to their C signatures (:data:`ENTRY_POINTS`) once, as it
loads.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("rank_softmax", "tri_pool", "softmax_vqa", "tri_pool_backward",
           "linear_f32")
_PTR, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# each library's entry points and their argument types; all return a
# cudaError_t as an int
ENTRY_POINTS = {
    "rank_softmax": {
        # v_r, tqa, mask, att, B, V, RX, QA, G, device, stream; v_r and tqa
        # float32, or bfloat16 in the _bf16 entry point
        "rank_softmax_forward": [_PTR] * 4 + [_INT] * 6 + [_PTR],
        "rank_softmax_forward_bf16": [_PTR] * 4 + [_INT] * 6 + [_PTR],
    },
    "tri_pool": {
        # vt, qt, at, w, w's 4 strides, out, B, V, Q, A, D, device, stream;
        # the _bf16 entry point takes vt bfloat16 and, before the device,
        # a flag: qt and at bfloat16 (1) or float32 (0)
        "tri_pool_forward": [_PTR] * 4 + [_I64] * 4 + [_PTR] + [_INT] * 6 + [_PTR],
        "tri_pool_forward_bf16": [_PTR] * 4 + [_I64] * 4 + [_PTR] + [_INT] * 7 + [_PTR],
    },
    "tri_pool_backward": {
        # B, V, Q, A, D, vt bfloat16 (1) or float32 (0), out: the floats of
        # scratch the two entry points below need
        "tri_pool_backward_scratch": [_INT] * 6 + [_PTR],
        # g, vt, qt, at, w, w's 4 strides, gvt, gqt, gat, gw, scratch, the
        # scratch's floats, B, V, Q, A, D, device, stream; the _bf16 entry
        # point takes vt and gvt bfloat16 and, before the device, a flag:
        # qt, at, gqt and gat bfloat16 (1) or float32 (0)
        "tri_pool_backward": [_PTR] * 5 + [_I64] * 4 + [_PTR] * 5 + [_I64]
        + [_INT] * 6 + [_PTR],
        "tri_pool_backward_bf16": [_PTR] * 5 + [_I64] * 4 + [_PTR] * 5 + [_I64]
        + [_INT] * 7 + [_PTR],
    },
    "softmax_vqa": {
        # in, mask or cotangent, out, B, V, QA, G, device, stream; the
        # _bf16 entry point takes bfloat16 logits
        "masked_softmax_vqa_forward": [_PTR] * 3 + [_INT] * 5 + [_PTR],
        "masked_softmax_vqa_forward_bf16": [_PTR] * 3 + [_INT] * 5 + [_PTR],
        "softmax_vqa_backward": [_PTR] * 3 + [_INT] * 5 + [_PTR],
    },
    "linear_f32": {
        # the two operands, out, M, N, K, device, stream; the weight
        # gradient takes, before the device, its scratch and the scratch's
        # floats
        "linear_f32_forward": [_PTR] * 3 + [_INT] * 4 + [_PTR],
        "linear_f32_dgrad": [_PTR] * 3 + [_INT] * 4 + [_PTR],
        # M, N, K, device, out: the floats of scratch the weight gradient
        # needs
        "linear_f32_wgrad_scratch": [_INT] * 4 + [_PTR],
        "linear_f32_wgrad": [_PTR] * 3 + [_INT] * 3 + [_PTR, _I64, _INT,
                                                       _PTR],
    },
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; "
                           "the CUDA kernels cannot be built")
    return str(path)


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build(names: Iterable[str] = SOURCES,
          ptxas_info: bool = False) -> Dict[str, str]:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` per source, all started together.  Returns each new build's
    compiler output (with ``ptxas_info``, the registers, shared memory and
    spills of every kernel).  Raises if any build fails."""
    jobs = []
    for name in names:
        path = library_path(name)
        if path.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_info else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((name, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    outputs, errors = {}, []
    for name, path, tmp, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            continue
        os.replace(tmp, path)
        outputs[name] = out
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return outputs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed, with its entry
    points bound."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in ENTRY_POINTS[name].items():
                getattr(lib, fn).restype = ctypes.c_int
                getattr(lib, fn).argtypes = argtypes
            _loaded[name] = lib
        return lib
