"""The CTI attention and pooling kernels, their plain PyTorch versions and
their wrappers (``vqatpu/kernels/trilinear.py``).

- :func:`fused_rank_softmax` replaces the Pallas kernel of the same name
  (``vqatpu/kernels/trilinear.py:303-327``): the last rank-contraction GEMM
  fused with the masked softmax over (V, Q, A) for each glimpse.  CUDA
  source ``csrc/rank_softmax.cu``.
- :func:`trilinear_pool` replaces ``trilinear_pool_pallas``
  (``vqatpu/kernels/trilinear.py:369-429``): the weighted trilinear pool.
  CUDA source ``csrc/tri_pool.cu``.

A wrapper runs the plain version for CPU tensors, launches its kernel for
CUDA tensors, and raises for anything else.  Neither kernel has a backward
yet, so a wrapper raises when an input requires grad under grad mode.
``launches`` counts the kernel launches of each wrapper.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from vqatpu_torch.kernels import build

NEG_BIG = -1e30

# limits of the CUDA kernels; the wrappers raise beyond them
RANK_SOFTMAX_MAX_QA = 256
TRI_POOL_MAX_Q = 32
TRI_POOL_MAX_A = 8

launches = {"fused_rank_softmax": 0, "trilinear_pool": 0}
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        for name in launches:
            launches[name] = 0


def _count(name: str) -> None:
    with _launch_lock:
        launches[name] += 1


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def precontract_qa(q_r: torch.Tensor, a_r: torch.Tensor,
                   T: torch.Tensor) -> torch.Tensor:
    """V-independent part of the PARALIND contraction
    (``vqatpu/kernels/blockwise.py:61-66``): tqa [B, Q, A, R, X, G],
    contiguous, as :func:`fused_rank_softmax` takes it."""
    ta = torch.einsum("blrz,rxyzg->blrxyg", a_r, T)
    return torch.einsum("bjry,blrxyg->bjlrxg", q_r, ta).contiguous()


def masked_softmax_vqa_ref(logits: torch.Tensor,
                           v_mask: torch.Tensor) -> torch.Tensor:
    """Softmax over (V, Q, A) for each glimpse with masked boxes zeroed
    (``vqatpu/kernels/trilinear.py:163-170``): masked logits become -1e30
    and their exponentials are multiplied by the mask, so a fully masked
    sample gives zeros."""
    mask5 = v_mask[:, :, None, None, None]
    neg = torch.where(mask5, logits, torch.full_like(logits, NEG_BIG))
    m = neg.amax(dim=(1, 2, 3), keepdim=True)
    e = torch.exp(neg - m) * mask5
    return e / e.sum(dim=(1, 2, 3), keepdim=True).clamp_min(1e-30)


def fused_rank_softmax_ref(v_r: torch.Tensor, tqa: torch.Tensor,
                           v_mask: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`fused_rank_softmax`."""
    return masked_softmax_vqa_ref(
        torch.einsum("birx,bjlrxg->bijlg", v_r, tqa), v_mask)


def trilinear_pool_ref(vt: torch.Tensor, qt: torch.Tensor, at: torch.Tensor,
                       w: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`trilinear_pool`
    (``vqatpu/kernels/trilinear.py:177-185``)."""
    wv = torch.einsum("bvqa,bvd->bqad", w, vt)
    m = torch.einsum("bqad,bqd->bad", wv, qt)
    return torch.einsum("bad,bad->bd", m, at)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def _check_no_grad(*ts: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise RuntimeError("the CTI kernels have no backward yet; call them "
                           "under torch.no_grad() or torch.inference_mode()")


def _check_cuda(device: torch.device, **contiguous: torch.Tensor) -> None:
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    for name, t in contiguous.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(err: int, fn: str) -> None:
    if err != 0:
        raise RuntimeError(f"{fn} failed with CUDA error {err}")


def fused_rank_softmax(v_r: torch.Tensor, tqa: torch.Tensor,
                       v_mask: torch.Tensor) -> torch.Tensor:
    """att [B,V,Q,A,G] = masked softmax over (V,Q,A) of
    ``einsum('birx,bjlrxg->bijlg', v_r, tqa)``.

    ``v_r`` [B,V,R,X] and ``tqa`` [B,Q,A,R,X,G] float32, ``v_mask`` [B,V]
    bool; on CUDA all three contiguous and Q*A <= 256."""
    B, V, R, X = v_r.shape
    Q, A, G = tqa.shape[1], tqa.shape[2], tqa.shape[-1]
    dev = v_r.device
    _check(tqa, "tqa", (B, Q, A, R, X, G), torch.float32, dev)
    _check(v_r, "v_r", (B, V, R, X), torch.float32, dev)
    _check(v_mask, "v_mask", (B, V), torch.bool, dev)
    _check_no_grad(v_r, tqa)
    if dev.type == "cpu":
        return fused_rank_softmax_ref(v_r, tqa, v_mask)
    _check_cuda(dev, v_r=v_r, tqa=tqa, v_mask=v_mask)
    if Q * A > RANK_SOFTMAX_MAX_QA:
        raise ValueError(f"Q*A = {Q * A} exceeds the kernel's "
                         f"{RANK_SOFTMAX_MAX_QA}")
    out = torch.empty((B, V, Q, A, G), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = build.load("rank_softmax")
    fn = lib.rank_softmax_forward
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    _raise_on(fn(v_r.data_ptr(), tqa.data_ptr(), v_mask.data_ptr(),
                 out.data_ptr(), B, V, R * X, Q * A, G, dev.index or 0,
                 _stream(dev)), "rank_softmax_forward")
    _count("fused_rank_softmax")
    return out


def trilinear_pool(vt: torch.Tensor, qt: torch.Tensor, at: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """out [B,D] = sum_{i,j,l} vt[b,i,d] w[b,i,j,l] qt[b,j,d] at[b,l,d].

    ``vt`` [B,V,D], ``qt`` [B,Q,D], ``at`` [B,A,D], ``w`` [B,V,Q,A], all
    float32; on CUDA ``vt``/``qt``/``at`` contiguous, Q <= 32 and A <= 8.
    ``w`` may have any strides: the kernel reads one glimpse of the
    [B,V,Q,A,G] attention (``att[..., g]``, stride G) in place."""
    B, V, D = vt.shape
    Q, A = qt.shape[1], at.shape[1]
    dev = vt.device
    _check(qt, "qt", (B, Q, D), torch.float32, dev)
    _check(at, "at", (B, A, D), torch.float32, dev)
    _check(w, "w", (B, V, Q, A), torch.float32, dev)
    _check(vt, "vt", (B, V, D), torch.float32, dev)
    _check_no_grad(vt, qt, at, w)
    if dev.type == "cpu":
        return trilinear_pool_ref(vt, qt, at, w)
    _check_cuda(dev, vt=vt, qt=qt, at=at)
    if Q > TRI_POOL_MAX_Q or A > TRI_POOL_MAX_A:
        raise ValueError(f"Q={Q}, A={A} exceed the kernel's "
                         f"{TRI_POOL_MAX_Q}, {TRI_POOL_MAX_A}")
    out = torch.empty((B, D), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = build.load("tri_pool")
    fn = lib.tri_pool_forward
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4
                   + [ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    _raise_on(fn(vt.data_ptr(), qt.data_ptr(), at.data_ptr(), w.data_ptr(),
                 *w.stride(), out.data_ptr(), B, V, Q, A, D, dev.index or 0,
                 _stream(dev)), "tri_pool_forward")
    _count("trilinear_pool")
    return out
