"""Float32 ``x @ wᵀ`` on the tensor cores at float32 accuracy: the
split-bf16 GEMM of ``csrc/linear_f32.cu``, its plain version and its route.

Each float32 operand is split in the kernel into three bf16 terms
(:func:`split_terms`); each stage of 32
along the reduction sums six bf16 products (hh, hm, mh, hl, lh, mm) in the
tensor cores, and FADD adds that to the float32 sum.
No TPU kernel is replaced: the JAX package leaves these products to XLA.
:func:`linear_f32` is a ``torch.autograd.Function``: its forward ``x @ wᵀ``,
its weight gradient ``dyᵀ @ x`` and, where ``x`` needs one, its input
gradient ``dy @ w`` are the kernel's three instances on the card, and
:func:`split_bf16x6_mm`, the same six products as float32 matmuls of
bf16-valued terms, on the CPU.  It saves ``x`` and ``w`` for the backward,
as ``F.linear`` does.  The weight gradient's split reduction is summed in a
fixed order: bitwise the same from run to run.

:func:`routed_linear` is the product of ``WNLinear`` and
``fused_tucker_projection``: the kernel where :func:`takes_kernel` says so,
else ``F.linear``.  The rule reads only what the input shows (no model
name): float32 operands on the card, ``x`` contiguous and 16-byte aligned,
an output of at least :data:`ROUTE_MIN_TILES` of the kernel's 128 x 128
tiles, and ``K`` and ``N`` multiples of 128.  bf16 compute and the CPU
never take it; TF32 stays off.  The kernels' one ``launches`` registry
(:mod:`vqatpu_torch.kernels.trilinear`) counts each instance's launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from vqatpu_torch.kernels import build
from vqatpu_torch.kernels.trilinear import _count, _raise_on, _stream

TILE = 128  # the kernel's output tiles are TILE x TILE
# Output tiles below which the kernel gains little on cuBLAS float32 or
# loses: the H100 sweep over the cells' float32 product shapes (PERF.md §6;
# chip_smoke.py phase 16).  With 16 or 32 tiles (256 rows -> 1024 or 2048,
# 1,024 rows -> 512) the kernel's forward and weight gradient took
# 0.95-1.45x cuBLAS's time, with its input gradient 0.93-1.64x; from 48
# (1,536 rows -> 512) 0.50-0.82x at every shape routed.
ROUTE_MIN_TILES = 48


def fits_kernel(rows: int, n: int, k: int) -> bool:
    """The route's shape rule for ``[rows, k] @ [n, k]ᵀ``."""
    return (k > 0 and n % TILE == 0 and k % TILE == 0
            and -(-rows // TILE) * (n // TILE) >= ROUTE_MIN_TILES)


def takes_kernel(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether :func:`routed_linear` runs ``x @ wᵀ`` through the kernel."""
    if not (x.is_cuda and x.dtype == torch.float32 and w.dtype == torch.float32
            and w.dim() == 2 and x.dim() >= 2 and x.shape[-1] == w.shape[1]):
        return False
    N, K = w.shape
    return (fits_kernel(x.numel() // max(K, 1), N, K)
            and x.is_contiguous() and x.data_ptr() % 16 == 0
            and w.is_contiguous() and w.data_ptr() % 16 == 0)


def routed_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ wᵀ``: :func:`linear_f32` where :func:`takes_kernel`, else
    ``F.linear``."""
    return linear_f32(x, w) if takes_kernel(x, w) else F.linear(x, w)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------

SIX_PRODUCTS = ((0, 0), (0, 1), (1, 0), (0, 2), (2, 0), (1, 1))


def split_terms(x: torch.Tensor):
    """``x`` (float32) as the kernel's three bfloat16 terms, ``x = h + m +
    l``: ``h`` rounded to nearest, ``m`` the upper half of the bits of ``x
    - h`` (truncated, so exactly a bfloat16), ``l`` the rest of it rounded
    to nearest; the differences are exact in float32."""
    x = x.float()
    h = x.to(torch.bfloat16)
    r = x - h.float()
    m = (r.view(torch.int32) & -65536).view(torch.float32)
    return h, m.to(torch.bfloat16), (r - m).to(torch.bfloat16)


def split_bf16x6_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ bᵀ`` (``a`` [M, R], ``b`` [N, R], float32) as the kernel forms
    it: each operand's three terms (:func:`split_terms`), as float32, and
    the six products of :data:`SIX_PRODUCTS` summed in float32."""
    at = [t.float() for t in split_terms(a)]
    bt = [t.float() for t in split_terms(b)]
    out = None
    for i, j in SIX_PRODUCTS:
        p = at[i] @ bt[j].T
        out = p if out is None else out + p
    return out


# ---------------------------------------------------------------------------
# launches
# ---------------------------------------------------------------------------

def _gemm(kind: str, a: torch.Tensor, b: torch.Tensor, M: int, N: int,
          K: int) -> torch.Tensor:
    """One launch: ``forward`` y [M, N] = a [M, K] bᵀ (b [N, K]);
    ``dgrad`` dx [M, K] = a [M, N] b (b [N, K]); ``wgrad`` dw [N, K] =
    aᵀ [N, M] b (a [M, N], b [M, K]).  Contiguous float32 operands."""
    dev = a.device
    shape = {"forward": (M, N), "dgrad": (M, K), "wgrad": (N, K)}[kind]
    if M == 0 or N == 0 or K == 0:
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    lib = build.load("linear_f32")
    index = dev.index or 0
    args = [a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K]
    if kind == "wgrad":
        # the partial sums of a reduction split across blocks
        floats = ctypes.c_longlong()
        _raise_on(lib.linear_f32_wgrad_scratch(M, N, K, index,
                                               ctypes.addressof(floats)),
                  "linear_f32_wgrad_scratch")
        scratch = torch.empty(floats.value, dtype=torch.float32, device=dev)
        args += [scratch.data_ptr(), scratch.numel()]
    fn = "linear_f32_" + kind
    _raise_on(getattr(lib, fn)(*args, index, _stream(dev)), fn)
    _count("linear_f32" if kind == "forward" else fn)
    return out


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise TypeError(f"linear_f32 takes float32 operands, not {x.dtype} "
                        f"and {w.dtype}")
    if w.dim() != 2 or x.dim() < 1 or x.shape[-1] != w.shape[1]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)}: "
                         "expected [..., K] and [N, K]")
    if x.device != w.device:
        raise ValueError(f"x on {x.device}, w on {w.device}")
    if x.is_cuda:
        for name, t in (("x", x), ("w", w)):
            if not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"{name} must be contiguous and start on a "
                                 "16-byte boundary")
        if w.shape[1] % 4 or w.shape[0] % 4:
            raise ValueError(f"K = {w.shape[1]} and N = {w.shape[0]} must be "
                             "multiples of 4 (the kernel's tensor maps)")


class _LinearF32(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        N, K = w.shape
        x2 = x.reshape(-1, K)
        if x.is_cuda:
            y = _gemm("forward", x2, w, x2.shape[0], N, K)
        else:
            y = split_bf16x6_mm(x2, w)
        return y.reshape(*x.shape[:-1], N)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        N, K = w.shape
        x2 = x.reshape(-1, K)
        g2 = g.reshape(-1, N).contiguous()
        M = x2.shape[0]
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = (_gemm("dgrad", g2, w, M, N, K) if x.is_cuda
                  else split_bf16x6_mm(g2, w.T.contiguous()))
            dx = dx.reshape(x.shape)
        if ctx.needs_input_grad[1]:
            dw = (_gemm("wgrad", g2, x2, M, N, K) if x.is_cuda
                  else split_bf16x6_mm(g2.T.contiguous(), x2.T.contiguous()))
        return dx, dw


def linear_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ wᵀ`` for float32 ``x`` [..., K] and ``w`` [N, K], with its
    gradients: the kernel on the card (both contiguous, 16-byte aligned, K
    and N multiples of 4; any M, N, K otherwise, ragged tiles included),
    :func:`split_bf16x6_mm` on the CPU."""
    _check(x, w)
    return _LinearF32.apply(x, w)
