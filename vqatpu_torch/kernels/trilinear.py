"""The CTI attention and pooling kernels, their plain PyTorch versions and
their wrappers (``vqatpu/kernels/trilinear.py``).

- :func:`fused_rank_softmax` (K1) replaces the Pallas kernel of the same
  name (``vqatpu/kernels/trilinear.py:303-327``): the last rank-contraction
  GEMM fused with the masked softmax over (V, Q, A) for each glimpse.  CUDA
  source ``csrc/rank_softmax.cu``.
- :func:`trilinear_pool` (K2) replaces ``trilinear_pool_pallas``
  (``vqatpu/kernels/trilinear.py:369-429``): the weighted trilinear pool.
  CUDA source ``csrc/tri_pool.cu``; its backward, the four cotangents of
  ``_tri_pool_bwd`` (``:415-426``, which JAX leaves to XLA), CUDA source
  ``csrc/tri_pool_backward.cu``.
- :func:`masked_softmax_vqa` (K3) replaces ``masked_softmax_vqa_pallas``
  (``vqatpu/kernels/trilinear.py:207-243``): the masked softmax of given
  logits, float32 or bf16, into float32.  CUDA source
  ``csrc/softmax_vqa.cu``, which also holds :func:`softmax_vqa_backward`,
  the softmax VJP that K1's and K3's backwards both begin with (float32:
  it reads ``att``).

Under ``compute_dtype="bfloat16"`` K1 takes bf16 ``v_r`` and ``tqa``, and
K2 bf16 ``vt`` with ``qt``/``at`` bf16 (glimpse 0) or float32 (glimpse 1),
as JAX's Pallas backend passes them, and K3 bf16 logits
(``TriAttention(return_logits=True)``); each has a bf16-operand instance
(its own launch counter, ``*_bf16``) with a float32 output.  K1's and K2's
run their products on the tensor cores (bf16 operands, float32
accumulators), as the Pallas kernels' ``preferred_element_type=float32``
dots do; K2 multiplies the float32 attention as three bf16 terms
(:func:`split_bf16x3`), so every product stays exact.  K3's widens the
logits to float32.  The plain versions upcast bf16 operands to float32
first (exact) and sum in float32.  Any other dtype combination raises.

A wrapper runs the plain version for CPU tensors, and autograd
differentiates it there.  For CUDA tensors it launches its kernel, or
raises: nothing falls back.  The CUDA path goes through a
``torch.autograd.Function`` whose backward follows the JAX ``custom_vjp``:
K1's runs the softmax backward kernel, then the two gradient products that
JAX leaves to XLA (:func:`rank_contraction_grads`) as ``torch.bmm``; K2's
runs its backward kernel alone (float32 and bf16 instances, each
cotangent in its primal's dtype), which the tests and ``chip_smoke.py``
hold to its plain version :func:`trilinear_pool_grads`.  Under
``no_grad`` or ``inference_mode`` it runs the same kernel and records no
graph.  ``launches`` counts the kernel launches of each wrapper.
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
SOFTMAX_VQA_MAX_G = 8           # glimpses (the configs use 1 and 2)
SOFTMAX_VQA_MAX_SLICE = 2**31 - 1  # elements of one sample, V*Q*A*G

launches = {"fused_rank_softmax": 0, "trilinear_pool": 0,
            "masked_softmax_vqa": 0, "softmax_vqa_backward": 0,
            "fused_rank_softmax_bf16": 0, "trilinear_pool_bf16": 0,
            "masked_softmax_vqa_bf16": 0, "trilinear_pool_backward": 0,
            "trilinear_pool_backward_bf16": 0,
            # the split-bf16 GEMM of kernels/linear.py
            "linear_f32": 0, "linear_f32_wgrad": 0, "linear_f32_dgrad": 0}
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


def attention_logits_ref(v_r: torch.Tensor, q_r: torch.Tensor,
                         a_r: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Attention logits [B,V,Q,A,G] (``vqatpu/kernels/trilinear.py:49-65``):
    A into T first, then Q, then the [V, R*X] x [R*X, Q*A*G] product;
    contiguous, as :func:`masked_softmax_vqa` takes it."""
    return torch.einsum("birx,bjlrxg->bijlg", v_r,
                        precontract_qa(q_r, a_r, T)).contiguous()


def masked_softmax_vqa_ref(logits: torch.Tensor,
                           v_mask: torch.Tensor) -> torch.Tensor:
    """Softmax over (V, Q, A) for each glimpse with masked boxes zeroed
    (``vqatpu/kernels/trilinear.py:163-170``): masked logits become -1e30
    and their exponentials are multiplied by the mask, so a fully masked
    sample gives zeros.  bf16 logits are upcast first (exact), as the
    kernel widens them; the result is float32."""
    logits = logits.float()
    mask5 = v_mask[:, :, None, None, None]
    neg = torch.where(mask5, logits, torch.full_like(logits, NEG_BIG))
    m = neg.amax(dim=(1, 2, 3), keepdim=True)
    e = torch.exp(neg - m) * mask5
    return e / e.sum(dim=(1, 2, 3), keepdim=True).clamp_min(1e-30)


def softmax_vqa_backward_ref(att: torch.Tensor,
                             g: torch.Tensor) -> torch.Tensor:
    """VJP of the masked softmax (``vqatpu/kernels/trilinear.py:237-240``):
    ``att * (g - sum over (V,Q,A) of g * att)``."""
    return att * (g - (g * att).sum(dim=(1, 2, 3), keepdim=True))


def fused_rank_softmax_ref(v_r: torch.Tensor, tqa: torch.Tensor,
                           v_mask: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`fused_rank_softmax`, in float32."""
    return masked_softmax_vqa_ref(
        torch.einsum("birx,bjlrxg->bijlg", v_r.float(), tqa.float()), v_mask)


def split_bf16x3(w: torch.Tensor):
    """``w`` (float32) as three bfloat16 terms, each rounded to nearest
    even from what the terms before it leave: ``w0 = bf16(w)``, ``w1 =
    bf16(w - w0)``, ``w2 = bf16(w - w0 - w1)``, the differences taken in
    float32 (where they are exact).  ``w0 + w1 + w2`` is ``w`` for the
    attention weights the model makes (not for values near the bottom of
    float32's range).  The bf16 K2 (``csrc/tri_pool.cu``) splits its
    attention so as it is loaded, and multiplies each term with bf16
    ``vt`` on the tensor cores: a bf16 x bf16 product is exact in float32."""
    w = w.float()
    w0 = w.to(torch.bfloat16)
    r = w - w0.float()
    w1 = r.to(torch.bfloat16)
    return w0, w1, (r - w1.float()).to(torch.bfloat16)


def trilinear_pool_ref(vt: torch.Tensor, qt: torch.Tensor, at: torch.Tensor,
                       w: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`trilinear_pool`
    (``vqatpu/kernels/trilinear.py:177-185``), in float32."""
    vt, qt, at, w = vt.float(), qt.float(), at.float(), w.float()
    wv = torch.einsum("bvqa,bvd->bqad", w, vt)
    m = torch.einsum("bqad,bqd->bad", wv, qt)
    return torch.einsum("bad,bad->bd", m, at)


# ---------------------------------------------------------------------------
# the gradient products JAX leaves to XLA, as torch.bmm
# ---------------------------------------------------------------------------

def rank_contraction_grads(dl: torch.Tensor, v_r: torch.Tensor,
                           tqa: torch.Tensor):
    """``dv = einsum('bijlg,bjlrxg->birx')`` and ``dtqa =
    einsum('bijlg,birx->bjlrxg')`` of ``dl`` [B,V,Q,A,G]
    (``vqatpu/kernels/trilinear.py:322-323``), each one ``torch.bmm``:
    ``dl`` as [B, V, QA*G] against ``tqa`` laid out [B, QA*G, RX].  bf16
    ``v_r``/``tqa`` are promoted against the float32 ``dl``, as jnp does;
    the products are float32."""
    v_r, tqa = v_r.float(), tqa.float()
    B, V, R, X = v_r.shape
    Q, A, G = tqa.shape[1], tqa.shape[2], tqa.shape[5]
    dl2 = dl.reshape(B, V, Q * A * G)
    t2 = tqa.permute(0, 1, 2, 5, 3, 4).reshape(B, Q * A * G, R * X)
    dv = torch.bmm(dl2, t2).reshape(B, V, R, X)
    dtqa = torch.bmm(dl2.transpose(1, 2), v_r.reshape(B, V, R * X))
    return dv, dtqa.reshape(B, Q, A, G, R, X).permute(0, 1, 2, 4, 5, 3)


def trilinear_pool_grads(g: torch.Tensor, vt: torch.Tensor, qt: torch.Tensor,
                         at: torch.Tensor, w: torch.Tensor,
                         dtype: torch.dtype = torch.float32):
    """Plain version of :func:`_tri_pool_backward_kernel`: the four
    cotangents of the pool (``vqatpu/kernels/trilinear.py:415-426``) for
    ``g`` [B, D].  With ``P[b,(j,l),d] = qt[b,j,d]·at[b,l,d]`` and ``wv =
    wᵀ vt`` [B, QA, D], each product is one ``torch.bmm``: no [B, V, Q, D]
    intermediate is formed.  bf16 operands are promoted against the float32
    ``g``, as jnp does; the products are in ``dtype`` (float32; float64 for
    ``chip_smoke.py``'s reference)."""
    g, vt, qt, at, w = (x.to(dtype) for x in (g, vt, qt, at, w))
    B, V, D = vt.shape
    Q, A = qt.shape[1], at.shape[1]
    w2 = w.reshape(B, V, Q * A)
    p = (qt[:, :, None, :] * at[:, None, :, :]).reshape(B, Q * A, D)
    gd = g[:, None, :]
    gvt = torch.bmm(w2, p) * gd
    gw = torch.bmm(vt, (p * gd).transpose(1, 2)).reshape(B, V, Q, A)
    wv = torch.bmm(w2.transpose(1, 2), vt).reshape(B, Q, A, D)
    gqt = (wv * at[:, None]).sum(2) * gd
    gat = (wv * qt[:, :, None]).sum(1) * gd
    return gvt, gqt, gat, gw


# ---------------------------------------------------------------------------
# launches
# ---------------------------------------------------------------------------

def _check(t: torch.Tensor, name: str, shape, dtype, device) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")


def _check_operand(t: torch.Tensor, name: str) -> None:
    """K1's and K2's operands have float32 and bfloat16 instances."""
    if t.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: dtype {t.dtype}, expected float32 or "
                        "bfloat16")


def _check5(t: torch.Tensor, name: str, dtypes=(torch.float32,)) -> None:
    if t.dim() != 5:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected [B,V,Q,A,G]")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, expected one of {dtypes}")


def _check_cuda(device: torch.device, **contiguous: torch.Tensor) -> None:
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    for name, t in contiguous.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_aligned(**tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(err: int, fn: str) -> None:
    if err != 0:
        raise RuntimeError(f"{fn} failed with CUDA error {err}")


def _unit(t: torch.Tensor) -> int:
    """Elements of ``t`` in one of the kernels' 16-byte copies."""
    return 16 // t.element_size()


def _bf16_suffix(t: torch.Tensor) -> str:
    return "_bf16" if t.dtype == torch.bfloat16 else ""


def _rank_softmax_kernel(v_r, tqa, v_mask) -> torch.Tensor:
    B, V, R, X = v_r.shape
    Q, A, G = tqa.shape[1], tqa.shape[2], tqa.shape[-1]
    dev = v_r.device
    if Q * A > RANK_SOFTMAX_MAX_QA:
        raise ValueError(f"Q*A = {Q * A} exceeds the kernel's "
                         f"{RANK_SOFTMAX_MAX_QA}")
    if (R * X) % _unit(v_r):
        raise ValueError(f"R*X = {R * X} must be a multiple of {_unit(v_r)} "
                         f"for {v_r.dtype} (the kernel's 16-byte copies)")
    _check_cuda(dev, v_r=v_r, tqa=tqa, v_mask=v_mask)
    _check_aligned(v_r=v_r, tqa=tqa)
    out = torch.empty((B, V, Q, A, G), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    sfx = _bf16_suffix(v_r)
    fn = getattr(build.load("rank_softmax"), "rank_softmax_forward" + sfx)
    _raise_on(fn(v_r.data_ptr(), tqa.data_ptr(), v_mask.data_ptr(),
                 out.data_ptr(), B, V, R * X, Q * A, G, dev.index or 0,
                 _stream(dev)), "rank_softmax_forward" + sfx)
    _count("fused_rank_softmax" + sfx)
    return out


def _tri_pool_kernel(vt, qt, at, w) -> torch.Tensor:
    B, V, D = vt.shape
    Q, A = qt.shape[1], at.shape[1]
    dev = vt.device
    if Q > TRI_POOL_MAX_Q or A > TRI_POOL_MAX_A:
        raise ValueError(f"Q={Q}, A={A} exceed the kernel's "
                         f"{TRI_POOL_MAX_Q}, {TRI_POOL_MAX_A}")
    if D % _unit(vt):
        raise ValueError(f"D = {D} must be a multiple of {_unit(vt)} for "
                         f"{vt.dtype} (the kernel's 16-byte copies)")
    _check_cuda(dev, vt=vt, qt=qt, at=at)
    _check_aligned(vt=vt, qt=qt, at=at)
    out = torch.empty((B, D), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = build.load("tri_pool")
    args = (vt.data_ptr(), qt.data_ptr(), at.data_ptr(), w.data_ptr(),
            *w.stride(), out.data_ptr(), B, V, Q, A, D)
    sfx = _bf16_suffix(vt)
    if sfx:
        args += (int(qt.dtype == torch.bfloat16),)
    _raise_on(getattr(lib, "tri_pool_forward" + sfx)(
        *args, dev.index or 0, _stream(dev)), "tri_pool_forward" + sfx)
    _count("trilinear_pool" + sfx)
    return out


def _tri_pool_backward_kernel(g, vt, qt, at, w):
    """(gvt, gqt, gat, gw), the cotangents of :func:`trilinear_pool` for
    ``g`` [B, D] float32 (contiguous, 16-byte aligned), each in its
    primal's dtype (``gw`` float32 [B,V,Q,A], contiguous): the backward of
    its ``autograd.Function``, on the card.  ``trilinear_pool_grads`` is
    its plain version."""
    _check_pool(vt, qt, at, w)
    B, V, D = vt.shape
    Q, A = qt.shape[1], at.shape[1]
    dev = vt.device
    if Q > TRI_POOL_MAX_Q or A > TRI_POOL_MAX_A:
        raise ValueError(f"Q={Q}, A={A} exceed the kernel's "
                         f"{TRI_POOL_MAX_Q}, {TRI_POOL_MAX_A}")
    if D % _unit(vt):
        raise ValueError(f"D = {D} must be a multiple of {_unit(vt)} for "
                         f"{vt.dtype} (the kernel's 16-byte copies)")
    _check(g, "g", (B, D), torch.float32, dev)
    _check_cuda(dev, g=g, vt=vt, qt=qt, at=at)
    _check_aligned(g=g, vt=vt, qt=qt, at=at)
    gvt, gqt, gat = (torch.empty_like(x) for x in (vt, qt, at))
    gw = torch.empty((B, V, Q, A), dtype=torch.float32, device=dev)
    if B == 0 or D == 0:
        return gvt, gqt, gat, gw.zero_()
    lib = build.load("tri_pool_backward")
    floats = ctypes.c_longlong()
    _raise_on(lib.tri_pool_backward_scratch(
        B, V, Q, A, D, int(vt.dtype == torch.bfloat16),
        ctypes.addressof(floats)), "tri_pool_backward_scratch")
    scratch = torch.empty(floats.value, dtype=torch.float32, device=dev)
    args = (g.data_ptr(), vt.data_ptr(), qt.data_ptr(), at.data_ptr(),
            w.data_ptr(), *w.stride(), gvt.data_ptr(), gqt.data_ptr(),
            gat.data_ptr(), gw.data_ptr(), scratch.data_ptr(), scratch.numel(),
            B, V, Q, A, D)
    sfx = _bf16_suffix(vt)
    if sfx:
        args += (int(qt.dtype == torch.bfloat16),)
    fn = "tri_pool_backward" + sfx
    _raise_on(getattr(lib, fn)(*args, dev.index or 0, _stream(dev)), fn)
    _count("trilinear_pool_backward" + sfx)
    return gvt, gqt, gat, gw


def _softmax_vqa_call(fn_name: str, counter: str, names, a: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """Launch one of ``csrc/softmax_vqa.cu``'s kernels: ``a`` [B,V,Q,A,G]
    (float32, or bf16 logits) and ``b`` (the mask [B,V] or the cotangent
    [B,V,Q,A,G]) in, one float32 [B,V,Q,A,G] out; ``names`` name ``a`` and
    ``b`` in errors."""
    B, V, Q, A, G = a.shape
    dev = a.device
    if G > SOFTMAX_VQA_MAX_G:
        raise ValueError(f"G = {G} exceeds the kernel's {SOFTMAX_VQA_MAX_G}")
    if V * Q * A * G > SOFTMAX_VQA_MAX_SLICE:
        raise ValueError(f"V*Q*A*G = {V * Q * A * G} exceeds the kernel's "
                         f"{SOFTMAX_VQA_MAX_SLICE} elements a sample")
    _check_cuda(dev, **dict(zip(names, (a, b))))
    out = torch.empty(a.shape, dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    fn = getattr(build.load("softmax_vqa"), fn_name)
    _raise_on(fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), B, V, Q * A, G,
                 dev.index or 0, _stream(dev)), fn_name)
    _count(counter)
    return out


def _masked_softmax_kernel(logits, v_mask) -> torch.Tensor:
    sfx = _bf16_suffix(logits)
    return _softmax_vqa_call("masked_softmax_vqa_forward" + sfx,
                             "masked_softmax_vqa" + sfx, ("logits", "v_mask"),
                             logits, v_mask)


def _softmax_backward_kernel(att, g) -> torch.Tensor:
    return _softmax_vqa_call("softmax_vqa_backward", "softmax_vqa_backward",
                             ("att", "g"), att, g)


# ---------------------------------------------------------------------------
# gradients on the card
# ---------------------------------------------------------------------------

class _FusedRankSoftmax(torch.autograd.Function):
    """K1 with the VJP of ``vqatpu/kernels/trilinear.py:311-324``."""

    @staticmethod
    def forward(ctx, v_r, tqa, v_mask):
        att = _rank_softmax_kernel(v_r, tqa, v_mask)
        ctx.save_for_backward(att, v_r, tqa)
        return att

    @staticmethod
    def backward(ctx, g):
        att, v_r, tqa = ctx.saved_tensors
        dl = _softmax_backward_kernel(att, g.contiguous())
        dv, dtqa = rank_contraction_grads(dl, v_r, tqa)
        return dv.to(v_r.dtype), dtqa.to(tqa.dtype), None


class _TrilinearPool(torch.autograd.Function):
    """K2 with the VJP of ``vqatpu/kernels/trilinear.py:411-426``."""

    @staticmethod
    def forward(ctx, vt, qt, at, w):
        ctx.save_for_backward(vt, qt, at, w)
        return _tri_pool_kernel(vt, qt, at, w)

    @staticmethod
    def backward(ctx, g):
        return _tri_pool_backward_kernel(g.contiguous(), *ctx.saved_tensors)


class _MaskedSoftmaxVQA(torch.autograd.Function):
    """K3 with the VJP of ``vqatpu/kernels/trilinear.py:227-243``.  The
    cotangent of bf16 logits comes back in bf16, the primal's dtype (JAX's
    ``_softmax_bwd`` returns float32: ROADMAP queue C's reference fault)."""

    @staticmethod
    def forward(ctx, logits, v_mask):
        att = _masked_softmax_kernel(logits, v_mask)
        ctx.save_for_backward(att)
        ctx.logits_dtype = logits.dtype
        return att

    @staticmethod
    def backward(ctx, g):
        (att,) = ctx.saved_tensors
        dl = _softmax_backward_kernel(att, g.contiguous())
        return dl.to(ctx.logits_dtype), None


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def fused_rank_softmax(v_r: torch.Tensor, tqa: torch.Tensor,
                       v_mask: torch.Tensor) -> torch.Tensor:
    """att [B,V,Q,A,G] = masked softmax over (V,Q,A) of
    ``einsum('birx,bjlrxg->bijlg', v_r, tqa)``.

    ``v_r`` [B,V,R,X] and ``tqa`` [B,Q,A,R,X,G], both float32 or both
    bfloat16, ``v_mask`` [B,V] bool; att is float32.  On CUDA all three
    contiguous, ``v_r`` and ``tqa`` 16-byte aligned, R*X a multiple of 4
    (float32) or 8 (bfloat16) and Q*A <= 256."""
    B, V, R, X = v_r.shape
    Q, A, G = tqa.shape[1], tqa.shape[2], tqa.shape[-1]
    dev = v_r.device
    _check_operand(v_r, "v_r")
    _check(tqa, "tqa", (B, Q, A, R, X, G), v_r.dtype, dev)
    _check(v_r, "v_r", (B, V, R, X), v_r.dtype, dev)
    _check(v_mask, "v_mask", (B, V), torch.bool, dev)
    if dev.type == "cpu":
        return fused_rank_softmax_ref(v_r, tqa, v_mask)
    return _FusedRankSoftmax.apply(v_r, tqa, v_mask)


def _check_pool(vt, qt, at, w) -> None:
    """The operands :func:`trilinear_pool` and its backward kernel take."""
    B, V, D = vt.shape
    Q, A = qt.shape[1], at.shape[1]
    dev = vt.device
    _check_operand(vt, "vt")
    _check_operand(qt, "qt")
    if vt.dtype == torch.float32 and qt.dtype != torch.float32:
        raise TypeError(f"qt: dtype {qt.dtype} with vt {vt.dtype}: no kernel "
                        "instance takes it")
    _check(qt, "qt", (B, Q, D), qt.dtype, dev)
    _check(at, "at", (B, A, D), qt.dtype, dev)
    _check(w, "w", (B, V, Q, A), torch.float32, dev)


def trilinear_pool(vt: torch.Tensor, qt: torch.Tensor, at: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """out [B,D] = sum_{i,j,l} vt[b,i,d] w[b,i,j,l] qt[b,j,d] at[b,l,d].

    ``vt`` [B,V,D], ``qt`` [B,Q,D], ``at`` [B,A,D], ``w`` [B,V,Q,A]; ``w``
    and the output float32, and (``vt``, ``qt`` and ``at``) float32, or
    ``vt`` bfloat16 with ``qt`` and ``at`` both bfloat16 or both float32.
    On CUDA ``vt``/``qt``/``at`` contiguous and 16-byte aligned, D a
    multiple of 4 (``vt`` float32) or 8 (bfloat16), Q <= 32 and A <= 8.
    ``w`` may have any strides: the kernel reads one glimpse of the
    [B,V,Q,A,G] attention (``att[..., g]``, stride G) in place, and the
    backward's ``gw`` flows back into the attention's gradient."""
    _check_pool(vt, qt, at, w)
    if vt.device.type == "cpu":
        return trilinear_pool_ref(vt, qt, at, w)
    return _TrilinearPool.apply(vt, qt, at, w)


def masked_softmax_vqa(logits: torch.Tensor,
                       v_mask: torch.Tensor) -> torch.Tensor:
    """att [B,V,Q,A,G] float32 = the softmax of ``logits`` over (V,Q,A) per
    glimpse, masked boxes zeroed (a fully masked sample gives zeros).

    ``logits`` [B,V,Q,A,G] float32 or bfloat16, ``v_mask`` [B,V] bool; on
    CUDA both contiguous and G <= 8 (any alignment).  The gradient of bf16
    logits is bf16."""
    _check5(logits, "logits", (torch.float32, torch.bfloat16))
    B, V = logits.shape[:2]
    dev = logits.device
    _check(v_mask, "v_mask", (B, V), torch.bool, dev)
    if dev.type == "cpu":
        return masked_softmax_vqa_ref(logits, v_mask)
    return _MaskedSoftmaxVQA.apply(logits, v_mask)


def softmax_vqa_backward(att: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dl = ``att * (g - sum over (V,Q,A) of g * att)`` per glimpse, the
    backward of :func:`masked_softmax_vqa` and the first step of K1's.
    ``att`` and ``g`` [B,V,Q,A,G] float32; on CUDA both contiguous and
    G <= 8 (any alignment)."""
    _check5(att, "att")
    _check(g, "g", att.shape, torch.float32, att.device)
    if att.device.type == "cpu":
        return softmax_vqa_backward_ref(att, g)
    return _softmax_backward_kernel(att, g)


def trilinear_attention(v_r: torch.Tensor, q_r: torch.Tensor,
                        a_r: torch.Tensor, T: torch.Tensor,
                        v_mask: torch.Tensor) -> torch.Tensor:
    """Logits, then K3 (``vqatpu/kernels/trilinear.py:246-251`` with
    ``backend="pallas"``)."""
    return masked_softmax_vqa(attention_logits_ref(v_r, q_r, a_r, T), v_mask)
