"""vqatpu_torch kernels' plain versions and gradients against vqatpu's
Pallas kernels and their ``custom_vjp``s (interpret mode, as
tests/test_kernels.py runs them) and XLA math, the explicit backward
products against autograd, the wrappers' CPU behaviour, and the CUDA
kernels against their plain versions on the card (marked ``cuda``; skipped
without one)."""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from vqatpu.kernels.blockwise import precontract_qa as jax_precontract_qa
from vqatpu.kernels.trilinear import (_masked_softmax_pallas_vjp, _softmax_bwd,
                                      _tri_pool_bwd, attention_logits_xla,
                                      fused_rank_softmax as jax_rank_softmax,
                                      masked_softmax_vqa_pallas,
                                      masked_softmax_vqa_xla,
                                      trilinear_attention as jax_tri_attention,
                                      trilinear_pool_pallas, trilinear_pool_xla)
from vqatpu_torch.config import ModelConfig
from vqatpu_torch.kernels import build
from vqatpu_torch.kernels import trilinear as K
from vqatpu_torch.models import build_model
from vqatpu_torch.weights import numpy_batch, numpy_params, torch_state_from_jax

# tests/test_kernels.py fixture shapes
B, Q, A, R, X, G, D = 2, 12, 3, 4, 8, 2, 32


# Shapes at the edges of the CUDA kernels' tiles (chip_smoke.py phase 3
# checks the kernels there): K1's V tile is 56 rows at Q*A=36 and 2
# glimpses and 64 rows at 1 or 3 glimpses; K2 streams 4 box rows per ring
# stage and spans 256 d per block.
K1_EDGES = [pytest.param(57, 57, 1, 2, id="B1-57-57-G2"),
            pytest.param(65, 60, 2, 1, id="B2-65-60-G1"),
            pytest.param(65, 60, 2, 3, id="B2-65-60-G3")]
K2_EDGES = [pytest.param(65, 1, 96, id="B1-65-D96"),
            pytest.param(9, 2, 352, id="B2-9-D352")]
# csrc/softmax_vqa.cu takes one sample a block over all glimpses; it holds
# 8 floats of each input a thread in registers, with up to 1024 threads
# (960 at G=3), so 113 boxes of 12*3*2 floats are resident and 114 are
# not; 7*5*3 floats a sample are no whole number of 16-byte units.  Cases
# are (V, n_real, b, q, a, g); with b > 1 the last sample is fully masked.
K3_EDGES = [pytest.param(65, 60, 2, Q, A, 1, id="B2-65-60-G1"),
            pytest.param(65, 60, 2, Q, A, 3, id="B2-65-60-G3"),
            pytest.param(7, 5, 3, 5, 3, 1, id="B3-7-5-Q5A3G1"),
            pytest.param(113, 100, 2, Q, A, G, id="B2-113-100-resident"),
            pytest.param(114, 100, 2, Q, A, G, id="B2-114-100-looped"),
            pytest.param(50, 50, 1, Q, A, G, id="B1-50-50-all-real")]


def softmax_inputs(rng, V, n_real, b=B, q=Q, a=A, g=G):
    """Logits [b,V,q,a,g] and a mask with n_real boxes a sample, the last
    sample fully masked when b > 1."""
    logits = (3 * rng.randn(b, V, q, a, g)).astype(np.float32)
    mask = np.repeat(np.arange(V)[None] < n_real, b, 0)
    mask[-1] &= b == 1
    return logits, mask


def attention_inputs(rng, V, n_real, b=B, g=G):
    v_r = rng.randn(b, V, R, X).astype(np.float32)
    q_r = rng.randn(b, Q, R, X).astype(np.float32)
    a_r = rng.randn(b, A, R, X).astype(np.float32)
    T = (0.1 * rng.randn(R, X, X, X, g)).astype(np.float32)
    mask = np.repeat(np.arange(V)[None] < n_real, b, 0)
    return v_r, q_r, a_r, T, mask


def pool_inputs(rng, V, b=B, d=D):
    return (rng.randn(b, V, d).astype(np.float32),
            rng.randn(b, Q, d).astype(np.float32),
            rng.randn(b, A, d).astype(np.float32),
            rng.rand(b, V, Q, A).astype(np.float32))


def t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_precontract_qa_matches_jax(rng):
    _, q_r, a_r, T, _ = attention_inputs(rng, 10, 8)
    want = np.asarray(jax_precontract_qa(*map(jnp.asarray, (q_r, a_r, T))))
    got = K.precontract_qa(*t(q_r, a_r, T))
    assert got.is_contiguous() and got.shape == (B, Q, A, R, X, G)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("V,n_real,b,g", [
    pytest.param(10, 8, B, G, id="10-8"),
    pytest.param(300, 263, B, G, id="300-263")] + K1_EDGES)
def test_fused_rank_softmax_ref_matches_pallas_and_xla(rng, V, n_real, b, g):
    """V=300 > 256 is ragged against any power-of-two V tile; the K1_EDGES
    cases sit one row past the CUDA kernel's V tile."""
    v_r, q_r, a_r, T, mask = attention_inputs(rng, V, n_real, b, g)
    jv = [jnp.asarray(x) for x in (v_r, q_r, a_r, T, mask)]
    tqa = jax_precontract_qa(jv[1], jv[2], jv[3])
    want_xla = np.asarray(masked_softmax_vqa_xla(
        attention_logits_xla(*jv[:4]), jv[4]))
    with pltpu.force_tpu_interpret_mode():
        want_pallas = np.asarray(jax_rank_softmax(jv[0], tqa, jv[4]))
    tv_r, tmask = t(v_r, mask)
    got = K.fused_rank_softmax_ref(tv_r, torch.from_numpy(np.array(tqa)),
                                   tmask).numpy()
    np.testing.assert_allclose(got, want_pallas, atol=1e-5)
    np.testing.assert_allclose(got, want_xla, atol=1e-5)
    np.testing.assert_array_equal(got[:, n_real:], 0.0)
    # a float32 sum of up to V*Q*A = 10,800 weights
    np.testing.assert_allclose(got.sum((1, 2, 3)), np.ones((b, g)), atol=1e-4)


def test_fully_masked_row_gives_zeros(rng):
    """A serving bucket's padded rows are fully masked: zeros, not NaN,
    in the plain version, the wrapper and JAX's Pallas kernel."""
    v_r, q_r, a_r, T, mask = attention_inputs(rng, 10, 8)
    mask[1] = False
    tqa = K.precontract_qa(*t(q_r, a_r, T))
    got = K.fused_rank_softmax(torch.from_numpy(v_r), tqa,
                               torch.from_numpy(mask)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[1], 0.0)
    np.testing.assert_allclose(got[0].sum((0, 1, 2)), np.ones(G), atol=1e-5)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_rank_softmax(
            jnp.asarray(v_r), jnp.asarray(tqa.numpy()), jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("V,b,d", [pytest.param(10, B, D, id="10"),
                                   pytest.param(293, B, D, id="293")]
                         + K2_EDGES)
def test_trilinear_pool_ref_matches_pallas_and_xla(rng, V, b, d):
    """V=293 streams two of the Pallas kernel's 256-box blocks; the K2_EDGES
    cases sit one row past the CUDA kernel's ring stages and off its d
    span."""
    arrays = pool_inputs(rng, V, b, d)
    jarrays = [jnp.asarray(x) for x in arrays]
    want_xla = np.asarray(trilinear_pool_xla(*jarrays))
    with pltpu.force_tpu_interpret_mode():
        want_pallas = np.asarray(trilinear_pool_pallas(*jarrays))
    got = K.trilinear_pool_ref(*t(*arrays)).numpy()
    scale = np.abs(want_xla).max()
    np.testing.assert_allclose(got, want_xla, rtol=2e-4, atol=2e-4 * scale)
    np.testing.assert_allclose(got, want_pallas, rtol=2e-4, atol=2e-4 * scale)


def test_trilinear_pool_takes_a_strided_glimpse(rng):
    """The model passes att[..., g] (stride G); the result is that of the
    contiguous copy."""
    vt, qt, at, _ = pool_inputs(rng, 10)
    att = torch.from_numpy(rng.rand(B, 10, Q, A, G).astype(np.float32))
    w = att[..., 1]
    assert not w.is_contiguous()
    got = K.trilinear_pool(*t(vt, qt, at), w)
    want = K.trilinear_pool_ref(*t(vt, qt, at), w.contiguous())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_cpu_wrappers_run_the_plain_version_and_count_nothing(rng):
    v_r, q_r, a_r, T, mask = attention_inputs(rng, 10, 8)
    tqa = K.precontract_qa(*t(q_r, a_r, T))
    K.reset_launches()
    got = K.fused_rank_softmax(torch.from_numpy(v_r), tqa,
                               torch.from_numpy(mask))
    want = K.fused_rank_softmax_ref(torch.from_numpy(v_r), tqa,
                                    torch.from_numpy(mask))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    arrays = t(*pool_inputs(rng, 10))
    torch.testing.assert_close(K.trilinear_pool(*arrays),
                               K.trilinear_pool_ref(*arrays), rtol=0, atol=0)
    logits = torch.from_numpy(rng.randn(B, 10, Q, A, G).astype(np.float32))
    mask_t = torch.from_numpy(mask)
    torch.testing.assert_close(K.masked_softmax_vqa(logits, mask_t),
                               K.masked_softmax_vqa_ref(logits, mask_t),
                               rtol=0, atol=0)
    att = K.masked_softmax_vqa_ref(logits, mask_t)
    torch.testing.assert_close(K.softmax_vqa_backward(att, logits),
                               K.softmax_vqa_backward_ref(att, logits),
                               rtol=0, atol=0)
    g = torch.from_numpy(rng.randn(B, D).astype(np.float32))
    grads = [torch.autograd.grad(f(*xs), xs, g) for f, xs in (
        (K.trilinear_pool, [x.clone().requires_grad_() for x in arrays]),
        (K.trilinear_pool_ref, [x.clone().requires_grad_() for x in arrays]))]
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert K.launches == {"fused_rank_softmax": 0, "trilinear_pool": 0,
                          "masked_softmax_vqa": 0, "softmax_vqa_backward": 0,
                          "fused_rank_softmax_bf16": 0,
                          "trilinear_pool_bf16": 0,
                          "masked_softmax_vqa_bf16": 0,
                          "trilinear_pool_backward": 0,
                          "trilinear_pool_backward_bf16": 0,
                          "linear_f32": 0, "linear_f32_wgrad": 0,
                          "linear_f32_dgrad": 0}


# -- gradients ----------------------------------------------------------------

def vjp_jax(fn, args, cotangent):
    """JAX's VJP of ``fn`` at ``args`` (numpy), Pallas in interpret mode."""
    with pltpu.force_tpu_interpret_mode():
        _, pullback = jax.vjp(fn, *map(jnp.asarray, args))
        return [np.asarray(x) for x in pullback(jnp.asarray(cotangent))]


def grads_torch(fn, args, cotangent):
    """The port's CPU gradients of ``fn`` at ``args`` (numpy)."""
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    return [x.numpy() for x in torch.autograd.grad(
        fn(*ts), ts, torch.from_numpy(cotangent))]


@pytest.mark.parametrize("V,n_real", [(10, 8), (300, 263)])
def test_fused_rank_softmax_grads_match_jax_custom_vjp(rng, V, n_real):
    """K1's ``dv`` and ``dtqa`` against ``jax.vjp`` of the Pallas
    ``custom_vjp``; V=300 > 256 is ragged against any power-of-two tile."""
    v_r, q_r, a_r, T, mask = attention_inputs(rng, V, n_real)
    mask[-1] = False
    tqa = np.array(jax_precontract_qa(*map(jnp.asarray, (q_r, a_r, T))))
    g = rng.randn(B, V, Q, A, G).astype(np.float32)
    want = vjp_jax(lambda v, tq: jax_rank_softmax(v, tq, jnp.asarray(mask)),
                   (v_r, tqa), g)
    got = grads_torch(lambda v, tq: K.fused_rank_softmax(
        v, tq, torch.from_numpy(mask)), (v_r, tqa), g)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x, y, atol=1e-5)
    np.testing.assert_array_equal(got[0][-1], 0.0)  # fully masked sample


# The shapes csrc/tri_pool_backward.cu takes: (Q, A) of its <12, 3>, <6, 6>
# (two passes at Q=12) and <4, 8> (eight at Q=32) instances and one that
# fills none; V of one box, inside one 8-row ring stage and over many; D
# ragged against its 256-d span (36, 264); bf16 vt with bf16 qt/at (glimpse
# 0) and float32 ones (glimpse 1).  Cases "10" and "293" are the model's.
K2_BWD_CASES = [
    pytest.param(12, 3, 10, D, "float32", "float32", id="10"),
    pytest.param(12, 3, 293, D, "float32", "float32", id="293"),
    pytest.param(12, 3, 1, 264, "float32", "float32", id="Q12A3-V1-D264"),
    pytest.param(12, 6, 10, 36, "float32", "float32", id="Q12A6-V10-D36"),
    pytest.param(12, 6, 293, D, "float32", "float32", id="Q12A6-V293"),
    pytest.param(32, 8, 10, D, "float32", "float32", id="Q32A8-V10"),
    pytest.param(5, 2, 10, 264, "float32", "float32", id="Q5A2-V10-D264"),
    pytest.param(5, 2, 1, D, "float32", "float32", id="Q5A2-V1"),
    pytest.param(12, 3, 10, D, "bfloat16", "bfloat16", id="bf16-glimpse0"),
    pytest.param(12, 3, 293, 264, "bfloat16", "float32",
                 id="bf16-glimpse1-V293-D264"),
    pytest.param(12, 6, 10, D, "bfloat16", "bfloat16", id="bf16-Q12A6-glimpse0"),
    pytest.param(12, 6, 1, D, "bfloat16", "float32", id="bf16-Q12A6-glimpse1-V1"),
    pytest.param(32, 8, 10, D, "bfloat16", "bfloat16", id="bf16-Q32A8-glimpse0"),
    pytest.param(5, 2, 10, 264, "bfloat16", "float32", id="bf16-Q5A2-glimpse1")]


def operand_pair(x, dtype):
    """The same values, in ``dtype``, for JAX and torch."""
    if dtype == "bfloat16":
        return bf16_pair(x)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("q,a,V,d,vt_dtype,qa_dtype", K2_BWD_CASES)
def test_trilinear_pool_grads_match_jax_custom_vjp(rng, q, a, V, d, vt_dtype,
                                                   qa_dtype):
    """K2's four cotangents: the plain version (``trilinear_pool_grads``,
    float32) against JAX's ``_tri_pool_bwd``, the Pallas ``custom_vjp``'s
    backward, on the same operands, with ``w`` one strided glimpse as the
    model passes it; and, in float32, autograd through ``trilinear_pool``
    on the CPU gives JAX's (zero on the other glimpse)."""
    vt, qt, at = (rng.randn(B, n, d).astype(np.float32) for n in (V, q, a))
    att = rng.rand(B, V, q, a, G).astype(np.float32)
    g = rng.randn(B, d).astype(np.float32)
    (jvt, tvt), (jqt, tqt), (jat, tat) = (
        operand_pair(x, dt) for x, dt in ((vt, vt_dtype), (qt, qa_dtype),
                                          (at, qa_dtype)))
    want = [np.asarray(x) for x in jax.jit(_tri_pool_bwd)(
        (jvt, jqt, jat, jnp.asarray(att)[..., 1]), jnp.asarray(g))]
    tg, tw = torch.from_numpy(g), torch.from_numpy(att)[..., 1]
    got = K.trilinear_pool_grads(tg, tvt, tqt, tat, tw)
    for x, y in zip(got, want):
        assert x.dtype == torch.float32 and x.shape == y.shape
        scale = np.abs(y).max()
        np.testing.assert_allclose(x.numpy(), y, rtol=2e-4, atol=2e-4 * scale)
    if vt_dtype == "float32":
        auto = grads_torch(lambda a_, b_, c_, w_: K.trilinear_pool(
            a_, b_, c_, w_[..., 1]), (vt, qt, at, att), g)
        for x, y in zip(auto[:3] + [auto[3][..., 1]], want):
            scale = np.abs(y).max()
            np.testing.assert_allclose(x, y, rtol=2e-4, atol=2e-4 * scale)
        np.testing.assert_array_equal(auto[3][..., 0], 0.0)


@pytest.mark.parametrize("V,n_real,b,q,a,g", [
    pytest.param(10, 8, B, Q, A, G, id="10-8"),
    pytest.param(300, 263, B, Q, A, G, id="300-263")] + K3_EDGES)
def test_masked_softmax_vqa_matches_pallas_forward_and_grad(rng, V, n_real,
                                                            b, q, a, g):
    """K3: the forward against ``masked_softmax_vqa_pallas`` and the
    gradient against its ``custom_vjp``; with more than one sample the last
    is fully masked and gives zeros and a zero gradient.  The K3_EDGES
    cases are the CUDA kernel's edges."""
    logits, mask = softmax_inputs(rng, V, n_real, b, q, a, g)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(masked_softmax_vqa_pallas(jnp.asarray(logits),
                                                    jnp.asarray(mask)))
    got = K.masked_softmax_vqa(torch.from_numpy(logits),
                               torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    if b > 1:
        np.testing.assert_array_equal(got[-1], 0.0)
    np.testing.assert_array_equal(got[:, n_real:], 0.0)
    cot = rng.randn(*logits.shape).astype(np.float32)
    (want_g,) = vjp_jax(lambda x: _masked_softmax_pallas_vjp(x, jnp.asarray(mask)),
                        (logits,), cot)
    (got_g,) = grads_torch(lambda x: K.masked_softmax_vqa(
        x, torch.from_numpy(mask)), (logits,), cot)
    np.testing.assert_allclose(got_g, want_g, atol=1e-5)
    if b > 1:
        np.testing.assert_array_equal(got_g[-1], 0.0)


def test_trilinear_attention_matches_jax_pallas_backend(rng):
    """Logits, then K3: ``trilinear_attention(..., backend="pallas")``."""
    v_r, q_r, a_r, T, mask = attention_inputs(rng, 10, 8)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_tri_attention(
            *map(jnp.asarray, (v_r, q_r, a_r, T, mask)), backend="pallas"))
    got = K.trilinear_attention(*t(v_r, q_r, a_r, T, mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(
        K.attention_logits_ref(*t(v_r, q_r, a_r, T)).numpy(),
        np.asarray(attention_logits_xla(*map(jnp.asarray, (v_r, q_r, a_r, T)))),
        atol=1e-4)


def test_rank_contraction_grads_match_autograd(rng):
    """The two bmm products of K1's backward (``:322-323``) against
    autograd of the plain contraction."""
    v_r, q_r, a_r, T, _ = attention_inputs(rng, 11, 11)
    tqa = K.precontract_qa(*t(q_r, a_r, T)).numpy()
    dl = rng.randn(B, 11, Q, A, G).astype(np.float32)
    want = grads_torch(lambda v, tq: torch.einsum("birx,bjlrxg->bijlg", v, tq),
                       (v_r, tqa), dl)
    got = K.rank_contraction_grads(*t(dl, v_r, tqa))
    assert got[1].shape == (B, Q, A, R, X, G)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), y, atol=1e-5)


def test_trilinear_pool_grads_match_autograd(rng):
    """The bmm cotangents of K2's backward (``:415-426``) against autograd
    of the plain pool."""
    vt, qt, at, _ = pool_inputs(rng, 13)
    att = rng.rand(B, 13, Q, A, G).astype(np.float32)
    g = rng.randn(B, D).astype(np.float32)
    want = grads_torch(lambda a, b, c, w: K.trilinear_pool_ref(a, b, c, w[..., 0]),
                       (vt, qt, at, att), g)
    got = K.trilinear_pool_grads(*t(g, vt, qt, at), torch.from_numpy(att)[..., 0])
    want[3] = want[3][..., 0]
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), y, rtol=2e-4,
                                   atol=2e-4 * np.abs(y).max())


def test_softmax_vqa_backward_matches_autograd(rng):
    """``att * (g - sum g*att)`` is the VJP of the masked softmax, zero on
    masked boxes."""
    logits = rng.randn(B, 9, Q, A, G).astype(np.float32)
    mask = np.repeat(np.arange(9)[None] < 7, B, 0)
    g = rng.randn(*logits.shape).astype(np.float32)
    (want,) = grads_torch(lambda x: K.masked_softmax_vqa_ref(
        x, torch.from_numpy(mask)), (logits,), g)
    att = K.masked_softmax_vqa_ref(*t(logits, mask))
    got = K.softmax_vqa_backward(att, torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_array_equal(got[:, 7:], 0.0)


@pytest.mark.parametrize("V,n_real,b,q,a,g", K3_EDGES)
def test_softmax_vqa_backward_matches_autograd_at_edges(rng, V, n_real, b, q,
                                                        a, g):
    """The softmax backward at the CUDA kernel's edges, against autograd of
    the plain softmax and against JAX's ``_softmax_bwd`` (the Pallas
    ``custom_vjp``'s backward)."""
    logits, mask = softmax_inputs(rng, V, n_real, b, q, a, g)
    cot = rng.randn(*logits.shape).astype(np.float32)
    (want,) = grads_torch(lambda x: K.masked_softmax_vqa_ref(
        x, torch.from_numpy(mask)), (logits,), cot)
    att = K.masked_softmax_vqa_ref(*t(logits, mask))
    got = K.softmax_vqa_backward(att, torch.from_numpy(cot)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    want_jax, _ = _softmax_bwd(jnp.asarray(att.numpy()), jnp.asarray(cot))
    np.testing.assert_allclose(got, np.asarray(want_jax), atol=1e-6)
    np.testing.assert_array_equal(got[:, n_real:], 0.0)
    if b > 1:
        np.testing.assert_array_equal(got[-1], 0.0)


@pytest.mark.parametrize("bad", [
    "dtype", "shape", "mask_dtype", "device", "bwd_g_dtype", "bwd_g_shape",
    "bwd_w_shape", "bwd_qt_dtype", "bwd_q_limit", "bwd_a_limit",
    "bwd_d_unit", "bwd_device"])
def test_wrappers_check_their_inputs(rng, bad):
    if bad.startswith("bwd_"):
        return check_backward_refuses(rng, bad[4:])
    v_r, q_r, a_r, T, mask = attention_inputs(rng, 10, 8)
    v_r, mask = t(v_r, mask)
    tqa = K.precontract_qa(*t(q_r, a_r, T))
    if bad == "dtype":
        v_r = v_r.double()
    elif bad == "shape":
        tqa = tqa[:1]
    elif bad == "mask_dtype":
        mask = mask.float()
    else:
        v_r, tqa, mask = (x.to("meta") for x in (v_r, tqa, mask))
    with pytest.raises((TypeError, ValueError)):
        K.fused_rank_softmax(v_r, tqa, mask)


def check_backward_refuses(rng, bad):
    """K2's backward wrapper refuses, before anything needs the card, what
    no kernel instance takes (CPU and meta tensors): ``g`` not float32
    [B, D], ``w`` of another shape, float32 ``vt`` with bf16 ``qt``, Q >
    32, A > 8, a bf16 D that is not a multiple of 8 and a device that is
    not CUDA."""
    vt, qt, at, w = t(*pool_inputs(rng, 10))
    g = torch.from_numpy(rng.randn(B, D).astype(np.float32))
    bf = torch.bfloat16
    with pytest.raises((TypeError, ValueError)) as err:
        if bad == "g_dtype":
            K._tri_pool_backward_kernel(g.double(), vt, qt, at, w)
        elif bad == "g_shape":
            K._tri_pool_backward_kernel(g[:, :-4], vt, qt, at, w)
        elif bad == "w_shape":
            K._tri_pool_backward_kernel(g, vt, qt, at, w[:, :-1])
        elif bad == "qt_dtype":
            K._tri_pool_backward_kernel(g, vt, qt.to(bf), at.to(bf), w)
        elif bad == "q_limit":
            q33 = torch.zeros(B, K.TRI_POOL_MAX_Q + 1, D, device="meta")
            K._tri_pool_backward_kernel(g.to("meta"), vt.to("meta"), q33,
                                        at.to("meta"), w.to("meta"))
        elif bad == "a_limit":
            a9 = torch.zeros(B, K.TRI_POOL_MAX_A + 1, D, device="meta")
            K._tri_pool_backward_kernel(g.to("meta"), vt.to("meta"),
                                        qt.to("meta"), a9, w.to("meta"))
        elif bad == "d_unit":
            x = [y[..., :12].to("meta", bf) for y in (vt, qt, at)]
            K._tri_pool_backward_kernel(g[:, :12].to("meta"), *x, w.to("meta"))
        else:
            K._tri_pool_backward_kernel(g, vt, qt, at, w)
    if bad == "d_unit":
        assert "multiple of 8" in str(err.value)
    elif bad == "device":
        assert "no kernel for device" in str(err.value)


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("V,n_real,b,g", [
    pytest.param(10, 8, B, G, id="10-8"), pytest.param(50, 44, B, G, id="50-44"),
    pytest.param(2048, 1999, B, G, id="2048-1999")] + K1_EDGES)
def test_cuda_rank_softmax_matches_plain(rng, cuda, V, n_real, b, g):
    v_r, q_r, a_r, T, mask = attention_inputs(rng, V, n_real, b, g)
    mask[-1] &= b == 1  # with more than one sample, the last is fully masked
    v_r, mask = (x.to(cuda) for x in t(v_r, mask))
    tqa = K.precontract_qa(*(x.to(cuda) for x in t(q_r, a_r, T)))
    K.reset_launches()
    got = K.fused_rank_softmax(v_r, tqa, mask)
    assert K.launches["fused_rank_softmax"] == 1
    torch.testing.assert_close(got, K.fused_rank_softmax_ref(v_r, tqa, mask),
                               rtol=0, atol=1e-5)
    assert b == 1 or (got[-1] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("V,b,d", [pytest.param(10, B, D, id="10"),
                                   pytest.param(50, B, D, id="50"),
                                   pytest.param(293, B, D, id="293")]
                         + K2_EDGES)
def test_cuda_tri_pool_matches_plain(rng, cuda, V, b, d):
    vt, qt, at, _ = (x.to(cuda) for x in t(*pool_inputs(rng, V, b, d)))
    w = torch.from_numpy(rng.rand(b, V, Q, A, G).astype(np.float32)).to(cuda)
    K.reset_launches()
    got = K.trilinear_pool(vt, qt, at, w[..., 1])
    assert K.launches["trilinear_pool"] == 1
    want = K.trilinear_pool_ref(vt, qt, at, w[..., 1])
    torch.testing.assert_close(got, want, rtol=2e-4,
                               atol=2e-4 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", [("float32", "float32"),
                                    ("bfloat16", "bfloat16"),
                                    ("bfloat16", "float32")],
                         ids=["f32", "bf16-glimpse0", "bf16-glimpse1"])
@pytest.mark.parametrize("q,a,V,b,d", [
    pytest.param(12, 3, 50, 256, 1024, id="free-form-B256"),
    pytest.param(12, 6, 50, 3, 1024, id="mc-QA72"),
    pytest.param(32, 8, 293, 3, 512, id="QA256-V293-D512"),
    pytest.param(12, 3, 1, 1, 1016, id="V1-B1-D1016"),
    pytest.param(12, 3, 2048, 3, 1024, id="V2048"),
    pytest.param(5, 2, 293, 3, 264, id="Q5A2-D264"),
    pytest.param(12, 3, 50, 0, 1024, id="B0")])
def test_cuda_tri_pool_backward_matches_plain(rng, cuda, q, a, V, b, d, dtypes):
    """K2's backward kernel against ``trilinear_pool_grads`` on the card:
    ``w`` one strided glimpse, sample 1 with all-zero ``w`` (its gvt, gqt
    and gat exactly zero); 1e-4 of the largest plain magnitude in float32
    (chip_smoke's GRAD_REL_TOL), 2^-7 with bf16 cotangents; two calls give
    the same bits; one launch a call (none at B=0)."""
    vt_dtype, qa_dtype = (getattr(torch, x) for x in dtypes)
    vt, qt, at = (torch.from_numpy(rng.randn(b, n, d).astype(np.float32)).to(cuda, dt)
                  for n, dt in ((V, vt_dtype), (q, qa_dtype), (a, qa_dtype)))
    att = torch.from_numpy(rng.rand(b, V, q, a, G).astype(np.float32)).to(cuda)
    if b > 1:
        att[1] = 0
    g = torch.from_numpy(rng.randn(b, d).astype(np.float32)).to(cuda)
    args = (g, vt, qt, at, att[..., 1])
    K.reset_launches()
    got = K._tri_pool_backward_kernel(*args)
    again = K._tri_pool_backward_kernel(*args)
    sfx = "_bf16" if vt_dtype == torch.bfloat16 else ""
    assert K.launches["trilinear_pool_backward" + sfx] == (2 if b else 0)
    rel = 1e-4 if vt_dtype == torch.float32 else 2.0 ** -7
    for x, y, z, p in zip(got, K.trilinear_pool_grads(*args), again, args[1:]):
        assert x.dtype == p.dtype and torch.equal(x, z)
        if y.numel():
            torch.testing.assert_close(x.float(), y, rtol=0,
                                       atol=rel * y.abs().max().item())
    if b > 1:
        assert all((x[1] == 0).all() for x in got[:3])


def test_kernel_inputs_must_be_16_byte_aligned():
    """The 16-byte copies of K1 and K2 need aligned bases; a view that
    starts off a 16-byte boundary is refused before any launch."""
    base = torch.zeros(64)
    K._check_aligned(whole=base, at_16_bytes=base[4:])
    with pytest.raises(ValueError, match="off_by_4"):
        K._check_aligned(off_by_4=base[1:])


@pytest.mark.parametrize("lib", build.SOURCES)
def test_entry_points_match_the_c_sources(lib):
    """Each library's ctypes signatures (bound once, as it loads) name the
    ``extern "C"`` functions of its source with as many arguments."""
    src = (build.CSRC / f"{lib}.cu").read_text()
    found = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src))
    assert set(found) == set(build.ENTRY_POINTS[lib])
    for fn, argtypes in build.ENTRY_POINTS[lib].items():
        params = [p for p in found[fn].split(",") if p.strip() not in ("", "void")]
        assert len(params) == len(argtypes), fn


@pytest.mark.parametrize("bad", ["dtype", "shape", "mask_dtype", "device"])
def test_masked_softmax_checks_its_inputs(rng, bad):
    logits = torch.from_numpy(rng.randn(B, 10, Q, A, G).astype(np.float32))
    mask = torch.ones(B, 10, dtype=torch.bool)
    if bad == "dtype":
        logits = logits.double()
    elif bad == "shape":
        logits = logits[..., 0]
    elif bad == "mask_dtype":
        mask = mask.float()
    else:
        logits, mask = logits.to("meta"), mask.to("meta")
    with pytest.raises((TypeError, ValueError)):
        K.masked_softmax_vqa(logits, mask)


@pytest.mark.cuda
def offset_copy(x: torch.Tensor, floats: int) -> torch.Tensor:
    """A contiguous copy of ``x`` that starts ``floats`` floats past a
    16-byte boundary."""
    buf = torch.empty(x.numel() + 4, dtype=x.dtype, device=x.device)
    out = buf[floats:floats + x.numel()].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("V,n_real,b,q,a,g,shift", [
    pytest.param(10, 8, B, Q, A, G, 0, id="10-8"),
    pytest.param(50, 44, B, Q, A, G, 0, id="50-44"),
    pytest.param(2048, 1999, B, Q, A, G, 0, id="2048-1999")] + [
    pytest.param(*p.values, 0, id=p.id) for p in K3_EDGES] + [
    pytest.param(227, 200, 2, Q, A, 1, 0, id="B2-227-200-G1-resident"),
    pytest.param(228, 200, 2, Q, A, 1, 0, id="B2-228-200-G1-looped"),
    pytest.param(71, 60, 2, Q, A, 3, 0, id="B2-71-60-G3-resident"),
    pytest.param(72, 60, 2, Q, A, 3, 0, id="B2-72-60-G3-looped"),
    pytest.param(10, 8, B, Q, A, G, 1, id="10-8-misaligned"),
    pytest.param(300, 263, B, Q, A, G, 3, id="300-263-misaligned")])
def test_cuda_masked_softmax_and_backward_match_plain(rng, cuda, V, n_real, b,
                                                      q, a, g, shift):
    """With ``shift`` the inputs start that many floats past a 16-byte
    boundary, so the outputs (fresh, aligned) are out of phase with them
    and the kernels take 4-byte units."""
    logits, mask = softmax_inputs(rng, V, n_real, b, q, a, g)
    cot = torch.from_numpy(rng.randn(*logits.shape).astype(np.float32)).to(cuda)
    logits, mask = (x.to(cuda) for x in t(logits, mask))
    if shift:
        logits, cot = offset_copy(logits, shift), offset_copy(cot, shift)
    K.reset_launches()
    att = K.masked_softmax_vqa(logits, mask)
    att_in = offset_copy(att, shift) if shift else att
    dl = K.softmax_vqa_backward(att_in, cot)
    assert K.launches["masked_softmax_vqa"] == 1
    assert K.launches["softmax_vqa_backward"] == 1
    torch.testing.assert_close(att, K.masked_softmax_vqa_ref(logits, mask),
                               rtol=0, atol=1e-5)
    torch.testing.assert_close(dl, K.softmax_vqa_backward_ref(att, cot),
                               rtol=0, atol=1e-5)
    assert b == 1 or ((att[-1] == 0).all() and (dl[-1] == 0).all())


def test_softmax_vqa_refuses_more_glimpses_than_its_kernel():
    """The limit is checked before anything needs the card."""
    logits = torch.zeros(1, 2, 1, 1, K.SOFTMAX_VQA_MAX_G + 1)
    with pytest.raises(ValueError, match="exceeds the kernel"):
        K._softmax_vqa_call("masked_softmax_vqa_forward", "masked_softmax_vqa",
                            ("logits", "v_mask"), logits.to("meta"),
                            torch.ones(1, 2, dtype=torch.bool).to("meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["K1", "K2", "K3"])
def test_cuda_grads_match_plain(rng, cuda, kernel):
    """Each autograd.Function's gradients against autograd through its
    plain version, at V=293 (ragged)."""
    V = 293
    if kernel == "K1":
        v_r, q_r, a_r, T, mask = attention_inputs(rng, V, 250)
        tqa = K.precontract_qa(*t(q_r, a_r, T)).numpy()
        args, mask = (v_r, tqa), torch.from_numpy(mask).to(cuda)
        fn, ref = (lambda a, b: K.fused_rank_softmax(a, b, mask),
                   lambda a, b: K.fused_rank_softmax_ref(a, b, mask))
        g = rng.randn(B, V, Q, A, G)
    elif kernel == "K2":
        args = pool_inputs(rng, V)[:3] + (rng.rand(B, V, Q, A, G).astype(np.float32),)
        fn, ref = (lambda a, b, c, w: K.trilinear_pool(a, b, c, w[..., 1]),
                   lambda a, b, c, w: K.trilinear_pool_ref(a, b, c, w[..., 1]))
        g = rng.randn(B, D)
    else:
        args = ((3 * rng.randn(B, V, Q, A, G)).astype(np.float32),)
        mask = torch.from_numpy(np.arange(V)[None] < 250).repeat(B, 1).to(cuda)
        fn, ref = (lambda x: K.masked_softmax_vqa(x, mask),
                   lambda x: K.masked_softmax_vqa_ref(x, mask))
        g = rng.randn(B, V, Q, A, G)
    g = torch.from_numpy(g.astype(np.float32)).to(cuda)

    def grads(f):
        ts = [torch.from_numpy(a).to(cuda).requires_grad_() for a in args]
        return torch.autograd.grad(f(*ts), ts, g)

    K.reset_launches()
    got = grads(fn)
    assert sum(K.launches.values()) >= 2, K.launches
    for x, y in zip(got, grads(ref)):
        scale = y.abs().max().item()
        torch.testing.assert_close(x, y, rtol=2e-4, atol=max(1e-5, 2e-4 * scale))


# -- bf16 operands (compute_dtype="bfloat16") ------------------------------------
#
# JAX's Pallas backend passes K1 bf16 v_r and tqa, and K2 bf16 vt with qt/at
# bf16 at glimpse 0 and float32 at glimpse 1; both kernels compute and
# return float32.  The same bf16 values go to both sides (numpy float32
# rounded to nearest even by jnp and by torch), so the plain versions, which
# upcast exactly, meet the float32 tolerances.  The cotangents JAX returns
# are float32 (its custom_vjp does not cast them back: the reference fault
# of ROADMAP queue C); the port's take the primal's dtype, so they are held
# to JAX's after a bf16 rounding: 2^-8 of each value, plus 2^-8 of the
# largest for the values that round near zero.

BF16_REL = 2.0 ** -8


def bf16_pair(x):
    """The same bf16 values for JAX and torch."""
    return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("V,n_real,b,g", [
    pytest.param(10, 8, B, G, id="10-8"),
    pytest.param(300, 263, B, G, id="300-263")] + K1_EDGES)
def test_fused_rank_softmax_bf16_matches_pallas(rng, V, n_real, b, g):
    """K1's plain version on bf16 operands against the Pallas kernel on the
    same bf16 operands (interpret mode); float32 out, 1e-5."""
    v_r, q_r, a_r, T, mask = attention_inputs(rng, V, n_real, b, g)
    mask[-1] &= b == 1
    tqa = np.array(jax_precontract_qa(*map(jnp.asarray, (q_r, a_r, T))))
    (jv, tv), (jt, tt) = bf16_pair(v_r), bf16_pair(tqa)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_rank_softmax(jv, jt, jnp.asarray(mask)))
    got = K.fused_rank_softmax(tv, tt, torch.from_numpy(mask))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert b == 1 or (got[-1] == 0).all()


@pytest.mark.parametrize("qa_dtype", ["bfloat16", "float32"],
                         ids=["glimpse0-bf16", "glimpse1-mixed"])
@pytest.mark.parametrize("V,b,d", [pytest.param(10, B, D, id="10"),
                                   pytest.param(293, B, D, id="293")]
                         + K2_EDGES)
def test_trilinear_pool_bf16_matches_pallas(rng, V, b, d, qa_dtype):
    """K2's plain version with bf16 ``vt`` and ``qt``/``at`` bf16 or
    float32, against the Pallas kernel on the same operands; ``w`` one
    strided float32 glimpse; 2e-4 of the largest output, as in float32."""
    vt, qt, at, _ = pool_inputs(rng, V, b, d)
    att = rng.rand(b, V, Q, A, G).astype(np.float32)
    jvt, tvt = bf16_pair(vt)
    if qa_dtype == "bfloat16":
        (jqt, tqt), (jat, tat) = bf16_pair(qt), bf16_pair(at)
    else:
        (jqt, jat), (tqt, tat) = map(jnp.asarray, (qt, at)), t(qt, at)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(trilinear_pool_pallas(jvt, jqt, jat,
                                                jnp.asarray(att)[..., 1]))
    got = K.trilinear_pool(tvt, tqt, tat, torch.from_numpy(att)[..., 1])
    assert got.dtype == torch.float32 and want.dtype == np.float32
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4 * scale)


SMALL = dict(ntoken=50, v_dim=32, num_ans_candidates=17, model="cti",
             num_hid=32, h_mm=16, rank=4, gamma=2)  # tests/test_models.py


@pytest.mark.parametrize("seed", [3, 5])
def test_split_bf16x3_reconstructs_the_bf16_forwards_attention(seed):
    """The three bf16 terms of every attention weight of the port's bf16
    forward (small width, JAX's weights carried across by
    ``torch_state_from_jax``) add up to the weight bit for bit, so the
    tensor-core K2 multiplies the float32 ``w`` without rounding it; the
    third term is needed (two leave some weights short)."""
    cfg = ModelConfig(**SMALL)
    model = build_model(cfg)
    model.load_state_dict(torch_state_from_jax(numpy_params(cfg, seed=seed)))
    batch = numpy_batch(cfg, 2, seed=seed + 1, boxes=8, real_boxes=6)
    with torch.inference_mode():
        _, att = model.to(torch.bfloat16).eval()(
            torch.from_numpy(batch["v"]).to(torch.bfloat16),
            *(torch.from_numpy(batch[k]) for k in "qa"))
    assert att.dtype == torch.float32 and att.shape[-1] == SMALL["gamma"]
    w0, w1, w2 = K.split_bf16x3(att)
    assert {w.dtype for w in (w0, w1, w2)} == {torch.bfloat16}
    assert torch.equal((w0.float() + w1.float()) + w2.float(), att)
    assert not torch.equal(w0.float() + w1.float(), att)


@pytest.mark.parametrize("qa_dtype", ["bfloat16", "float32"],
                         ids=["glimpse0-bf16", "glimpse1-mixed"])
@pytest.mark.parametrize("V,b,d", [pytest.param(10, B, D, id="10"),
                                   pytest.param(293, B, D, id="293")]
                         + K2_EDGES)
def test_three_term_pool_matches_pallas(rng, V, b, d, qa_dtype):
    """The pool as the tensor-core K2 computes it: ``w`` as its three bf16
    terms (:func:`split_bf16x3`), each product bf16 x bf16 (exact in
    float32), every sum float32, V first; against the Pallas kernel on the
    same operands (interpret mode, bf16 ``vt``), within K2's tolerance of
    2e-4 of the largest output."""
    vt, qt, at, _ = pool_inputs(rng, V, b, d)
    att = rng.rand(b, V, Q, A, G).astype(np.float32)
    jvt, tvt = bf16_pair(vt)
    if qa_dtype == "bfloat16":
        (jqt, tqt), (jat, tat) = bf16_pair(qt), bf16_pair(at)
    else:
        (jqt, jat), (tqt, tat) = map(jnp.asarray, (qt, at)), t(qt, at)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(trilinear_pool_pallas(jvt, jqt, jat,
                                                jnp.asarray(att)[..., 1]))
    terms = K.split_bf16x3(torch.from_numpy(att)[..., 1])
    wv = sum(torch.einsum("bvqa,bvd->bqad", wk.float(), tvt.float())
             for wk in terms)
    m = torch.einsum("bqad,bqd->bad", wv, tqt.float())
    got = torch.einsum("bad,bad->bd", m, tat.float())
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4 * scale)


# The term pairs (a's term, b's term) csrc/tri_pool_backward.cu sums in a
# product, smallest first: two float32 operands split in three, an exact
# bf16 operand against a split one, and gvt at bf16 (two terms each).
PAIRS_SPLIT = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))
PAIRS_EXACT = ((0, 2), (0, 1), (0, 0))
PAIRS_TWO = ((1, 0), (0, 1), (0, 0))


def split_term_pool_grads(g, vt, qt, at, w):
    """K2's four cotangents as its backward kernel computes them: ``w``,
    ``gP = qt·at·g`` and a float32 ``vt`` as their :func:`split_bf16x3`
    terms (a bf16 ``vt`` as it is), each product the sum of its term pairs'
    products (each exact in float32), every sum float32; each cotangent
    rounded once to its primal's dtype."""
    B_, V_, D_ = vt.shape
    Q_, A_ = qt.shape[1], at.shape[1]
    gp = ((qt.float()[:, :, None] * at.float()[:, None]).reshape(B_, Q_ * A_, D_)
          * g[:, None])
    ws = [x.float() for x in K.split_bf16x3(w.reshape(B_, V_, Q_ * A_))]
    gps = [x.float() for x in K.split_bf16x3(gp)]
    f32 = vt.dtype == torch.float32
    vts = [x.float() for x in K.split_bf16x3(vt)] if f32 else [vt.float()]
    pairs = PAIRS_SPLIT if f32 else PAIRS_EXACT

    def product(a_terms, b_terms, pairs, fn):
        return sum(fn(a_terms[i], b_terms[k]) for i, k in pairs)

    u = product(vts, ws, pairs, lambda v, w_: torch.bmm(w_.transpose(1, 2), v))
    gvt = product(ws, gps, pairs if f32 else PAIRS_TWO, torch.bmm)
    gw = product(vts, gps, pairs, lambda v, p: torch.bmm(v, p.transpose(1, 2)))
    u = u.reshape(B_, Q_, A_, D_)
    gqt = (u * at.float()[:, None]).sum(2) * g[:, None]
    gat = (u * qt.float()[:, :, None]).sum(1) * g[:, None]
    return (gvt.to(vt.dtype), gqt.to(qt.dtype), gat.to(at.dtype),
            gw.reshape(B_, V_, Q_, A_))


@pytest.mark.parametrize("q,a,V,d,vt_dtype,qa_dtype", K2_BWD_CASES)
def test_split_term_pool_grads_match_jax_custom_vjp(rng, q, a, V, d, vt_dtype,
                                                    qa_dtype):
    """The tensor-core K2 backward's arithmetic (its bf16 terms and term
    pairs, :func:`split_term_pool_grads`) against JAX's ``_tri_pool_bwd``
    on the same operands, ``w`` one strided glimpse: within 1e-4 of each
    float32 cotangent's largest magnitude and 2^-7 of each bf16 one's (as
    chip_smoke.py holds the kernel to its plain version)."""
    vt, qt, at = (rng.randn(B, n, d).astype(np.float32) for n in (V, q, a))
    att = rng.rand(B, V, q, a, G).astype(np.float32)
    g = rng.randn(B, d).astype(np.float32)
    (jvt, tvt), (jqt, tqt), (jat, tat) = (
        operand_pair(x, dt) for x, dt in ((vt, vt_dtype), (qt, qa_dtype),
                                          (at, qa_dtype)))
    want = jax.jit(_tri_pool_bwd)((jvt, jqt, jat, jnp.asarray(att)[..., 1]),
                                  jnp.asarray(g))
    got = split_term_pool_grads(torch.from_numpy(g), tvt, tqt, tat,
                                torch.from_numpy(att)[..., 1])
    for x, y, p in zip(got, want, (tvt, tqt, tat, torch.zeros(()))):
        y = np.asarray(y, np.float32)
        assert x.dtype == p.dtype and x.shape == y.shape
        rel = 2.0 ** -7 if x.dtype == torch.bfloat16 else 1e-4
        np.testing.assert_allclose(x.float().numpy(), y, rtol=0,
                                   atol=rel * np.abs(y).max())


def assert_bf16_close(got: torch.Tensor, want: np.ndarray):
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_REL,
                               atol=BF16_REL * np.abs(want).max())


def test_fused_rank_softmax_bf16_grads_take_the_primal_dtype(rng):
    """K1's ``dv`` and ``dtqa`` at bf16: the port's are bf16, JAX's Pallas
    ``custom_vjp`` returns float32 ones (the reference fault), and they
    agree to a bf16 rounding."""
    v_r, q_r, a_r, T, mask = attention_inputs(rng, 10, 8)
    mask[-1] = False
    tqa = np.array(jax_precontract_qa(*map(jnp.asarray, (q_r, a_r, T))))
    g = rng.randn(B, 10, Q, A, G).astype(np.float32)
    (jv, tv), (jt, tt) = bf16_pair(v_r), bf16_pair(tqa)
    with pltpu.force_tpu_interpret_mode():
        _, pull = jax.vjp(lambda v, tq: jax_rank_softmax(v, tq, jnp.asarray(mask)),
                          jv, jt)
        want = [np.asarray(x) for x in pull(jnp.asarray(g))]
    assert [x.dtype for x in want] == [np.float32, np.float32]
    ts = [tv.requires_grad_(), tt.requires_grad_()]
    got = torch.autograd.grad(K.fused_rank_softmax(*ts, torch.from_numpy(mask)),
                              ts, torch.from_numpy(g))
    assert [x.dtype for x in got] == [torch.bfloat16, torch.bfloat16]
    for x, y in zip(got, want):
        assert_bf16_close(x, y)


@pytest.mark.parametrize("qa_dtype", ["bfloat16", "float32"],
                         ids=["glimpse0-bf16", "glimpse1-mixed"])
def test_trilinear_pool_bf16_grads_take_the_primal_dtype(rng, qa_dtype):
    """K2's four cotangents with bf16 ``vt`` (and ``qt``/``at``): each in
    its primal's dtype on the port, float32 from JAX's ``custom_vjp``."""
    vt, qt, at, _ = pool_inputs(rng, 13)
    att = rng.rand(B, 13, Q, A, G).astype(np.float32)
    g = rng.randn(B, D).astype(np.float32)
    jvt, tvt = bf16_pair(vt)
    if qa_dtype == "bfloat16":
        (jqt, tqt), (jat, tat) = bf16_pair(qt), bf16_pair(at)
    else:
        (jqt, jat), (tqt, tat) = map(jnp.asarray, (qt, at)), t(qt, at)
    with pltpu.force_tpu_interpret_mode():
        _, pull = jax.vjp(lambda a, b_, c, w: trilinear_pool_pallas(a, b_, c, w[..., 0]),
                          jvt, jqt, jat, jnp.asarray(att))
        want = [np.asarray(x) for x in pull(jnp.asarray(g))]
    assert all(x.dtype == np.float32 for x in want)
    ts = [x.requires_grad_() for x in (tvt, tqt, tat, torch.from_numpy(att))]
    got = torch.autograd.grad(K.trilinear_pool(*ts[:3], ts[3][..., 0]), ts,
                              torch.from_numpy(g))
    assert [x.dtype for x in got] == [x.dtype for x in ts]
    for x, y in zip(got, want):
        assert_bf16_close(x, y)


@pytest.mark.parametrize("V,n_real,b,q,a,g", [
    pytest.param(10, 8, B, Q, A, G, id="10-8"),
    pytest.param(300, 263, B, Q, A, G, id="300-263")] + K3_EDGES)
def test_masked_softmax_vqa_bf16_matches_pallas(rng, V, n_real, b, q, a, g):
    """K3 on bf16 logits, as ``compute_dtype="bfloat16"`` gives them to it
    through ``return_logits=True``: the forward (float32) against
    ``masked_softmax_vqa_pallas`` on the same bf16 logits (interpret mode),
    1e-5; the gradient comes back bf16, JAX's custom_vjp's float32 (the
    reference fault), within a bf16 rounding of each other."""
    logits, mask = softmax_inputs(rng, V, n_real, b, q, a, g)
    jl, tl = bf16_pair(logits)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(masked_softmax_vqa_pallas(jl, jnp.asarray(mask)))
        _, pull = jax.vjp(lambda x: _masked_softmax_pallas_vjp(
            x, jnp.asarray(mask)), jl)
        cot = rng.randn(*logits.shape).astype(np.float32)
        (want_g,) = [np.asarray(x) for x in pull(jnp.asarray(cot))]
    assert want.dtype == np.float32 and want_g.dtype == np.float32
    tl.requires_grad_()
    K.reset_launches()
    got = K.masked_softmax_vqa(tl, torch.from_numpy(mask))
    (got_g,) = torch.autograd.grad(got, (tl,), torch.from_numpy(cot))
    assert got.dtype == torch.float32 and got_g.dtype == torch.bfloat16
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    assert_bf16_close(got_g, want_g)
    if b > 1:
        np.testing.assert_array_equal(got.detach()[-1].numpy(), 0.0)
        np.testing.assert_array_equal(got_g[-1].float().numpy(), 0.0)
    assert sum(K.launches.values()) == 0  # the plain version, on the CPU


@pytest.mark.parametrize("case", ["k1-mixed", "k1-half", "k2-f32-vt-bf16-qa",
                                  "k2-qt-at-differ", "k2-w-bf16"])
def test_wrappers_refuse_dtypes_without_an_instance(rng, case):
    """Only the dtype combinations JAX's Pallas path passes have kernel
    instances; the wrappers refuse the rest, on the CPU as on the card."""
    v_r, q_r, a_r, T, mask = attention_inputs(rng, 10, 8)
    v_r, mask = t(v_r, mask)
    tqa = K.precontract_qa(*t(q_r, a_r, T))
    vt, qt, at, w = t(*pool_inputs(rng, 10))
    bf = torch.bfloat16
    with pytest.raises(TypeError):
        if case == "k1-mixed":
            K.fused_rank_softmax(v_r.to(bf), tqa, mask)
        elif case == "k1-half":
            K.fused_rank_softmax(v_r.half(), tqa.half(), mask)
        elif case == "k2-f32-vt-bf16-qa":
            K.trilinear_pool(vt, qt.to(bf), at.to(bf), w)
        elif case == "k2-qt-at-differ":
            K.trilinear_pool(vt.to(bf), qt.to(bf), at, w)
        else:
            K.trilinear_pool(vt.to(bf), qt.to(bf), at.to(bf), w.to(bf))


def test_bf16_copies_need_8_element_rows():
    """A 16-byte copy carries 8 bf16: R*X and D must be multiples of 8 for
    bf16 operands (4 for float32), checked before anything needs the card."""
    bf = torch.bfloat16
    v_r = torch.zeros(1, 2, 3, 4, dtype=bf, device="meta")  # R*X = 12
    tqa = torch.zeros(1, Q, A, 3, 4, G, dtype=bf, device="meta")
    mask = torch.ones(1, 2, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="multiple of 8"):
        K._rank_softmax_kernel(v_r, tqa, mask)
    vt = torch.zeros(1, 2, 12, dtype=bf, device="meta")
    qa = [torch.zeros(1, n, 12, dtype=bf, device="meta") for n in (Q, A)]
    with pytest.raises(ValueError, match="multiple of 8"):
        K._tri_pool_kernel(vt, *qa, torch.zeros(1, 2, Q, A, device="meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("V,n_real,b,g", [
    pytest.param(50, 44, B, G, id="50-44"),
    pytest.param(2048, 1999, B, G, id="2048-1999"),
    pytest.param(2048, 1999, B, 1, id="2048-1999-G1"),
    pytest.param(2048, 1999, B, 3, id="2048-1999-G3")] + K1_EDGES)
def test_cuda_rank_softmax_bf16_matches_plain(rng, cuda, V, n_real, b, g):
    v_r, q_r, a_r, T, mask = attention_inputs(rng, V, n_real, b, g)
    mask[-1] &= b == 1
    v_r, mask = torch.from_numpy(v_r).to(cuda, torch.bfloat16), torch.from_numpy(mask).to(cuda)
    tqa = K.precontract_qa(*(x.to(cuda) for x in t(q_r, a_r, T))).to(torch.bfloat16)
    K.reset_launches()
    got = K.fused_rank_softmax(v_r, tqa, mask)
    assert K.launches["fused_rank_softmax_bf16"] == 1
    torch.testing.assert_close(got, K.fused_rank_softmax_ref(v_r, tqa, mask),
                               rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("V,n_real,b,q,a,g,shift", [
    pytest.param(50, 44, B, Q, A, G, 0, id="50-44"),
    pytest.param(2048, 1999, B, Q, A, G, 0, id="2048-1999")] + [
    pytest.param(*p.values, 0, id=p.id) for p in K3_EDGES] + [
    pytest.param(10, 8, B, Q, A, G, 1, id="10-8-2-bytes-off"),
    pytest.param(300, 263, B, Q, A, G, 4, id="300-263-8-bytes-off"),
    pytest.param(7, 5, 3, 5, 3, 1, 3, id="B3-7-5-Q5A3G1-6-bytes-off")])
def test_cuda_masked_softmax_bf16_matches_plain(rng, cuda, V, n_real, b, q, a,
                                                g, shift):
    """The bf16 instance of K3 against its plain version (float32 out) and
    its gradient in bf16.  With ``shift`` the logits start that many bf16
    past a 16-byte boundary: out of phase with att where the shift is odd
    or not a multiple of 4 (units of 1 element), in phase at 4 (8-element
    units after a 4-element head)."""
    logits, mask = softmax_inputs(rng, V, n_real, b, q, a, g)
    logits, mask = torch.from_numpy(logits).to(cuda, torch.bfloat16), torch.from_numpy(mask).to(cuda)
    if shift:
        buf = torch.empty(logits.numel() + 8, dtype=logits.dtype, device=cuda)
        logits = buf[shift:shift + logits.numel()].view(logits.shape).copy_(logits)
    logits.requires_grad_()
    K.reset_launches()
    got = K.masked_softmax_vqa(logits, mask)
    assert K.launches["masked_softmax_vqa_bf16"] == 1
    want = K.masked_softmax_vqa_ref(logits.detach(), mask)
    torch.testing.assert_close(got.detach(), want, rtol=0, atol=1e-5)
    cot = torch.randn(got.shape, device=cuda)
    (g_,) = torch.autograd.grad(got, (logits,), cot)
    assert g_.dtype == torch.bfloat16
    torch.testing.assert_close(
        g_, K.softmax_vqa_backward_ref(want, cot).to(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("qa_dtype", [torch.bfloat16, torch.float32],
                         ids=["glimpse0-bf16", "glimpse1-mixed"])
@pytest.mark.parametrize("V,b,d", [pytest.param(50, B, D, id="50"),
                                   pytest.param(293, B, D, id="293")]
                         + K2_EDGES)
def test_cuda_tri_pool_bf16_matches_plain(rng, cuda, V, b, d, qa_dtype):
    vt, qt, at, _ = pool_inputs(rng, V, b, d)
    vt = torch.from_numpy(vt).to(cuda, torch.bfloat16)
    qt, at = (torch.from_numpy(x).to(cuda, qa_dtype) for x in (qt, at))
    w = torch.from_numpy(rng.rand(b, V, Q, A, G).astype(np.float32)).to(cuda)
    K.reset_launches()
    got = K.trilinear_pool(vt, qt, at, w[..., 1])
    assert K.launches["trilinear_pool_bf16"] == 1
    want = K.trilinear_pool_ref(vt, qt, at, w[..., 1])
    torch.testing.assert_close(got, want, rtol=2e-4,
                               atol=2e-4 * want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("qa_dtype", [torch.bfloat16, torch.float32],
                         ids=["glimpse0-bf16", "glimpse1-mixed"])
def test_cuda_tri_pool_bf16_multi_pass_matches_plain(rng, cuda, qa_dtype):
    """Q=20, A=5: the bf16 K2's multi-pass instance (6 question tokens a
    pass), against its plain version."""
    b, V, q, a, d = 2, 50, 20, 5, 264
    vt = torch.from_numpy(rng.randn(b, V, d).astype(np.float32)).to(cuda, torch.bfloat16)
    qt, at = (torch.from_numpy(rng.randn(b, n, d).astype(np.float32)).to(cuda, qa_dtype)
              for n in (q, a))
    w = torch.from_numpy(rng.rand(b, V, q, a, G).astype(np.float32)).to(cuda)
    K.reset_launches()
    got = K.trilinear_pool(vt, qt, at, w[..., 0])
    assert K.launches["trilinear_pool_bf16"] == 1
    want = K.trilinear_pool_ref(vt, qt, at, w[..., 0])
    torch.testing.assert_close(got, want, rtol=2e-4,
                               atol=2e-4 * want.abs().max().item())
