"""vqatpu_torch kernels' plain versions against vqatpu's Pallas kernels
(interpret mode, as tests/test_kernels.py runs them) and XLA math, the
wrappers' CPU behaviour, and the CUDA kernels against their plain versions
on the card (marked ``cuda``; skipped without one)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from vqatpu.kernels.blockwise import precontract_qa as jax_precontract_qa
from vqatpu.kernels.trilinear import (attention_logits_xla,
                                      fused_rank_softmax as jax_rank_softmax,
                                      masked_softmax_vqa_xla,
                                      trilinear_pool_pallas, trilinear_pool_xla)
from vqatpu_torch.kernels import trilinear as K

# tests/test_kernels.py fixture shapes
B, Q, A, R, X, G, D = 2, 12, 3, 4, 8, 2, 32


def attention_inputs(rng, V, n_real):
    v_r = rng.randn(B, V, R, X).astype(np.float32)
    q_r = rng.randn(B, Q, R, X).astype(np.float32)
    a_r = rng.randn(B, A, R, X).astype(np.float32)
    T = (0.1 * rng.randn(R, X, X, X, G)).astype(np.float32)
    mask = np.repeat(np.arange(V)[None] < n_real, B, 0)
    return v_r, q_r, a_r, T, mask


def pool_inputs(rng, V):
    return (rng.randn(B, V, D).astype(np.float32),
            rng.randn(B, Q, D).astype(np.float32),
            rng.randn(B, A, D).astype(np.float32),
            rng.rand(B, V, Q, A).astype(np.float32))


def t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_precontract_qa_matches_jax(rng):
    _, q_r, a_r, T, _ = attention_inputs(rng, 10, 8)
    want = np.asarray(jax_precontract_qa(*map(jnp.asarray, (q_r, a_r, T))))
    got = K.precontract_qa(*t(q_r, a_r, T))
    assert got.is_contiguous() and got.shape == (B, Q, A, R, X, G)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("V,n_real", [(10, 8), (300, 263)])
def test_fused_rank_softmax_ref_matches_pallas_and_xla(rng, V, n_real):
    """V=300 > 256 is ragged against any power-of-two V tile."""
    v_r, q_r, a_r, T, mask = attention_inputs(rng, V, n_real)
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
    np.testing.assert_allclose(got.sum((1, 2, 3)), np.ones((B, G)), atol=1e-4)


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


@pytest.mark.parametrize("V", [10, 293])
def test_trilinear_pool_ref_matches_pallas_and_xla(rng, V):
    """V=293 streams two of the Pallas kernel's 256-box blocks."""
    arrays = pool_inputs(rng, V)
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
    assert K.launches == {"fused_rank_softmax": 0, "trilinear_pool": 0}


def test_wrappers_refuse_grad(rng):
    arrays = t(*pool_inputs(rng, 10))
    arrays[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        K.trilinear_pool(*arrays)
    with torch.no_grad():
        K.trilinear_pool(*arrays)
    v_r, q_r, a_r, T, mask = attention_inputs(rng, 10, 8)
    tqa = K.precontract_qa(*t(q_r, a_r, T)).requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        K.fused_rank_softmax(torch.from_numpy(v_r), tqa, torch.from_numpy(mask))


@pytest.mark.parametrize("bad", ["dtype", "shape", "mask_dtype", "device"])
def test_wrappers_check_their_inputs(rng, bad):
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


# -- on the card ------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("V,n_real", [(10, 8), (50, 44), (2048, 1999)])
def test_cuda_rank_softmax_matches_plain(rng, cuda, V, n_real):
    v_r, q_r, a_r, T, mask = attention_inputs(rng, V, n_real)
    mask[-1] = False
    v_r, mask = (x.to(cuda) for x in t(v_r, mask))
    tqa = K.precontract_qa(*(x.to(cuda) for x in t(q_r, a_r, T)))
    K.reset_launches()
    got = K.fused_rank_softmax(v_r, tqa, mask)
    assert K.launches["fused_rank_softmax"] == 1
    torch.testing.assert_close(got, K.fused_rank_softmax_ref(v_r, tqa, mask),
                               rtol=0, atol=1e-5)
    assert (got[-1] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("V", [10, 50, 293])
def test_cuda_tri_pool_matches_plain(rng, cuda, V):
    vt, qt, at, _ = (x.to(cuda) for x in t(*pool_inputs(rng, V)))
    w = torch.from_numpy(rng.rand(B, V, Q, A, G).astype(np.float32)).to(cuda)
    K.reset_launches()
    got = K.trilinear_pool(vt, qt, at, w[..., 1])
    assert K.launches["trilinear_pool"] == 1
    want = K.trilinear_pool_ref(vt, qt, at, w[..., 1])
    torch.testing.assert_close(got, want, rtol=2e-4,
                               atol=2e-4 * want.abs().max().item())
