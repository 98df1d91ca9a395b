"""vqatpu_torch's building blocks against their vqatpu counterparts at
small width: the same JAX-initialised param tree and the same numpy inputs
go through both, within 1e-5 (float32 sums in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from vqatpu.ops import attention as jatt
from vqatpu.ops import classifier as jcls
from vqatpu.ops import embedding as jemb
from vqatpu.ops import linear as jlin
from vqatpu.ops import rnn as jrnn
from vqatpu.ops import trilinear as jtri
from vqatpu.ops.activation import get_activation as jax_activation
from vqatpu_torch.ops import attention, classifier, embedding, linear, rnn
from vqatpu_torch.ops import trilinear
from vqatpu_torch.ops.activation import get_activation
from vqatpu_torch.ops.module import dropout
from vqatpu_torch.weights import torch_state_from_jax

TOL = 1e-5


def init(jax_module, seed=0):
    """A JAX module's params as a numpy tree."""
    return jax.tree.map(np.array, jax_module.init(jax.random.PRNGKey(seed)))


def load(module, params):
    module.load_state_dict(torch_state_from_jax(params), strict=True)
    return module.eval()


def run(module, *arrays):
    with torch.inference_mode():
        return module(*(torch.from_numpy(np.ascontiguousarray(a))
                        for a in arrays)).numpy()


def close(got, want, atol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol)


@pytest.mark.parametrize("name", ["", "none", "ReLU", "relu", "Tanh", "tanh",
                                  "Sigmoid", "sigmoid", "LeakyReLU", "GELU",
                                  "Swish", "swish"])
def test_activation_matches_jax(rng, name):
    x = (3 * rng.randn(4, 7)).astype(np.float32)
    got = get_activation(name)(torch.from_numpy(x)).numpy()
    close(got, jax_activation(name)(jnp.asarray(x)))


def test_unknown_activation_raises():
    with pytest.raises(ValueError, match="not supported"):
        get_activation("Mish")


def test_dropout_is_identity_at_eval_and_inverted_in_training(rng):
    x = torch.from_numpy(rng.randn(64, 32).astype(np.float32))
    assert dropout(x, 0.5, train=False) is x
    assert dropout(x, 0.0, train=True) is x
    y = dropout(x, 0.25, train=True, generator=torch.Generator().manual_seed(0))
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] / 0.75)
    assert 0.6 < kept.float().mean().item() < 0.9


@pytest.mark.parametrize("bias", [True, False])
def test_wnlinear_matches_jax(rng, bias):
    jm = jlin.WNLinear(12, 9, bias)
    p = init(jm)
    p["g"] = np.float32(2.5) * p["g"]  # g != ||v||: the scale matters
    x = rng.randn(3, 5, 12).astype(np.float32)
    got = run(load(linear.WNLinear(12, 9, bias), p), x)
    close(got, jm.apply(p, jnp.asarray(x)))


@pytest.mark.parametrize("dims,act", [((12, 9), "ReLU"), ((12, 16, 9), ""),
                                      ((12, 9), "GELU")])
def test_fcnet_matches_jax(rng, dims, act):
    jm = jlin.FCNet(dims, act, 0.2)
    p = init(jm, seed=1)
    x = rng.randn(4, 12).astype(np.float32)
    got = run(load(linear.FCNet(dims, act, 0.2), p), x)
    close(got, jm.apply(p, jnp.asarray(x)))


@pytest.mark.parametrize("op", ["", "c"])
def test_word_embedding_matches_jax(rng, op):
    ntoken = 20
    jm = jemb.WordEmbedding(ntoken, 300, 0.0, op)
    p = init(jm, seed=2)
    for table in p.values():
        table[-1] = 7.0  # a stored pad row is still read as zeros
    x = rng.randint(0, ntoken + 1, (3, 12))
    x[:, -2:] = ntoken
    got = run(load(embedding.WordEmbedding(ntoken, 300, 0.0, op), p), x)
    assert got.shape == (3, 12, 600 if op else 300)
    np.testing.assert_array_equal(got[:, -2:], 0.0)
    close(got, jm.apply(p, jnp.asarray(x)))


@pytest.mark.parametrize("nlayers", [1, 2])
def test_gru_matches_jax(rng, nlayers):
    jm = jrnn.QuestionEmbedding(20, 16, nlayers=nlayers)
    p = init(jm, seed=3)
    x = rng.randn(3, 12, 20).astype(np.float32)
    got = run(load(rnn.QuestionEmbedding(20, 16, nlayers), p), x)
    assert got.shape == (3, 12, 16)
    close(got, jm.apply_all(p, jnp.asarray(x)))


@pytest.mark.parametrize("act", ["relu", "swish"])
def test_classifier_matches_jax(rng, act):
    jm = jcls.SimpleClassifier(16, 32, 7, act, 0.5)
    p = init(jm, seed=4)
    x = rng.randn(5, 16).astype(np.float32)
    got = run(load(classifier.SimpleClassifier(16, 32, 7, act, 0.5), p), x)
    close(got, jm.apply(p, jnp.asarray(x)))


TC = dict(v_dim=10, q_dim=8, a_dim=8, h_dim=16, h_out=1, rank=4, glimpse=2)


def tc_inputs(rng, V=6, real=4):
    v = rng.randn(2, V, 10).astype(np.float32)
    v[:, real:] = 0.0
    return (v, rng.randn(2, 12, 8).astype(np.float32),
            rng.randn(2, 3, 8).astype(np.float32))


def test_tcnet_rank_projections_match_jax(rng):
    jm = jtri.TCNet(**TC)
    p = init(jm, seed=5)
    v, q, a = tc_inputs(rng)
    m = load(trilinear.TCNet(**TC), p)
    with torch.inference_mode():
        got = m.rank_projections(*(torch.from_numpy(x) for x in (v, q, a)))
    want = jm.rank_projections(p, *map(jnp.asarray, (v, q, a)))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        close(g.detach().numpy(), w)


def test_tcnet_without_rank_nets_refuses_projections():
    m = trilinear.TCNet(**dict(TC, k=2), joint_only=True)
    assert not m.has_rank_nets and not hasattr(m, "T_g")
    with pytest.raises(ValueError, match="rank-net regime"):
        m.rank_projections(None, None, None)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_tcnet_apply_with_weights_matches_jax(rng, backend):
    """The CTI joint embedding (k=2, joint_only) pooled with one glimpse of
    a [B, V, Q, A, G] attention, passed strided as the model passes it."""
    kw = dict(TC, glimpse=1, k=2)
    jm = jtri.TCNet(**kw, joint_only=True, backend=backend)
    p = init(jm, seed=6)
    v, q, a = tc_inputs(rng)
    att = rng.rand(2, 6, 12, 3, 2).astype(np.float32)
    m = load(trilinear.TCNet(**kw, joint_only=True), p)
    with torch.inference_mode():
        got = m.apply_with_weights(*(torch.from_numpy(x) for x in (v, q, a)),
                                   torch.from_numpy(att)[..., 1])
    with pltpu.force_tpu_interpret_mode():
        want = jm.apply_with_weights(p, *map(jnp.asarray, (v, q, a)),
                                     jnp.asarray(att[..., 1]))
    assert got.shape == (2, 32)
    close(got.numpy(), want, atol=TOL * max(1.0, float(np.abs(want).max())))


def test_box_mask_from_features(rng):
    v = rng.randn(3, 5, 4).astype(np.float32)
    v[0, 3:] = 0.0
    v[2] = 0.0
    got = attention.box_mask_from_features(torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jatt.box_mask_from_features(jnp.asarray(v))))
    assert got.sum() == 8


def test_masked_softmax_matches_jax_and_zeroes_masked_slices(rng):
    x = rng.randn(3, 4, 5).astype(np.float32)
    mask = rng.rand(3, 4, 5) > 0.4
    mask[1] = False
    got = attention.masked_softmax(torch.from_numpy(x), torch.from_numpy(mask),
                                   (1, 2)).numpy()
    want = jatt.masked_softmax(jnp.asarray(x), jnp.asarray(mask), axes=(1, 2))
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[1], 0.0)
    close(got, want)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_triattention_matches_jax(rng, backend):
    """The port's one path (fused rank contraction + masked softmax) against
    both JAX backends; the second sample is fully masked."""
    kw = dict(v_dim=10, q_dim=8, a_dim=8, h_dim=16, h_out=1, rank=4,
              glimpse=2, k=1)
    jm = jatt.TriAttention(**kw, backend=backend)
    p = init(jm, seed=7)
    v, q, a = tc_inputs(rng)
    mask = np.abs(v).sum(-1) != 0
    mask[1] = False
    m = load(attention.TriAttention(**kw), p)
    got = run(m, v, q, a, mask)
    with pltpu.force_tpu_interpret_mode():
        want, _ = jm.apply(p, *map(jnp.asarray, (v, q, a, mask)),
                           return_logits=False)
    assert got.shape == (2, 6, 12, 3, 2)
    np.testing.assert_array_equal(got[1], 0.0)
    close(got, want)
    # without a mask, the box mask is read from the features
    close(run(m, v, q, a)[0], got[0])
