"""vqatpu_torch's BCNet (``ops/bilinear.py``) in its three regimes and
BiAttention (``ops/attention.py``) against vqatpu's at small width: the
same JAX-initialised param tree and the same numpy inputs go through both,
within 1e-5 (float32 sums in another order).  Dropout is compared under
injected masks that each side must ask for in the same order, site by
site; gradients through autograd against ``jax.grad``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vqatpu.ops import attention as jatt
from vqatpu.ops import bilinear as jbil
from vqatpu.ops.module import Ctx as JaxCtx
from vqatpu_torch.ops.attention import BiAttention
from vqatpu_torch.ops.bilinear import BCNet
from vqatpu_torch.ops.module import Ctx
from vqatpu_torch.weights import torch_state_from_jax

TOL = 1e-5
B, V, Q, V_DIM, Q_DIM, H = 3, 7, 5, 12, 10, 8


def init(jax_module, seed=0):
    return jax.tree.map(np.array, jax_module.init(jax.random.PRNGKey(seed)))


def load(module, params):
    module.load_state_dict(torch_state_from_jax(params), strict=True)
    return module.eval()


def inputs(rng, real=(7, 4, 0)):
    """``v`` with the boxes past each sample's real count zero (the last
    sample fully padded), ``q``, and the mask of real boxes."""
    v = rng.randn(B, V, V_DIM).astype(np.float32)
    mask = np.arange(V)[None, :] < np.asarray(real)[:, None]
    v[~mask] = 0.0
    q = rng.randn(B, Q, Q_DIM).astype(np.float32)
    return v, q, mask


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


class OrderedMasks:
    """A mask source for both sides: the JAX run records each mask it asks
    for, in order; the port's run must then ask for the same shapes in the
    same order, and gets the same masks."""

    def __init__(self, seed=0, keep=0.7):
        self.rs = np.random.RandomState(seed)
        self.keep = keep
        self.masks = []
        self.replaying = False
        self.at = 0

    def next_mask(self, shape):
        if not self.replaying:
            m = (self.rs.rand(*shape) < self.keep).astype(np.float32)
            self.masks.append(m)
            return m
        m = self.masks[self.at]
        assert m.shape == tuple(shape), (self.at, m.shape, tuple(shape))
        self.at += 1
        return m

    def replay(self):
        self.replaying = True
        return Ctx(train=True, mask_source=self)

    def assert_exhausted(self):
        assert self.at == len(self.masks) > 0, (self.at, len(self.masks))


@pytest.mark.parametrize("h_out,k", [(None, 1), (None, 3), (2, 3), (1, 1),
                                     (40, 1)],
                         ids=["joint", "joint-k3", "att-2", "att-1", "h_net"])
def test_bcnet_forward_matches_jax(rng, h_out, k):
    """``apply``: [B, 1, d] joint logits, [B, G, V, Q] attention logits
    from ``h_mat``/``h_bias``, and ``h_net`` over the [B, V, Q, d] map."""
    jm = jbil.BCNet(V_DIM, Q_DIM, H, h_out, k=k)
    params = init(jm, seed=1)
    v, q, _ = inputs(rng)
    want = jm.apply(jax.tree.map(jnp.asarray, params), v, q)
    with torch.inference_mode():
        got = load(BCNet(V_DIM, Q_DIM, H, h_out, k=k), params)(t(v), t(q))
    expect = (B, 1, H * k) if h_out is None else (B, h_out, V, Q)
    assert got.shape == expect
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


def test_bcnet_apply_qv_is_the_transpose(rng):
    jm = jbil.BCNet(V_DIM, Q_DIM, H, 3, k=3)
    params = init(jm, seed=2)
    v, q, _ = inputs(rng)
    want = jm.apply_qv(jax.tree.map(jnp.asarray, params), v, q)
    bc = load(BCNet(V_DIM, Q_DIM, H, 3, k=3), params)
    with torch.inference_mode():
        got = bc.apply_qv(t(v), t(q))
        np.testing.assert_allclose(got.numpy(), want, atol=TOL)
        np.testing.assert_allclose(got.numpy(),
                                   bc(t(v), t(q)).transpose(2, 3).numpy(),
                                   atol=TOL)
        with pytest.raises(ValueError, match="h_out"):
            load(BCNet(V_DIM, Q_DIM, H, None), init(
                jbil.BCNet(V_DIM, Q_DIM, H, None))).apply_qv(t(v), t(q))


@pytest.mark.parametrize("k", [1, 3])
def test_bcnet_pooling_matches_jax(rng, k):
    """``apply_with_weights`` ([B, V, Q] weights) and ``..._qv`` ([B, Q, V])
    with k-fold sum pooling -> [B, h_dim]."""
    jm = jbil.BCNet(V_DIM, Q_DIM, H, None, k=k)
    params = init(jm, seed=3)
    v, q, _ = inputs(rng)
    w = rng.rand(B, V, Q).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, params)
    bc = load(BCNet(V_DIM, Q_DIM, H, None, k=k), params)
    with torch.inference_mode():
        got = bc.apply_with_weights(t(v), t(q), t(w))
        got_qv = bc.apply_with_weights_qv(t(v), t(q), t(w.transpose(0, 2, 1)))
    assert got.shape == got_qv.shape == (B, H)
    np.testing.assert_allclose(got.numpy(), jm.apply_with_weights(jp, v, q, w),
                               atol=TOL)
    np.testing.assert_allclose(
        got_qv.numpy(),
        jm.apply_with_weights_qv(jp, v, q, w.transpose(0, 2, 1)), atol=TOL)


@pytest.mark.parametrize("method", ["forward", "apply_qv", "h_net",
                                    "apply_with_weights_qv"])
def test_bcnet_dropout_sites_fire_in_jax_order(rng, method):
    """``v_net`` and ``q_net`` at ``dropout[0]``, then ``dropout[1]`` on
    ``v_`` in the attention regimes (``vqatpu/ops/bilinear.py:80-92``),
    mask for mask."""
    h_out = {"h_net": 40, "apply_with_weights_qv": None}.get(method, 2)
    jm = jbil.BCNet(V_DIM, Q_DIM, H, h_out, k=3)
    params = init(jm, seed=4)
    v, q, _ = inputs(rng)
    w = rng.rand(B, Q, V).astype(np.float32)
    src = OrderedMasks(seed=5)
    jctx = JaxCtx(train=True, mask_source=src)
    jp = jax.tree.map(jnp.asarray, params)
    bc = load(BCNet(V_DIM, Q_DIM, H, h_out, k=3), params)
    with torch.inference_mode():
        if method == "apply_with_weights_qv":
            want = jm.apply_with_weights_qv(jp, v, q, w, jctx)
            got = bc.apply_with_weights_qv(t(v), t(q), t(w), src.replay())
        elif method == "apply_qv":
            want = jm.apply_qv(jp, v, q, jctx)
            got = bc.apply_qv(t(v), t(q), src.replay())
        else:
            want = jm.apply(jp, v, q, jctx)
            got = bc(t(v), t(q), src.replay())
    src.assert_exhausted()
    assert len(src.masks) == (2 if h_out is None else 3)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


def biattention(glimpse=2, seed=6):
    jm = jatt.BiAttention(V_DIM, Q_DIM, H, glimpse)
    params = init(jm, seed=seed)
    # move h_mat_g off ||h_mat||, so that the weight norm shows
    params["h_mat_g"] = np.asarray(params["h_mat_g"] * 1.7, np.float32)
    return jm, params, load(BiAttention(V_DIM, Q_DIM, H, glimpse), params)


@pytest.mark.parametrize("glimpse", [2, 8])
def test_biattention_matches_jax(rng, glimpse):
    """Attention and masked logits in the [B, G, Q, V] layout, the softmax
    over the flattened (Q, V) grid per glimpse; the padded boxes at 0 and
    -inf, the fully padded sample's attention all zero (no NaN)."""
    jm, params, port = biattention(glimpse)
    v, q, mask = inputs(rng)
    jp = jax.tree.map(jnp.asarray, params)
    with torch.inference_mode():
        want = jm.apply_gqv(jp, v, q, jnp.asarray(mask))
        got = port.apply_gqv(t(v), t(q), t(mask))
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_array_equal(np.isneginf(g), np.isneginf(w))
        np.testing.assert_allclose(np.where(np.isinf(g), 0, g),
                                   np.where(np.isinf(w), 0, w), atol=TOL)
    att, logits = (x.numpy() for x in got)
    assert att.shape == (B, glimpse, Q, V) and np.isfinite(att).all()
    np.testing.assert_array_equal(att[2], 0.0)
    np.testing.assert_allclose(att[:2].sum((2, 3)), 1.0, atol=1e-6)
    padded = np.moveaxis(np.isneginf(logits), 3, 1)
    np.testing.assert_array_equal(padded.all((2, 3)), ~mask)


def test_biattention_mask_defaults_to_nonzero_boxes(rng):
    _, _, port = biattention()
    v, q, mask = inputs(rng)
    with torch.inference_mode():
        a1, _ = port.apply_gqv(t(v), t(q))
        a2, _ = port.apply_gqv(t(v), t(q), t(mask))
    torch.testing.assert_close(a1, a2, rtol=0, atol=0)


def test_biattention_weight_norm_and_gradients_match_jax(rng):
    """``h_mat = h_mat_g / ||h_mat||_F * h_mat``: the gradients of a
    weighted sum of the attention with respect to every parameter and to
    ``v`` and ``q``, the fully padded sample included, within 1e-5."""
    jm, params, port = biattention(glimpse=3, seed=7)
    v, q, mask = inputs(rng)
    cot = rng.randn(B, 3, Q, V).astype(np.float32)

    def jloss(p, v_, q_):
        att, _ = jm.apply_gqv(p, v_, q_, jnp.asarray(mask))
        return (att * cot).sum()

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(v), jnp.asarray(q))
    tv, tq = t(v).requires_grad_(), t(q).requires_grad_()
    att, _ = port.apply_gqv(tv, tq, t(mask))
    (att * t(cot)).sum().backward()
    flat = {jax.tree_util.keystr(k, simple=True, separator="."): np.asarray(x)
            for k, x in jax.tree_util.tree_flatten_with_path(jgrads[0])[0]}
    named = dict(port.named_parameters())
    assert sorted(flat) == sorted(named)
    for name, g in flat.items():
        assert np.isfinite(named[name].grad.numpy()).all(), name
        np.testing.assert_allclose(named[name].grad.numpy(), g, atol=TOL,
                                   err_msg=name)
    np.testing.assert_allclose(tv.grad.numpy(), jgrads[1], atol=TOL)
    np.testing.assert_allclose(tq.grad.numpy(), jgrads[2], atol=TOL)
