"""vqatpu_torch's building blocks against their vqatpu counterparts at
small width: the same JAX-initialised param tree and the same numpy inputs
go through both, within 1e-5 (float32 sums in another order).  Dropout is
compared under injected masks: a recording mask source draws each mask
with numpy as the JAX module asks for it, and the port replays them."""

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
from vqatpu.ops.module import Ctx as JaxCtx
from vqatpu.ops.module import dropout as jax_dropout
from vqatpu_torch.kernels import trilinear as K
from vqatpu_torch.ops import attention, classifier, embedding, linear, rnn
from vqatpu_torch.ops import trilinear
from vqatpu_torch.ops.activation import get_activation
from vqatpu_torch.ops.module import Ctx, MaskSource, dropout
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
    gen = torch.Generator().manual_seed(0)
    assert dropout(x, 0.5, None) is x
    assert dropout(x, 0.5, Ctx(train=False, generator=gen)) is x
    assert dropout(x, 0.0, Ctx(train=True, generator=gen)) is x
    y = dropout(x, 0.25, Ctx(train=True, generator=gen))
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] / 0.75)
    assert 0.6 < kept.float().mean().item() < 0.9
    # the same generator state gives the same mask
    a = dropout(x, 0.25, Ctx(True, torch.Generator().manual_seed(3)))
    b = dropout(x, 0.25, Ctx(True, torch.Generator().manual_seed(3)))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_dropout_in_training_needs_a_generator():
    x = torch.ones(4, 4)
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.5, Ctx(train=True))
    with pytest.raises(ValueError, match="mask_bits"):
        Ctx(train=True, mask_bits=8)


@pytest.mark.parametrize("rate", [0.2, 0.5, 0.7])
def test_dropout_mask_bits_16_scales_by_the_realized_keep(rng, rate):
    """16-bit draws: keep where the draw is below round(keep * 65536), scale
    by 65536 / that threshold (``vqatpu/ops/module.py:114-118``)."""
    x = torch.from_numpy(rng.rand(256, 256).astype(np.float32) + 1.0)
    y = dropout(x, rate, Ctx(True, torch.Generator().manual_seed(1), 16))
    thresh = round((1.0 - rate) * 65536.0)
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] * (65536.0 / thresh),
                               rtol=0, atol=0)
    assert abs(kept.float().mean().item() - thresh / 65536.0) < 0.01


def test_mask_source_is_a_fifo_per_shape(rng):
    masks = [np.full((2, 3), 1.0), np.zeros((2, 3)), np.ones((4,))]
    src = MaskSource(masks)
    x = torch.ones(2, 3)
    ctx = Ctx(train=True, mask_source=src)
    torch.testing.assert_close(dropout(x, 0.5, ctx), x * 2)
    with pytest.raises(AssertionError, match="unconsumed"):
        src.assert_exhausted()
    torch.testing.assert_close(dropout(x, 0.5, ctx), x * 0)
    with pytest.raises(ValueError, match="no injected"):
        dropout(x, 0.5, ctx)
    dropout(torch.ones(4), 0.1, ctx)
    src.assert_exhausted()


class Recorder:
    """A JAX ``MaskSource`` stand-in that draws each mask with numpy as it
    is asked for, and keeps them in order for the port to replay."""

    def __init__(self, seed=0, keep=0.6):
        self.rs = np.random.RandomState(seed)
        self.keep = keep
        self.masks = []

    def next_mask(self, shape):
        m = (self.rs.rand(*shape) < self.keep).astype(np.float32)
        self.masks.append(m)
        return m

    def replay(self):
        return Ctx(train=True, mask_source=MaskSource(self.masks))


def test_injected_mask_dropout_matches_jax(rng):
    x = rng.randn(3, 5).astype(np.float32)
    rec = Recorder()
    want = jax_dropout(jnp.asarray(x), 0.3, JaxCtx(train=True, mask_source=rec))
    ctx = rec.replay()
    got = dropout(torch.from_numpy(x), 0.3, ctx)
    close(got.numpy(), want)
    ctx.mask_source.assert_exhausted()


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


def test_dropout_sites_match_jax_under_injected_masks(rng):
    """FCNet, the word embedding and the classifier in training: each site
    takes the JAX module's mask, in the JAX order."""
    sites = [
        (jlin.FCNet((12, 16, 9), "ReLU", 0.2), linear.FCNet((12, 16, 9), "ReLU", 0.2),
         rng.randn(4, 12).astype(np.float32)),
        (jemb.WordEmbedding(20, 300, 0.4, "c"),
         embedding.WordEmbedding(20, 300, 0.4, "c"), rng.randint(0, 21, (3, 12))),
        (jcls.SimpleClassifier(16, 32, 7, "relu", 0.5),
         classifier.SimpleClassifier(16, 32, 7, "relu", 0.5),
         rng.randn(5, 16).astype(np.float32)),
    ]
    for seed, (jm, tm, x) in enumerate(sites):
        p = init(jm, seed=seed)
        rec = Recorder(seed)
        want = jm.apply(p, jnp.asarray(x), JaxCtx(train=True, mask_source=rec))
        ctx = rec.replay()
        with torch.no_grad():
            got = load(tm, p)(torch.from_numpy(x), ctx)
        close(got.numpy(), want)
        ctx.mask_source.assert_exhausted()


def test_rank_projections_take_one_mask_per_rank_under_injected_masks(rng):
    """Under a mask source the rank nets take the per-rank path
    (``vqatpu/ops/trilinear.py:169-177``): 3 tuckers + 3 x rank masks."""
    jm = jtri.TCNet(**TC)
    p = init(jm, seed=5)
    v, q, a = tc_inputs(rng)
    rec = Recorder(7)
    want = jm.rank_projections(p, *map(jnp.asarray, (v, q, a)),
                               ctx=JaxCtx(train=True, mask_source=rec))
    assert len(rec.masks) == 3 + 3 * TC["rank"]
    ctx = rec.replay()
    with torch.no_grad():
        got = load(trilinear.TCNet(**TC), p).rank_projections(
            *(torch.from_numpy(x) for x in (v, q, a)), ctx)
    for g, w in zip(got, want):
        close(g.detach().numpy(), w)
    ctx.mask_source.assert_exhausted()


def test_rank_nets_share_one_mask_across_ranks_with_a_generator(rng):
    """With a generator the rank nets draw one mask that every rank shares:
    the same output as the per-rank path fed that mask R times."""
    net = trilinear.RankNets(4, 16, 4, "ReLU", 0.5)
    x = torch.from_numpy(rng.randn(2, 6, 16).astype(np.float32))
    with torch.no_grad():
        got = net(x, Ctx(True, torch.Generator().manual_seed(2)))
        mask = (torch.rand(x.shape, generator=torch.Generator().manual_seed(2))
                < 0.5).float()
        want = net(x, Ctx(train=True, mask_source=MaskSource([mask] * 4)))
    close(got.numpy(), want.numpy())


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
    with torch.inference_mode():
        got, logits = m(*(torch.from_numpy(x) for x in (v, q, a, mask)))
        no_mask, _ = m(*(torch.from_numpy(x) for x in (v, q, a)))
    assert logits is None
    got = got.numpy()
    with pltpu.force_tpu_interpret_mode():
        want, _ = jm.apply(p, *map(jnp.asarray, (v, q, a, mask)),
                           return_logits=False)
    assert got.shape == (2, 6, 12, 3, 2)
    np.testing.assert_array_equal(got[1], 0.0)
    close(got, want)
    # without a mask, the box mask is read from the features
    close(no_mask.numpy()[0], got[0])


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_triattention_return_logits_matches_jax_apply(rng, backend):
    """``return_logits=True`` (K3 on the logits) against JAX's ``apply``
    (its default), attention and masked logits (-inf at masked boxes),
    and the same attention as the fused path."""
    kw = dict(v_dim=10, q_dim=8, a_dim=8, h_dim=16, h_out=1, rank=4,
              glimpse=2, k=1)
    jm = jatt.TriAttention(**kw, backend=backend)
    p = init(jm, seed=8)
    v, q, a = tc_inputs(rng)
    mask = np.abs(v).sum(-1) != 0
    mask[1] = False
    m = load(attention.TriAttention(**kw), p)
    args = [torch.from_numpy(x) for x in (v, q, a, mask)]
    with torch.inference_mode():
        att, logits = m(*args, return_logits=True)
        fused, _ = m(*args)
    with pltpu.force_tpu_interpret_mode():
        want_att, want_logits = jm.apply(p, *map(jnp.asarray, (v, q, a, mask)))
    close(att.numpy(), want_att)
    close(fused.numpy(), att.numpy())
    want_logits = np.asarray(want_logits)
    assert np.isneginf(want_logits[:, 4:]).all() and np.isneginf(want_logits[1]).all()
    np.testing.assert_array_equal(np.isneginf(logits.numpy()),
                                  np.isneginf(want_logits))
    finite = np.isfinite(want_logits)
    np.testing.assert_allclose(logits.numpy()[finite], want_logits[finite],
                               atol=1e-4)


def test_cti_dropout_sites_match_jax_under_injected_masks(rng):
    """The whole CTI forward in training under injected masks: every site
    of ``vqatpu/models/ffoe.py:241-325`` fires in the JAX order (the
    per-rank path included), and the logits agree."""
    from vqatpu.config import ModelConfig as JaxModelConfig
    from vqatpu.models import build_model as jax_build_model
    from vqatpu_torch.config import ModelConfig
    from vqatpu_torch.models import build_model
    from vqatpu_torch.weights import load_jax_params, numpy_batch, numpy_params

    kw = dict(ntoken=50, v_dim=32, num_ans_candidates=17, model="cti",
              num_hid=32, h_mm=16, rank=4, gamma=2)
    params = numpy_params(ModelConfig(**kw), seed=3)
    batch = numpy_batch(ModelConfig(**kw), 2, seed=4, boxes=8, real_boxes=6)
    rec = Recorder(11)
    want, _ = jax_build_model(JaxModelConfig(**kw)).apply(
        jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(x) for k, x in batch.items()},
        JaxCtx(train=True, mask_source=rec))
    ctx = rec.replay()
    model = load_jax_params(build_model(ModelConfig(**kw)), params)
    with torch.no_grad():
        got, _ = model(*(torch.from_numpy(batch[k]) for k in "vqa"), ctx=ctx)
    close(got.numpy(), want)
    ctx.mask_source.assert_exhausted()


# -- bf16 compute ------------------------------------------------------------------
#
# With bf16 parameters (compute_dtype="bfloat16") each op keeps JAX's dtype:
# bf16 in and bf16 weights give bf16, and a float32 input against bf16
# weights is promoted to float32, as jnp promotes (torch's F.linear would
# raise).  Values are held to JAX's within a few bf16 roundings: BF16_TOL of
# the largest output (one rounding is 2^-8 relative).

BF16_TOL = 2.0 ** -6


def bf16_tree(p):
    return jax.tree.map(lambda x: jnp.asarray(x).astype(jnp.bfloat16), p)


def close_bf16(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=BF16_TOL * np.abs(want).max())


@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
def test_wnlinear_bf16_promotes_like_jax(rng, x_dtype):
    jm = jlin.WNLinear(12, 9)
    p = init(jm)
    p["g"] = np.float32(2.5) * p["g"]
    x = rng.randn(3, 5, 12).astype(np.float32)
    m = load(linear.WNLinear(12, 9), p).to(torch.bfloat16)
    tx = torch.from_numpy(x).to(getattr(torch, x_dtype))
    jx = jnp.asarray(x).astype(x_dtype)
    with torch.inference_mode():
        got = m(tx)
    want = jm.apply(bf16_tree(p), jx)
    assert str(got.dtype) == f"torch.{want.dtype}" == f"torch.{x_dtype}"
    close_bf16(got, want)


@pytest.mark.parametrize("x_dtype", ["bfloat16", "float32"])
def test_rank_nets_bf16_promote_like_jax(rng, x_dtype):
    jm = jtri.TCNet(**TC)
    p = init(jm, seed=5)
    x = rng.randn(2, 6, 16).astype(np.float32)
    m = load(trilinear.TCNet(**TC), p).to(torch.bfloat16)
    with torch.inference_mode():
        got = m.v_net(torch.from_numpy(x).to(getattr(torch, x_dtype)))
    want = jm._rank_project(bf16_tree(p)["v_net"],
                            jnp.asarray(x).astype(x_dtype), 0.5, None)
    assert str(got.dtype) == f"torch.{want.dtype}" == f"torch.{x_dtype}"
    close_bf16(got, want)


def test_gru_bf16_matches_jax(rng):
    """The GRU in bf16: bf16 states, within a few bf16 roundings of JAX's
    scan (which also rounds every gate to bf16)."""
    jm = jrnn.QuestionEmbedding(20, 16)
    p = init(jm, seed=3)
    x = rng.randn(3, 12, 20).astype(np.float32)
    m = load(rnn.QuestionEmbedding(20, 16), p).to(torch.bfloat16)
    with torch.inference_mode():
        got = m(torch.from_numpy(x).to(torch.bfloat16))
    want = jm.apply_all(bf16_tree(p), jnp.asarray(x).astype(jnp.bfloat16))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    close_bf16(got, want)


@pytest.mark.parametrize("qa_dtype", ["bfloat16", "float32"],
                         ids=["glimpse0", "glimpse1"])
def test_tcnet_apply_with_weights_bf16_matches_jax_pallas(rng, qa_dtype):
    """The joint embedding at bf16: ``v`` bf16, ``q``/``a`` bf16 at the
    first glimpse and float32 at the second; the pool is float32 on both
    sides (Pallas backend, interpret mode)."""
    kw = dict(TC, glimpse=1, k=2)
    jm = jtri.TCNet(**kw, joint_only=True, backend="pallas")
    p = init(jm, seed=6)
    v, q, a = tc_inputs(rng)
    att = rng.rand(2, 6, 12, 3, 2).astype(np.float32)
    m = load(trilinear.TCNet(**kw, joint_only=True), p).to(torch.bfloat16)
    qa = getattr(torch, qa_dtype)
    with torch.inference_mode():
        got = m.apply_with_weights(torch.from_numpy(v).to(torch.bfloat16),
                                   torch.from_numpy(q).to(qa),
                                   torch.from_numpy(a).to(qa),
                                   torch.from_numpy(att)[..., 1])
    with pltpu.force_tpu_interpret_mode():
        want = jm.apply_with_weights(
            bf16_tree(p), jnp.asarray(v).astype(jnp.bfloat16),
            jnp.asarray(q).astype(qa_dtype), jnp.asarray(a).astype(qa_dtype),
            jnp.asarray(att[..., 1]))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    close_bf16(got, want)


def test_triattention_return_logits_at_bf16_matches_jax_apply(rng):
    """At ``compute_dtype="bfloat16"`` (bf16 weights and inputs, as the
    step casts them) ``return_logits=True`` hands K3 bf16 logits, as JAX's
    ``apply`` with the Pallas backend does: bf16 masked logits, float32
    attention, within bf16 roundings of JAX's; the attention is K3's
    plain version of the port's own logits, exactly."""
    kw = dict(v_dim=10, q_dim=8, a_dim=8, h_dim=16, h_out=1, rank=4,
              glimpse=2, k=1)
    jm = jatt.TriAttention(**kw, backend="pallas")
    p = init(jm, seed=9)
    v, q, a = tc_inputs(rng)
    mask = np.abs(v).sum(-1) != 0
    mask[1] = False
    m = load(attention.TriAttention(**kw), p).to(torch.bfloat16)
    args = [torch.from_numpy(x).to(torch.bfloat16) for x in (v, q, a)]
    with torch.inference_mode():
        att, logits = m(*args, torch.from_numpy(mask), return_logits=True)
    assert att.dtype == torch.float32 and logits.dtype == torch.bfloat16
    p16 = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), p)
    with pltpu.force_tpu_interpret_mode():
        want_att, want_logits = jm.apply(
            p16, *(jnp.asarray(x, jnp.bfloat16) for x in (v, q, a)),
            jnp.asarray(mask))
    assert want_att.dtype == jnp.float32 and want_logits.dtype == jnp.bfloat16
    finite = np.isfinite(np.asarray(want_logits, np.float32))
    np.testing.assert_array_equal(np.isfinite(logits.float().numpy()), finite)
    close_bf16(logits.float()[torch.from_numpy(finite)],
               np.asarray(want_logits, np.float32)[finite])
    close_bf16(att, want_att)
    # the -inf of masked boxes are replaced before the softmax
    torch.testing.assert_close(
        att, K.masked_softmax_vqa_ref(logits, torch.from_numpy(mask)),
        rtol=0, atol=0)
