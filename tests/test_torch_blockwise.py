"""CTI's large-V path and the v-side knobs against vqatpu on the CPU: the
blockwise softmax statistics and pool (``vqatpu/kernels/blockwise.py``) and
their gradients, in the style of ``tests/test_blockwise.py``; CTI's
blockwise branch, forward and gradients; ``fused_tucker_projection`` under
one injected mask; and three training steps with ``fused_v_tucker`` and
with ``remat_glimpse``, dropout on, under injected masks, against JAX's
trajectory at 1e-4 (ROADMAP's parity contract)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vqatpu.config import ModelConfig as JaxModelConfig
from vqatpu.kernels import blockwise as jblk
from vqatpu.models import build_model as jax_build_model
from vqatpu.ops import linear as jlin
from vqatpu.ops import trilinear as jtri
from vqatpu.ops.module import Ctx as JaxCtx
from vqatpu_torch.config import ModelConfig, TrainConfig
from vqatpu_torch.kernels import blockwise as blk
from vqatpu_torch.kernels import trilinear as K
from vqatpu_torch.models import build_model
from vqatpu_torch.ops.linear import FCNet
from vqatpu_torch.ops.module import Ctx, MaskSource
from vqatpu_torch.ops.trilinear import fused_tucker_projection
from vqatpu_torch.train import make_train_state, make_train_step
from vqatpu_torch.weights import (_flatten, jax_params_from_torch,
                                  load_jax_params, numpy_batch, numpy_params,
                                  param_stats, torch_state_from_jax)

from tests import torch_knobs_goldens as goldens

B, V, Q, A, R, X, G, D = 2, 21, 12, 3, 4, 8, 2, 16  # V not a block multiple
BLOCK = 8
FWD_TOL = 1e-5
SMALL = dict(ntoken=50, v_dim=32, num_ans_candidates=17, model="cti",
             num_hid=32, h_mm=16, rank=4, gamma=2)  # tests/test_models.py
TRAIN_TOL = 1e-4  # ROADMAP's parity contract for trajectories


def inputs(rng, last_masked=False):
    v_r = rng.randn(B, V, R, X).astype(np.float32)
    q_r = rng.randn(B, Q, R, X).astype(np.float32)
    a_r = rng.randn(B, A, R, X).astype(np.float32)
    T = (0.1 * rng.randn(R, X, X, X, G)).astype(np.float32)
    mask = np.repeat(np.arange(V)[None] < 17, B, 0)
    if last_masked:
        mask[-1] = False
    vt, qt, at = (rng.randn(B, n, D).astype(np.float32) for n in (V, Q, A))
    return v_r, q_r, a_r, T, mask, vt, qt, at


def port_pool(v_r, q_r, a_r, T, mask, vt, qt, at, g):
    tqa = blk.precontract_qa(q_r, a_r, T)
    m, den = blk.softmax_stats(v_r, tqa, mask, BLOCK)
    return blk.attention_pool_blockwise(v_r, tqa, mask, m, den, g, vt, qt,
                                        at, BLOCK)


@functools.partial(jax.jit, static_argnums=8)
def jax_pool(v_r, q_r, a_r, T, mask, vt, qt, at, g):
    tqa = jblk.precontract_qa(q_r, a_r, T)
    m, den = jblk.softmax_stats(v_r, tqa, mask, BLOCK)
    return jblk.attention_pool_blockwise(v_r, tqa, mask, m, den, g, vt, qt,
                                         at, BLOCK)


def test_softmax_stats_and_pool_match_jax(rng):
    arrays = inputs(rng)
    t = [torch.from_numpy(x) for x in arrays]
    j = [jnp.asarray(x) for x in arrays]
    tqa = blk.precontract_qa(*t[1:4])
    m, den = blk.softmax_stats(t[0], tqa, t[4], BLOCK)
    jm, jden = jax.jit(jblk.softmax_stats, static_argnums=3)(
        j[0], jblk.precontract_qa(*j[1:4]), j[4], BLOCK)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=FWD_TOL)
    np.testing.assert_allclose(den.numpy(), np.asarray(jden), rtol=FWD_TOL)
    for g in range(G):
        np.testing.assert_allclose(port_pool(*t, g).numpy(),
                                   np.asarray(jax_pool(*j, g)), atol=FWD_TOL,
                                   rtol=FWD_TOL)


def test_blockwise_equals_the_kernels_plain_versions(rng):
    """The blockwise pool is K1's softmax then K2's pool (their plain
    versions); a fully masked sample, a padding row of a serving bucket,
    gives a zero pool, finite."""
    arrays = inputs(rng, last_masked=True)
    v_r, q_r, a_r, T, mask, vt, qt, at = (torch.from_numpy(x) for x in arrays)
    att = K.fused_rank_softmax_ref(v_r, K.precontract_qa(q_r, a_r, T), mask)
    for g in range(G):
        got = port_pool(v_r, q_r, a_r, T, mask, vt, qt, at, g)
        want = K.trilinear_pool_ref(vt, qt, at, att[..., g])
        assert torch.isfinite(got).all()
        np.testing.assert_array_equal(got[-1].numpy(), 0.0)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=FWD_TOL,
                                   rtol=FWD_TOL)


def test_blockwise_gradients_match_jax(rng):
    """d(sum(pool**2)) by v_r, T and vt, against JAX's blockwise gradients
    (``tests/test_blockwise.py`` holds JAX's to its standard path at
    rtol 2e-3, atol 2e-4; these are held tighter)."""
    v_r, q_r, a_r, T, mask, vt, qt, at = inputs(rng)

    def jloss(args):
        return (jax_pool(args[0], q_r, a_r, args[1], mask, args[2], qt, at,
                         0) ** 2).sum()

    want = jax.jit(jax.grad(jloss))((v_r, T, vt))
    xs = [torch.from_numpy(x).requires_grad_() for x in (v_r, T, vt)]
    loss = (port_pool(xs[0], torch.from_numpy(q_r), torch.from_numpy(a_r),
                      xs[1], torch.from_numpy(mask), xs[2],
                      torch.from_numpy(qt), torch.from_numpy(at), 0) ** 2).sum()
    loss.backward()
    for x, w in zip(xs, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def jax_cti(kw):
    return jax_build_model(JaxModelConfig(**kw))


def port_cti(kw, params):
    return load_jax_params(build_model(ModelConfig(**kw)), params)


def test_cti_blockwise_branch_matches_jax():
    """CTI with ``v_block_size`` 4 at 8 boxes (JAX's own test's shapes):
    logits within 1e-5 and ``att`` None on both sides; the gradients of
    sum(logits**2) within JAX's tolerances (rtol 5e-3, atol 5e-4) or
    tighter."""
    kw = dict(SMALL, v_block_size=4)
    params = numpy_params(ModelConfig(**kw), seed=2)
    batch = numpy_batch(ModelConfig(**kw), 2, seed=5, boxes=8, real_boxes=6)
    jm = jax_cti(kw)
    jb = {k: jnp.asarray(batch[k].astype(np.int32) if batch[k].dtype ==
                         np.int64 else batch[k]) for k in ("v", "q", "a")}
    jp = jax.tree.map(jnp.asarray, params)
    want, jatt = jax.jit(jm.apply)(jp, jb)
    jgrad = jax.jit(jax.grad(lambda p: (jm.apply(p, jb)[0] ** 2).sum()))(jp)
    model = port_cti(kw, params)
    logits, att = model(*(torch.from_numpy(batch[k]) for k in "vqa"))
    assert att is None and jatt is None
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want),
                               atol=FWD_TOL)
    (logits ** 2).sum().backward()
    grads = jax_params_from_torch({n: p.grad for n, p in
                                   model.named_parameters()})
    flat = jax.tree_util.tree_flatten_with_path(jgrad)[0]
    assert jax.tree.structure(grads) == jax.tree.structure(jgrad)
    for (path, w), g in zip(flat, jax.tree.leaves(grads)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-3, atol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))


def test_fused_tucker_projection_matches_jax(rng):
    """Three tucker FCNets over one input, one injected mask on it."""
    x = rng.randn(2, 5, 12).astype(np.float32)
    jnets = [jlin.FCNet((12, d), "ReLU", 0.5) for d in (8, 6, 6)]
    ps = [jax.tree.map(np.array, n.init(jax.random.PRNGKey(i)))
          for i, n in enumerate(jnets)]
    mask = (rng.rand(*x.shape) < 0.5).astype(np.float32)
    want = jtri.fused_tucker_projection(
        ps, jnp.asarray(x), 0.5, "ReLU",
        JaxCtx(train=True, mask_source=jlin_source([mask])))
    nets = []
    for p, d in zip(ps, (8, 6, 6)):
        net = FCNet((12, d), "ReLU", 0.5)
        net.load_state_dict(torch_state_from_jax(p))
        nets.append(net)
    source = MaskSource([mask])
    got = fused_tucker_projection(nets, torch.from_numpy(x), 0.5, "ReLU",
                                  Ctx(train=True, mask_source=source))
    source.assert_exhausted()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=FWD_TOL)


def jlin_source(masks):
    from vqatpu.ops.module import MaskSource as JaxMaskSource

    return JaxMaskSource(masks)


def golden():
    """JAX's trajectories, written by ``tests/torch_knobs_goldens.py``
    where missing."""
    if not goldens.GOLDEN.exists():
        goldens.main()
    return np.load(goldens.GOLDEN)


@pytest.mark.parametrize("knob", ["fused", "remat"])
def test_dropout_trajectory_matches_jax_under_injected_masks(knob):
    """Three steps with dropout on, every site fed JAX's masks: the
    per-step loss and pre-clip grad norm, then the params (per-leaf norms
    and sums, and their first values) within 1e-4.  Under fused_v_tucker
    one mask on v feeds the 1+gamma tuckers, drawn first; under
    remat_glimpse each glimpse's masks are drawn once and replayed to its
    recompute, and the second glimpse takes the first's tucker masks, as
    JAX's injected run does (``tests/torch_knobs_goldens.py``)."""
    z = golden()
    kw = dict(goldens.SMALL, **goldens.KNOBS[knob])
    model = port_cti(kw, numpy_params(ModelConfig(**kw), goldens.PARAM_SEED))
    state = make_train_state(model, device="cpu")
    sources = []
    for i, b in enumerate(goldens.batches(kw)):
        masks = [z[f"{knob}_s{i}_m{j}"].astype(np.float32)
                 for j in range(len(z.files))
                 if f"{knob}_s{i}_m{j}" in z.files]
        if knob == "remat":  # glimpse 1 replays glimpse 0's tucker masks
            H = goldens.SMALL["num_hid"]
            for shape in (b["v"].shape, (goldens.N, b["q"].shape[1], H),
                          (goldens.N, b["a"].shape[1], H)):
                masks.append([m for m in masks if m.shape == shape][-1])
        sources.append(MaskSource(masks))
        step = make_train_step(
            model, TrainConfig(update_freq=1),
            ctx_factory=lambda src=sources[-1]: Ctx(train=True,
                                                    mask_source=src))
        m = step(state, b, goldens.LR)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), z[f"{knob}_{k}"][i],
                                       rtol=TRAIN_TOL, atol=TRAIN_TOL,
                                       err_msg=f"step {i} {k}")
        sources[-1].assert_exhausted()
    params = jax_params_from_torch(model.state_dict())
    stats = param_stats(params)
    assert list(stats["names"]) == list(z[f"{knob}_param_names"])
    for k in ("l2", "sum", "l1"):
        np.testing.assert_allclose(stats[k], z[f"{knob}_param_{k}"],
                                   rtol=TRAIN_TOL, atol=TRAIN_TOL, err_msg=k)
    flat = dict(_flatten(params))
    np.testing.assert_allclose(
        goldens.head([flat[n] for n in stats["names"]]),
        z[f"{knob}_param_head"], rtol=TRAIN_TOL, atol=TRAIN_TOL)


def test_remat_replays_the_generators_masks():
    """With masks drawn from a generator, the remat step's loss, gradients
    and the generator's state afterwards equal the plain step's: the
    recompute drew what the forward drew, and the generator moved on past
    those draws once."""
    params = numpy_params(ModelConfig(**SMALL), seed=4)
    batch = numpy_batch(ModelConfig(**SMALL), 3, seed=2, boxes=8,
                        real_boxes=6)
    out = []
    for remat in (False, True):
        model = port_cti(dict(SMALL, remat_glimpse=remat), params)
        gen = torch.Generator().manual_seed(9)
        logits, _ = model(*(torch.from_numpy(batch[k]) for k in "vqa"),
                          ctx=Ctx(train=True, generator=gen))
        (logits ** 2).sum().backward()
        out.append((logits.detach(), [p.grad for p in model.parameters()],
                    torch.rand(4, generator=gen)))
    torch.testing.assert_close(out[1][0], out[0][0], rtol=0, atol=0)
    for a, b in zip(out[1][1], out[0][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(out[1][2], out[0][2], rtol=0, atol=0)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_remat_step_equals_the_plain_step(compute_dtype):
    """Two training steps, dropout drawn from one seed: with
    ``remat_glimpse`` the losses, grad norms and params equal the plain
    step's, also at bf16 compute, where the recompute must run on the
    forward's bf16 casts of the parameters, not on the float32 masters."""
    cfg = ModelConfig(**SMALL)
    params = numpy_params(cfg, seed=4)
    batch = numpy_batch(cfg, 3, seed=2, boxes=8, real_boxes=6, target=True)
    batch = {k: torch.from_numpy(t) for k, t in batch.items()}
    out = []
    for remat in (False, True):
        model = port_cti(dict(SMALL, remat_glimpse=remat), params)
        state = make_train_state(model, device="cpu")
        step = make_train_step(model, TrainConfig(compute_dtype=compute_dtype))
        gen = torch.Generator().manual_seed(9)
        ms = [step(state, batch, 1e-3, generator=gen) for _ in range(2)]
        out.append(([(float(m["loss"]), float(m["grad_norm"])) for m in ms],
                    [p.detach().clone() for p in model.parameters()]))
    assert out[1][0] == out[0][0]
    for a, b in zip(out[1][1], out[0][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("knob", [dict(fused_v_tucker=True),
                                  dict(remat_glimpse=True),
                                  dict(v_block_size=4)])
def test_eval_forward_equals_the_standard_path(knob):
    """At eval every variant gives the standard path's logits (the fused
    GEMM and the blockwise sums in another order: 1e-5)."""
    params = numpy_params(ModelConfig(**SMALL), seed=6)
    batch = numpy_batch(ModelConfig(**SMALL), 3, seed=3, boxes=8,
                        real_boxes=6)
    x = [torch.from_numpy(batch[k]) for k in "vqa"]
    with torch.inference_mode():
        want, _ = port_cti(SMALL, params)(*x)
        got, att = port_cti(dataclasses.replace(
            ModelConfig(**SMALL), **knob).__dict__, params)(*x)
    assert (att is None) == ("v_block_size" in knob)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=FWD_TOL)
