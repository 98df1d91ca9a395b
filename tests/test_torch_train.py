"""vqatpu_torch's training against vqatpu's on the CPU: the loss, Adamax
(float32 and bfloat16 state), the clip and the LR schedule; the train step's
trajectory at small width (``tests/test_models.py`` widths) for 4 steps, with
the same numpy weights and batches fed to both; the frozen GloVe copy,
``skip_nonfinite``, a dropout-active step under injected masks, the targets
and the eval step; and the full-width golden trajectory that chip_smoke.py
holds the card to (``tests/data/torch_cti_train_golden.npz``).

Tolerances: 1e-4 on per-step losses, grad norms and params, as ROADMAP's
parity contract sets for training (float32 sums in another order, through
four updates).  At full width the params are compared by per-leaf norms and
sums at 1e-4 relative: after an update Adamax moves every weight whose
gradient is above eps by about ±lr, so round-off in a near-zero gradient can
flip one element by 2·lr.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from jax.experimental.pallas import tpu as pltpu

from vqatpu.config import ModelConfig as JaxModelConfig
from vqatpu.config import TrainConfig as JaxTrainConfig
from vqatpu.models import build_model as jax_build_model
from vqatpu.ops import losses as jlosses
from vqatpu.ops.module import Ctx as JaxCtx
from vqatpu.train import optim as joptim
from vqatpu.train import steps as jsteps
from vqatpu_torch.config import ModelConfig, TrainConfig
from vqatpu_torch.models import build_model
from vqatpu_torch.ops.losses import bce_with_logits_sum
from vqatpu_torch.ops.module import Ctx, MaskSource
from vqatpu_torch.train import (Adamax, clip_flat_grads, densify_target,
                                make_eval_step, make_train_state,
                                make_train_step, lr_for_epoch, wire_cast)
from vqatpu_torch.weights import (jax_params_from_torch, numpy_batch,
                                  numpy_params, param_stats,
                                  torch_state_from_jax)

TOL = 1e-4
SMALL = dict(ntoken=50, v_dim=32, num_ans_candidates=17, model="cti",
             num_hid=32, h_mm=16, rank=4, gamma=2)  # tests/test_models.py
FULL = dict(ntoken=20000, v_dim=2048, num_ans_candidates=3129, model="cti",
            num_hid=1024, h_mm=512, rank=32, gamma=2)  # bench.py:50-52
GOLDEN = Path(__file__).parent / "data" / "torch_cti_train_golden.npz"
GOLDEN_BF16 = Path(__file__).parent / "data" / "torch_cti_train_golden_bf16.npz"
GOLDEN_PARAM_SEED, GOLDEN_BATCH_SEED, GOLDEN_N, GOLDEN_STEPS = 0, 40, 4, 3
GOLDEN_LR = 1e-3


def small_batches(n_steps, n=4, seed=10):
    cfg = ModelConfig(**SMALL)
    return [numpy_batch(cfg, n, seed=seed + i, boxes=8, real_boxes=6,
                        target=True) for i in range(n_steps)]


def jax_batch(batch):
    return {k: jnp.asarray(x.astype(np.int32) if x.dtype == np.int64 else x)
            for k, x in batch.items()}


def jax_run(kw, params, batches, tcfg, lr=1e-3, force_last=False,
            optim_state_dtype="float32", ctx_factory=None):
    """vqatpu's trajectory: per-step metrics (numpy) and the final params.
    With ``ctx_factory`` every step is traced anew, so that the masks it
    injects are those of that step (a trace bakes them in as constants)."""
    model = jax_build_model(JaxModelConfig(**kw))
    state = jsteps.make_train_state(model, jax.random.PRNGKey(0),
                                    optim_state_dtype=optim_state_dtype)
    state = state._replace(params=jax.tree.map(jnp.asarray, params))
    step = jsteps.make_train_step(model, tcfg)
    metrics = []
    for i, b in enumerate(batches):
        force = force_last and i == len(batches) - 1
        if ctx_factory is not None:
            step = jsteps.make_train_step(model, tcfg, ctx_factory=ctx_factory)
        state, m = step(state, jax_batch(b), jnp.float32(lr),
                        jax.random.PRNGKey(1), force)
        metrics.append({k: np.asarray(v) for k, v in m.items()})
    return metrics, jax.tree.map(np.asarray, state.params)


def torch_run(kw, params, batches, tcfg, lr=1e-3, force_last=False,
              optim_state_dtype="float32", ctx_factory=None):
    """The port's trajectory on the CPU: per-step metrics and the state."""
    model = build_model(ModelConfig(**kw))
    model.load_state_dict(torch_state_from_jax(params))
    state = make_train_state(model, optim_state_dtype=optim_state_dtype,
                             device="cpu")
    step = make_train_step(model, tcfg, ctx_factory=ctx_factory)
    metrics = []
    for i, b in enumerate(batches):
        force = force_last and i == len(batches) - 1
        m = step(state, b, lr, torch.Generator().manual_seed(i), force)
        assert all(isinstance(v, torch.Tensor) for v in m.values())
        metrics.append({k: v.numpy() for k, v in m.items()})
    return metrics, state


def assert_metrics_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("loss", "grad_norm", "batch_score"):
            np.testing.assert_allclose(g[k], w[k], rtol=TOL, atol=TOL,
                                       err_msg=k)
        for k in ("updated", "skipped"):
            assert int(g[k]) == int(w[k]), (k, g[k], w[k])


def assert_params_close(model, want, atol=TOL):
    got = jax_params_from_torch(model.state_dict())
    assert jax.tree.structure(got) == jax.tree.structure(want)
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    for (path, w), g in zip(flat_want, jax.tree.leaves(got)):
        np.testing.assert_allclose(g, w, rtol=TOL, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


# -- loss and optimizer --------------------------------------------------------

def test_bce_with_logits_sum_matches_jax(rng):
    x = (20 * rng.randn(6, 17)).astype(np.float32)  # |x| up to ~60: stable
    z = rng.rand(6, 17).astype(np.float32)
    got = bce_with_logits_sum(torch.from_numpy(x), torch.from_numpy(z))
    want = jlosses.bce_with_logits_sum(jnp.asarray(x), jnp.asarray(z))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    torch.testing.assert_close(
        got, torch.nn.functional.binary_cross_entropy_with_logits(
            torch.from_numpy(x), torch.from_numpy(z), reduction="sum"))


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamax_matches_jax(rng, state_dtype):
    """Five steps of the port's Adamax against ``adamax_with_lr`` with the
    same gradients and learning rates, eps inside the max; bfloat16 state
    is stored rounded to nearest even on both sides."""
    shapes = [(7, 5), (3,), ()]
    w0 = [np.asarray(rng.randn(*s), np.float32) for s in shapes]
    sd = jnp.bfloat16 if state_dtype == "bfloat16" else None
    tx = joptim.adamax_with_lr(state_dtype=sd)
    jp = [jnp.asarray(w) for w in w0]
    jstate = tx.init(jp)
    tp = [torch.from_numpy(w.copy()) for w in w0]
    opt = Adamax(tp, state_dtype=torch.bfloat16 if sd else None)
    for i in range(5):
        grads = [np.asarray(rng.randn(*s) * 10.0 ** -i, np.float32)
                 for s in shapes]
        grads[1][0] = 0.0  # a zero gradient: u = eps, no move
        lr = 1e-3 * (i + 1)
        jstate.hyperparams["learning_rate"] = jnp.float32(lr)
        upd, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        opt.step([torch.from_numpy(g) for g in grads], lr)
        for t, j in zip(tp, jp):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                       atol=1e-7)
    inner = jstate.inner_state[0]
    for mine, theirs in ((opt.m, inner.m), (opt.u, inner.u)):
        for t, j in zip(mine, theirs):
            assert str(t.dtype).endswith(state_dtype)
            np.testing.assert_allclose(t.float().numpy(),
                                       np.asarray(j, np.float32), rtol=1e-5)


@pytest.mark.parametrize("scale", [10.0, 0.01])
def test_clip_flat_grads_matches_jax(rng, scale):
    grads = [(scale * rng.randn(*s)).astype(np.float32) for s in [(10,), (3, 4)]]
    got, norm = clip_flat_grads([torch.from_numpy(g) for g in grads], 0.25)
    want, jnorm = joptim.clip_flat_grads([jnp.asarray(g) for g in grads], 0.25)
    np.testing.assert_allclose(norm.item(), float(jnorm), rtol=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    total = np.sqrt(sum((g.numpy() ** 2).sum() for g in got))
    assert total <= 0.25 + 1e-6 if scale > 1 else total == pytest.approx(norm.item())


def test_lr_for_epoch_matches_jax():
    for cfg in (TrainConfig(), TrainConfig(lr=7e-4, lr_decay_step=3)):
        jcfg = JaxTrainConfig(**dataclasses.asdict(cfg))
        for epoch in range(21):
            assert lr_for_epoch(cfg, epoch) == pytest.approx(
                joptim.lr_for_epoch(jcfg, epoch), rel=1e-12)


def test_train_config_is_a_copy_of_jax():
    mine = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxTrainConfig)}
    assert mine == theirs


class _CountingSource(MaskSource):
    """Ones for every mask asked for, counted by shape."""

    def __init__(self):
        super().__init__([])
        self.shapes = []

    def next_mask(self, shape):
        self.shapes.append(tuple(shape))
        return np.ones(shape, np.float32)


@pytest.mark.parametrize("deterministic,remat,v_masks", [
    (False, False, 1), (True, False, 0), (False, True, 3)],
    ids=["dropout", "deterministic", "remat_glimpse"])
def test_fused_v_tucker_draws_one_mask_on_v(deterministic, remat, v_masks):
    """Under fused_v_tucker JAX draws one dropout mask on v for the 1+gamma
    v-side tuckers, unless remat_glimpse turns the fusion off and each
    tucker draws its own (vqatpu/models/ffoe.py:253-275); the port's step
    draws as many, and none without dropout."""
    cfg = ModelConfig(**SMALL, fused_v_tucker=True, remat_glimpse=remat)
    model = build_model(cfg)
    state = make_train_state(model, seed=0, device="cpu")
    source = _CountingSource()
    step = make_train_step(
        model, TrainConfig(deterministic=deterministic),
        ctx_factory=lambda: Ctx(train=not deterministic, mask_source=source))
    batch = small_batches(1)[0]
    m = step(state, batch, 1e-3)
    assert np.isfinite(float(m["loss"]))
    assert source.shapes.count(batch["v"].shape) == v_masks


def test_blockwise_forward_returns_no_attention():
    """v_block_size below the box count selects JAX's blockwise path,
    which returns att=None (vqatpu/models/ffoe.py:357) and the standard
    path's logits; at or below the block size the standard path runs."""
    cfg = ModelConfig(**SMALL, v_block_size=6)
    params = numpy_params(cfg, seed=1)
    model = load(build_model(cfg), params).eval()
    plain = load(build_model(ModelConfig(**SMALL)), params).eval()
    batch = numpy_batch(cfg, 2, seed=1, boxes=8, real_boxes=6)
    v, q, a = (torch.from_numpy(batch[k]) for k in "vqa")
    with torch.no_grad():
        logits, att = model(v, q, a)
        want, _ = plain(v, q, a)
        assert att is None
        np.testing.assert_allclose(logits.numpy(), want.numpy(), atol=1e-5)
        logits, att = model(v[:, :6], q, a)
    assert logits.shape == (2, 17) and att is not None


def load(model, params):
    model.load_state_dict(torch_state_from_jax(params))
    return model


def test_cti_step_ignores_distillation():
    """JAX applies the distillation loss to BAN and SAN only
    (vqatpu/train/steps.py:208); a CTI step with distillation=True and
    teacher logits in the batch equals one without, on the same batch and
    state."""
    params = numpy_params(ModelConfig(**SMALL), seed=3)
    batches = small_batches(2)
    kd = [dict(b, t_logits=np.random.RandomState(i).randn(4, 17).astype(
        np.float32)) for i, b in enumerate(batches)]
    plain, s_plain = torch_run(SMALL, params, batches,
                               TrainConfig(update_freq=1, deterministic=True))
    distilled, s_kd = torch_run(SMALL, params, kd, TrainConfig(
        update_freq=1, deterministic=True, distillation=True))
    for a, b in zip(plain, distilled):
        for k in ("loss", "grad_norm", "batch_score"):
            assert a[k] == b[k], k
    for a, b in zip(s_plain.model.parameters(), s_kd.model.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("field,value", [
    ("compute_dtype", "float16"), ("transfer_dtype", "int4")])
def test_unknown_dtypes_raise(field, value):
    model = build_model(ModelConfig(**SMALL))
    make_train_state(model, device="cpu")
    with pytest.raises(ValueError, match=field):
        make_train_step(model, TrainConfig(**{field: value}))


def test_train_step_needs_the_state_frozen_alike():
    model = build_model(ModelConfig(**SMALL))
    with pytest.raises(ValueError, match="make_train_state first"):
        make_train_step(model, TrainConfig())
    make_train_state(model, device="cpu")
    make_train_step(model, TrainConfig())
    with pytest.raises(ValueError, match="tfidf_loaded"):
        make_train_step(model, TrainConfig(), tfidf_loaded=True)


def test_mc_scoring_scores_groups():
    """With ``mc_scoring`` the step's batch score is the number of groups of
    4 rows whose largest class-0 margin falls on a row labelled 1."""
    cfg = dataclasses.replace(ModelConfig(**SMALL), task="mc")
    model = build_model(cfg)
    state = make_train_state(model, seed=0, device="cpu")
    step = make_train_step(model, TrainConfig(deterministic=True),
                           mc_scoring=True)
    batch = numpy_batch(ModelConfig(**SMALL), 8, seed=3, boxes=8,
                        real_boxes=6, a_len=6)
    labels = np.eye(4, dtype=np.float32)[[1, 3]].reshape(8, 1)
    batch["target"] = np.concatenate([labels, 1 - labels], 1)
    with torch.no_grad():  # before the step updates the weights
        logits, _ = model(*(torch.from_numpy(batch[k]) for k in "vqa"))
    m = step(state, batch, 1e-3)
    pick = (logits[:, 0] - logits[:, 1]).reshape(2, 4).argmax(1).numpy()
    assert float(m["batch_score"]) == float(labels.reshape(2, 4)[[0, 1], pick].sum())


# -- the train step's trajectory ---------------------------------------------

@pytest.mark.parametrize("update_freq,force_last,state_dtype", [
    (1, False, "float32"), (2, True, "float32"), (1, False, "bfloat16")],
    ids=["update_freq1", "update_freq2_force", "bf16_state"])
def test_deterministic_trajectory_matches_jax(update_freq, force_last,
                                              state_dtype):
    """Four steps at small width: per-step loss, pre-clip grad norm (0 on
    a step that does not update), score and flags, then the params.  With
    update_freq 2 over 3 batches + a forced flush, the last window holds
    one microbatch."""
    params = numpy_params(ModelConfig(**SMALL), seed=3)
    n_steps = 3 if force_last else 4
    batches = small_batches(n_steps)
    kw = dict(update_freq=update_freq, deterministic=True,
              optim_state_dtype=state_dtype)
    want, want_params = jax_run(SMALL, params, batches, JaxTrainConfig(**kw),
                                force_last=force_last,
                                optim_state_dtype=state_dtype)
    got, state = torch_run(SMALL, params, batches, TrainConfig(**kw),
                           force_last=force_last, optim_state_dtype=state_dtype)
    assert_metrics_close(got, want)
    n_updates = sum(int(m["updated"]) for m in want)
    assert state.step == n_updates and state.accum_count == 0
    assert all(str(x.dtype).endswith(state_dtype)
               for x in state.optimizer.m + state.optimizer.u)
    assert_params_close(state.model, want_params)


@pytest.mark.parametrize("state_dtype,cfg_dtype", [
    ("float32", "bfloat16"), ("bfloat16", "float32")])
def test_step_refuses_a_state_of_another_optim_dtype(state_dtype, cfg_dtype):
    """TrainConfig.optim_state_dtype and the state's Adamax storage agree,
    or the step raises before it trains."""
    model = build_model(ModelConfig(**SMALL))
    state = make_train_state(model, optim_state_dtype=state_dtype, device="cpu")
    step = make_train_step(model, TrainConfig(optim_state_dtype=cfg_dtype))
    with pytest.raises(ValueError, match="optim_state_dtype"):
        step(state, small_batches(1)[0], 1e-3, torch.Generator())
    assert state.step == 0


def test_train_step_enforces_f32_math():
    model = build_model(ModelConfig(**SMALL))
    state = make_train_state(model, device="cpu")
    step = make_train_step(model, TrainConfig(update_freq=1))
    assert not torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            step(state, small_batches(1)[0], 1e-3, torch.Generator())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert state.step == 0


def test_frozen_glove_copy_is_untouched_and_stateless():
    params = numpy_params(ModelConfig(**SMALL), seed=3)
    _, state = torch_run(SMALL, params, small_batches(2),
                         TrainConfig(update_freq=1, deterministic=True))
    model = state.model
    for name in ("w_emb", "wa_emb"):
        emb_ = getattr(model, name).emb_
        assert not emb_.requires_grad
        np.testing.assert_array_equal(emb_.detach().numpy(), params[name]["emb_"])
        assert all(p is not emb_ for p in state.optimizer.params)
        assert not np.array_equal(getattr(model, name).emb.detach().numpy(),
                                  params[name]["emb"])
    n_trainable = sum(jax.tree.leaves(jsteps.trainable_mask(params)))
    assert len(state.optimizer.params) == len(state.optimizer.m) == n_trainable
    thawed = make_train_state(build_model(ModelConfig(**SMALL)), seed=3,
                              tfidf_loaded=True, device="cpu")
    assert len(thawed.optimizer.params) == len(jax.tree.leaves(params))
    assert thawed.model.w_emb.emb_.requires_grad


@pytest.mark.parametrize("update_freq", [1, 2])
def test_skip_nonfinite_drops_a_nan_microbatch(update_freq):
    """A NaN target makes the second microbatch's loss NaN: it reports
    ``skipped`` 1, adds a zero gradient, and the params match JAX's."""
    params = numpy_params(ModelConfig(**SMALL), seed=3)
    batches = small_batches(4)
    batches[1]["target"][0, 0] = np.nan
    kw = dict(update_freq=update_freq, deterministic=True, skip_nonfinite=True)
    want, want_params = jax_run(SMALL, params, batches, JaxTrainConfig(**kw))
    got, state = torch_run(SMALL, params, batches, TrainConfig(**kw))
    assert [int(m["skipped"]) for m in got] == [0, 1, 0, 0]
    assert np.isnan(got[1]["loss"])
    for m in got + want:
        m["loss"] = np.nan_to_num(m["loss"])
    assert_metrics_close(got, want)
    assert_params_close(state.model, want_params)


class Recorder:
    """A JAX ``MaskSource`` stand-in that draws each mask with numpy as the
    JAX step asks for it, so that the port can replay the same masks."""

    def __init__(self, seed):
        self.rs = np.random.RandomState(seed)
        self.masks = []

    def next_mask(self, shape):
        m = (self.rs.rand(*shape) < 0.7).astype(np.float32)
        self.masks.append(m)
        return m


def test_dropout_active_step_matches_jax_under_injected_masks():
    """A training step with dropout on, every site fed the same masks."""
    params = numpy_params(ModelConfig(**SMALL), seed=3)
    batches = small_batches(1)
    recorders = [Recorder(20)]
    it = iter(recorders)
    want, want_params = jax_run(
        SMALL, params, batches, JaxTrainConfig(update_freq=1),
        ctx_factory=lambda: JaxCtx(train=True, mask_source=next(it)))
    sources = iter([MaskSource(r.masks) for r in recorders])
    used = []

    def ctx_factory():
        used.append(next(sources))
        return Ctx(train=True, mask_source=used[-1])

    got, state = torch_run(SMALL, params, batches, TrainConfig(update_freq=1),
                           ctx_factory=ctx_factory)
    for src in used:
        src.assert_exhausted()
    assert len(used) == 1 and len(recorders[0].masks) > 3 * SMALL["rank"]
    assert_metrics_close(got, want)
    assert_params_close(state.model, want_params)


def test_generator_dropout_is_seeded_and_active():
    """With dropout on and no masks injected, the step draws from the
    generator it is given: the same seed gives the same loss, another seed
    another one, and none matches the deterministic step."""
    params = numpy_params(ModelConfig(**SMALL), seed=3)
    batch = small_batches(1)[0]
    losses = []
    for seed, deterministic in ((0, False), (0, False), (1, False), (0, True)):
        model = build_model(ModelConfig(**SMALL))
        model.load_state_dict(torch_state_from_jax(params))
        state = make_train_state(model, device="cpu")
        step = make_train_step(model, TrainConfig(update_freq=1,
                                                  deterministic=deterministic))
        losses.append(step(state, batch, 1e-3,
                           torch.Generator().manual_seed(seed))["loss"].item())
    assert losses[0] == losses[1]
    assert losses[0] != losses[2] and losses[0] != losses[3]


def test_densify_target_matches_jax(rng):
    lab = np.array([[3, 0, 0], [1, 16, 5]], np.int32)
    score = np.array([[0.9, 0.0, 0.0], [0.3, 1.0, 0.6]], np.float32)
    want = jsteps.densify_target({"t_label": jnp.asarray(lab),
                                  "t_score": jnp.asarray(score)}, 17)["target"]
    got = densify_target({"t_label": torch.from_numpy(lab),
                          "t_score": torch.from_numpy(score)}, 17)["target"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    same = {"target": torch.zeros(2, 17)}
    assert densify_target(same, 17) is same


def test_sparse_targets_train_like_dense():
    params = numpy_params(ModelConfig(**SMALL), seed=3)
    dense = small_batches(1)[0]
    lab = np.argsort(-dense["target"], axis=1)[:, :5]
    sparse = {k: dense[k] for k in "vqa"}
    sparse["t_label"] = lab
    sparse["t_score"] = np.take_along_axis(dense["target"], lab, 1)
    dense["target"] = densify_target(
        {"t_label": torch.from_numpy(lab),
         "t_score": torch.from_numpy(sparse["t_score"])}, 17)["target"].numpy()
    tcfg = TrainConfig(update_freq=1, deterministic=True)
    a, _ = torch_run(SMALL, params, [dense], tcfg)
    b, _ = torch_run(SMALL, params, [sparse], tcfg)
    assert a[0]["loss"] == b[0]["loss"]


def test_eval_step_matches_jax():
    params = numpy_params(ModelConfig(**SMALL), seed=3)
    batch = small_batches(1, n=5)[0]
    batch["target"][3:] = 0.0  # zero-padded rows add nothing
    want = jax.jit(jsteps.make_eval_step(jax_build_model(JaxModelConfig(**SMALL))))(
        jax.tree.map(jnp.asarray, params), jax_batch(batch))
    model = build_model(ModelConfig(**SMALL))
    model.load_state_dict(torch_state_from_jax(params))
    got = make_eval_step(model.eval())(batch)
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]),
                               atol=1e-5)
    for k in ("score", "upper_bound"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6)
    assert got["upper_bound"].item() == pytest.approx(
        batch["target"].max(1).sum(), rel=1e-6)


def test_jax_params_round_trip_is_the_identity():
    params = numpy_params(ModelConfig(**dict(SMALL, num_layers=2)), seed=1)
    back = jax_params_from_torch(torch_state_from_jax(params))
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == np.float32 and a.shape == np.shape(b)
        np.testing.assert_array_equal(a, b)


# -- the full-width golden -------------------------------------------------------

def golden_batches(cfg):
    return [numpy_batch(cfg, GOLDEN_N, seed=GOLDEN_BATCH_SEED + i, target=True)
            for i in range(GOLDEN_STEPS)]


def assert_stats_close(got, want):
    np.testing.assert_array_equal(got["names"], want["names"])
    np.testing.assert_allclose(got["l2"], want["l2"], rtol=TOL)
    np.testing.assert_allclose(got["l1"], want["l1"], rtol=TOL)
    assert (np.abs(got["sum"] - want["sum"]) <= TOL * want["l1"]).all()


def test_full_width_golden_trajectory():
    """bench.py's model at B=4, three deterministic steps at lr 1e-3, the
    JAX trajectory that chip_smoke.py holds the card to: written when
    missing, else recomputed and checked; the port's CPU trajectory agrees
    with it."""
    cfg = ModelConfig(**FULL)
    params = numpy_params(cfg, seed=GOLDEN_PARAM_SEED)
    batches = golden_batches(cfg)
    tcfg = dict(update_freq=1, deterministic=True)
    want, want_params = jax_run(FULL, params, batches, JaxTrainConfig(**tcfg),
                                lr=GOLDEN_LR)
    stats = param_stats(want_params)
    record = {k: np.array([m[k] for m in want], np.float64)
              for k in ("loss", "grad_norm", "batch_score")}
    if not GOLDEN.exists():
        np.savez_compressed(GOLDEN, n=GOLDEN_N, steps=GOLDEN_STEPS,
                            param_seed=GOLDEN_PARAM_SEED,
                            batch_seed=GOLDEN_BATCH_SEED, lr=GOLDEN_LR,
                            **record, **{f"param_{k}": v for k, v in stats.items()})
    with np.load(GOLDEN) as z:
        golden = {k: z[k] for k in z.files}
    assert (int(golden["n"]), int(golden["steps"]), int(golden["param_seed"]),
            int(golden["batch_seed"]), float(golden["lr"])) == (
        GOLDEN_N, GOLDEN_STEPS, GOLDEN_PARAM_SEED, GOLDEN_BATCH_SEED, GOLDEN_LR)
    golden_stats = {k: golden[f"param_{k}"] for k in stats}
    for k, v in record.items():
        np.testing.assert_allclose(v, golden[k], rtol=TOL, err_msg=k)
    assert_stats_close(stats, golden_stats)

    got, state = torch_run(FULL, params, batches, TrainConfig(**tcfg),
                           lr=GOLDEN_LR)
    for k in record:
        np.testing.assert_allclose([m[k] for m in got], golden[k], rtol=TOL,
                                   err_msg=k)
    assert_stats_close(param_stats(jax_params_from_torch(
        state.model.state_dict())), golden_stats)


# -- the wires and bf16 compute ------------------------------------------------------

@pytest.mark.parametrize("wire", ["int8", "float16", "bfloat16"])
def test_wire_trajectory_matches_jax(wire):
    """Four steps with a narrowed wire: JAX's step on its ``wire_cast``
    batches, the port's step on the float32 batches with
    ``transfer_dtype`` set (it casts on the host and upcasts on the card);
    1e-4, the float32 contract.  A batch that already carries its int8
    ``v`` and ``v_scale`` passes through the port's cast untouched."""
    params = numpy_params(ModelConfig(**SMALL), seed=3)
    batches = small_batches(4)
    kw = dict(update_freq=2, deterministic=True)
    want, want_params = jax_run(
        SMALL, params, [jsteps.wire_cast(b, wire) for b in batches],
        JaxTrainConfig(**kw))
    got, state = torch_run(SMALL, params, batches,
                           TrainConfig(transfer_dtype=wire, **kw))
    assert_metrics_close(got, want)
    assert_params_close(state.model, want_params)
    plain, plain_state = torch_run(SMALL, params, batches, TrainConfig(**kw))
    assert any(not torch.equal(x, y) for x, y in zip(  # the wire narrows
        plain_state.model.parameters(), state.model.parameters()))
    if wire == "int8":
        pre = [wire_cast(b, "int8") for b in batches]
        assert wire_cast(pre[0], "int8")["v"] is pre[0]["v"]
        again, _ = torch_run(SMALL, params, pre,
                             TrainConfig(transfer_dtype=wire, **kw))
        for g, w in zip(again, got):
            assert g["loss"] == w["loss"]


def test_wire_cast_matches_jax_bits(rng):
    batch = {"v": rng.randn(3, 5, 16).astype(np.float32),
             "b": rng.rand(3, 5, 6).astype(np.float32),
             "q": rng.randint(0, 9, (3, 12))}
    batch["v"][1, 3] = 0.0
    for wire in ("int8", "float16", "bfloat16"):
        got, want = wire_cast(batch, wire), jsteps.wire_cast(batch, wire)
        assert set(got) == set(want)
        for k in got:
            x = got[k].view(torch.int16).numpy() if torch.is_tensor(got[k]) else got[k]
            y = np.asarray(want[k])
            np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8),
                                          err_msg=f"{wire} {k}")
    assert wire_cast(batch, "float32") is batch


def test_jax_pallas_backend_cannot_take_a_bf16_step():
    """The reference fault of ROADMAP queue C: at compute_dtype="bfloat16"
    JAX's Pallas backend fails under ``value_and_grad``, because the
    ``custom_vjp``s of its kernels (``vqatpu/kernels/trilinear.py:
    316-324, 415-426``) return float32 cotangents for bf16 primals and
    ``vqatpu/ops/linear.py:56`` then multiplies bf16 by float32.  Its
    default (xla) backend takes the step; so does the port (below)."""
    params = numpy_params(ModelConfig(**SMALL), seed=3)
    batch = small_batches(1)
    tcfg = JaxTrainConfig(update_freq=1, deterministic=True,
                          compute_dtype="bfloat16")
    with pltpu.force_tpu_interpret_mode(), \
            pytest.raises(TypeError, match="same dtypes"):
        jax_run(dict(SMALL, kernel_backend="pallas"), params, batch, tcfg)
    metrics, _ = jax_run(SMALL, params, batch, tcfg)
    assert np.isfinite(metrics[0]["loss"])


# bf16 training has no JAX Pallas-backend reference (above), so the port's
# bf16 trajectory is held by a budget against JAX's float32 one: at each
# step, for the loss, the pre-clip grad norm and each leaf's l2 norm,
# |port_bf16 - jax_f32| <= 2 |jax_xla_bf16 - jax_f32| + BF16_FLOOR |jax_f32|.
# The floor is a quarter of bf16's relative rounding step (2^-8): JAX's own
# error at one step can fall far below its usual size by chance (0.016% on
# the first full-width grad norm against 0.27% at the second), and biases,
# which Adamax moves by ±lr an element, differ by up to 5.8e-4 of their norm
# (CPU, full width).

BF16_FLOOR = 2.0 ** -10


def bf16_trajectory(kw, params, batches, side, compute_dtype, lr=1e-3):
    tcfg = dict(update_freq=1, deterministic=True, compute_dtype=compute_dtype)
    if side == "jax":
        metrics, p = jax_run(kw, params, batches, JaxTrainConfig(**tcfg), lr=lr)
        stats = param_stats(p)
    else:
        metrics, state = torch_run(kw, params, batches, TrainConfig(**tcfg),
                                   lr=lr)
        stats = param_stats(jax_params_from_torch(state.model.state_dict()))
        assert all(p.dtype == torch.float32 for p in state.model.parameters())
    out = {k: np.array([float(m[k]) for m in metrics]) for k in ("loss", "grad_norm")}
    out["param_l2"] = stats["l2"]
    return out


def assert_bf16_trajectory_budget(got, jax16, jax32):
    for k in ("loss", "grad_norm", "param_l2"):
        bound = 2 * np.abs(jax16[k] - jax32[k]) + BF16_FLOOR * np.abs(jax32[k])
        err = np.abs(got[k] - jax32[k])
        assert (err <= bound).all(), (k, err, bound)


def test_bf16_trajectory_within_budget():
    """Three bf16 steps at small width: master parameters, gradients and
    Adamax stay float32 (the model is never converted)."""
    params = numpy_params(ModelConfig(**SMALL), seed=3)
    batches = small_batches(3)
    jax32 = bf16_trajectory(SMALL, params, batches, "jax", "float32")
    jax16 = bf16_trajectory(SMALL, params, batches, "jax", "bfloat16")
    got = bf16_trajectory(SMALL, params, batches, "torch", "bfloat16")
    assert_bf16_trajectory_budget(got, jax16, jax32)


def test_eval_step_bf16_and_wire_match_jax():
    """bf16 eval against JAX's Pallas-backend bf16 eval (the budget and
    bound of tests/test_torch_model.py), and a float32 eval of an int8-wire
    batch against JAX's (1e-5)."""
    params = numpy_params(ModelConfig(**SMALL), seed=3)
    batch = small_batches(1, n=5)[0]
    model = build_model(ModelConfig(**SMALL))
    model.load_state_dict(torch_state_from_jax(params))
    jparams = jax.tree.map(jnp.asarray, params)

    def jax_eval(compute_dtype, b, backend="xla"):
        jm = jax_build_model(JaxModelConfig(**SMALL, kernel_backend=backend))
        with pltpu.force_tpu_interpret_mode():
            return np.asarray(jsteps.make_eval_step(jm, compute_dtype=compute_dtype)(
                jparams, jax_batch(b))["logits"])

    want32 = jax_eval("float32", batch)
    want16 = jax_eval("bfloat16", batch, "pallas")
    got16 = make_eval_step(model.eval(), compute_dtype="bfloat16")(batch)["logits"]
    assert got16.dtype == torch.float32
    assert next(model.parameters()).dtype == torch.float32
    own = np.abs(want16 - want32).max()
    assert np.abs(got16.numpy() - want32).max() <= 2 * own + 1e-4
    assert np.abs(got16.numpy() - want16).max() <= 1e-2 * np.abs(want32).max()
    wired = jsteps.wire_cast(batch, "int8")
    got8 = make_eval_step(model)(wire_cast(batch, "int8"))["logits"]
    np.testing.assert_allclose(got8.numpy(), jax_eval("float32", wired),
                               atol=1e-5)


def test_full_width_bf16_golden_trajectory():
    """The golden of the card's bf16 training (chip_smoke.py phase 8): the
    full-width trajectory of tests/data/torch_cti_train_golden.npz's seeds
    in float32 and in bf16 on JAX's default (xla) backend, written when
    missing, else JAX's bf16 run recomputed and checked against it within
    the floor; the port's CPU bf16 trajectory meets the budget."""
    cfg = ModelConfig(**FULL)
    params = numpy_params(cfg, seed=GOLDEN_PARAM_SEED)
    batches = golden_batches(cfg)
    jax16 = bf16_trajectory(FULL, params, batches, "jax", "bfloat16",
                            lr=GOLDEN_LR)
    if not GOLDEN_BF16.exists():
        jax32 = bf16_trajectory(FULL, params, batches, "jax", "float32",
                                lr=GOLDEN_LR)
        np.savez_compressed(
            GOLDEN_BF16, n=GOLDEN_N, steps=GOLDEN_STEPS,
            param_seed=GOLDEN_PARAM_SEED, batch_seed=GOLDEN_BATCH_SEED,
            lr=GOLDEN_LR, floor=BF16_FLOOR,
            names=param_stats(params)["names"],
            **{f"f32_{k}": v for k, v in jax32.items()},
            **{f"bf16_{k}": v for k, v in jax16.items()})
    with np.load(GOLDEN_BF16) as z:
        golden = {k: z[k] for k in z.files}
    with np.load(GOLDEN) as z:
        np.testing.assert_allclose(golden["f32_loss"], z["loss"], rtol=TOL)
        np.testing.assert_allclose(golden["f32_grad_norm"], z["grad_norm"],
                                   rtol=TOL)
        np.testing.assert_allclose(golden["f32_param_l2"], z["param_l2"],
                                   rtol=TOL)
    assert float(golden["floor"]) == BF16_FLOOR
    jax32 = {k: golden[f"f32_{k}"] for k in jax16}
    golden16 = {k: golden[f"bf16_{k}"] for k in jax16}
    for k in jax16:
        np.testing.assert_allclose(jax16[k], golden16[k], rtol=BF16_FLOOR)
    got = bf16_trajectory(FULL, params, batches, "torch", "bfloat16",
                          lr=GOLDEN_LR)
    assert_bf16_trajectory_budget(got, golden16, jax32)
