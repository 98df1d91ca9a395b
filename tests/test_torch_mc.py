"""vqatpu_torch's multiple-choice (Visual7W) models, scores and steps
against vqatpu's on the CPU, on the same numpy weights and inputs: small
width (num_hid 32, Q=12, A=6, V=50 with 44 real boxes, 4 candidates a
question), and the full-width JAX goldens that chip_smoke.py holds the
card to (``tests/torch_mc_goldens.py`` writes them; here their seeds are
checked and the port's CPU path is held to them).

Tolerances: 1e-5 on logits and gradients (the float32 contract); scores
exactly; the step's trajectory 1e-4 (``tests/test_torch_train.py``).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from vqatpu.config import ModelConfig as JaxModelConfig
from vqatpu.config import TrainConfig as JaxTrainConfig
from vqatpu.eval import mc as jax_eval_mc
from vqatpu.models import build_model as jax_build_model
from vqatpu.ops.losses import bce_with_logits_sum as jax_bce
from vqatpu.train import steps as jsteps
from vqatpu_torch.config import ModelConfig, TrainConfig
from vqatpu_torch.data.mc_dataset import expand_mc_batch
from vqatpu_torch.eval import mc as eval_mc
from vqatpu_torch.models import build_model
from vqatpu_torch.models.mc import (BanModelMC, StackedAttentionModelMC,
                                    TanModel)
from vqatpu_torch.ops.losses import bce_with_logits_sum
from vqatpu_torch.ops.module import Ctx, MaskSource
from vqatpu_torch.train import (compute_score_mc, make_eval_step,
                                make_train_state, make_train_step)
from vqatpu_torch.weights import (jax_params_from_torch, load_jax_params,
                                  numpy_batch, numpy_params, param_stats,
                                  torch_state_from_jax)

DATA = Path(__file__).parent / "data"
SMALL = dict(ntoken=50, v_dim=32, num_ans_candidates=17, num_hid=32, h_mm=16,
             rank=4, gamma=2, task="mc")
MODELS = {"tan": dict(model="tan"), "ban_counter": dict(model="ban",
                                                        use_counter=True),
          "ban": dict(model="ban"), "san": dict(model="san")}
TOL = 1e-5


def jax_batch(batch):
    return {k: jnp.asarray(x.astype(np.int32) if x.dtype == np.int64 else x)
            for k, x in batch.items()}


class OnesSource(MaskSource):
    """Ones for every dropout mask asked for, the shapes recorded."""

    def __init__(self):
        super().__init__([])
        self.shapes = []

    def next_mask(self, shape):
        self.shapes.append(tuple(shape))
        return np.ones(shape, np.float32)


def rows(kw, n=3, seed=4, boxes=50, real_boxes=44):
    qb = numpy_batch(ModelConfig(**kw), n, seed=seed, boxes=boxes,
                     real_boxes=real_boxes)
    ex = expand_mc_batch(qb)
    return {k: ex[k] for k in ("v", "b", "q", "a", "target")}


@pytest.fixture(scope="module")
def small():
    """Each small model's kwargs, weights and JAX model (Pallas backend,
    run in interpret mode), built once."""
    out = {}
    for name, extra in MODELS.items():
        kw = dict(SMALL, **extra)
        out[name] = (kw, numpy_params(ModelConfig(**kw), seed=3),
                     jax_build_model(JaxModelConfig(**kw,
                                                    kernel_backend="pallas")))
    return out


def port(kw, params):
    return load_jax_params(build_model(ModelConfig(**kw)), params)


def port_logits(model, b):
    with torch.inference_mode():
        logits, _ = model.eval()(*(torch.from_numpy(b[k]) for k in "vqa"),
                                 b=torch.from_numpy(b["b"]))
    return logits.numpy()


@pytest.mark.parametrize("name", list(MODELS))
def test_mc_logits_match_jax(small, name):
    """TanModel against JAX's Pallas path (interpret mode), BanModelMC with
    and without the counter and SAN-MC: 12 candidate rows, 1e-5."""
    kw, params, jmodel = small[name]
    b = rows(kw)
    with pltpu.force_tpu_interpret_mode():
        want, _ = jax.jit(jmodel.apply)(params, jax_batch(
            {k: b[k] for k in ("v", "b", "q", "a")}))
    got = port_logits(port(kw, params), b)
    assert got.shape == (12, 2)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL)


def test_tan_grads_match_jax_pallas(small):
    """The gradient of the training loss through K1's and K2's VJPs (JAX's
    ``custom_vjp``s in interpret mode; the port's plain versions on the
    CPU), every parameter, 1e-5."""
    kw, params, jmodel = small["tan"]
    b = rows(kw, seed=5)
    jb = jax_batch({k: b[k] for k in ("v", "b", "q", "a")})

    def loss_fn(p):
        logits, _ = jmodel.apply(p, jb)
        return jax_bce(logits, jnp.asarray(b["target"])) / logits.shape[0]

    with pltpu.force_tpu_interpret_mode():
        want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(
            jax.tree.map(jnp.asarray, params))
    model = port(kw, params)
    logits, _ = model(*(torch.from_numpy(b[k]) for k in "vqa"))
    loss = bce_with_logits_sum(logits, torch.from_numpy(b["target"])) / 12
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=TOL)
    grads = jax_params_from_torch({n: p.grad for n, p in
                                   model.named_parameters()})
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert jax.tree.structure(grads) == jax.tree.structure(want)
    for (path, w), g in zip(flat_want, jax.tree.leaves(grads)):
        np.testing.assert_allclose(g, np.asarray(w), atol=TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_tan_ignores_fused_v_tucker_and_v_block_size(small):
    """JAX's TanModel reads neither (``vqatpu/models/mc.py:186-221``): with
    ``fused_v_tucker=True`` and ``v_block_size=16`` at 50 boxes it gives
    the plain model's logits, and so does the port's, whose step takes
    them with dropout on instead of refusing."""
    kw, params, _ = small["tan"]
    odd = dict(kw, fused_v_tucker=True, v_block_size=16)
    b = rows(kw, seed=6)
    jmodel = jax_build_model(JaxModelConfig(**odd, kernel_backend="pallas"))
    with pltpu.force_tpu_interpret_mode():
        want, _ = jax.jit(jmodel.apply)(params, jax_batch(
            {k: b[k] for k in ("v", "q", "a")}))
    model = port(odd, params)
    got = port_logits(model, b)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL)
    np.testing.assert_allclose(got, port_logits(port(kw, params), b), atol=0)
    state = make_train_state(model, device="cpu")
    step = make_train_step(model, TrainConfig(), mc_scoring=True)
    m = step(state, b, 1e-3, torch.Generator().manual_seed(0))
    assert np.isfinite(float(m["loss"]))


@pytest.mark.parametrize("task,model,reads", [
    ("ffoe", "cti", True), ("ffoe", "ban", False), ("ffoe", "san", False),
    ("mc", "tan", False), ("mc", "ban", False), ("mc", "san", False)])
def test_fused_v_tucker_is_read_only_where_jax_reads_it(task, model, reads):
    """Only JAX's free-form CTI reads ``fused_v_tucker``
    (``vqatpu/models/ffoe.py:253-275``): with dropout on, its step draws
    one mask on ``v`` for the fused tuckers; every other model ignores the
    flag and draws as it does without it."""
    kw = dict(SMALL, task=task, model=model)
    b = (rows(kw, seed=6) if task == "mc" else numpy_batch(
        ModelConfig(**kw), 4, seed=6, boxes=8, real_boxes=6, target=True))
    counts = []
    for fused in (False, True):
        model_ = build_model(ModelConfig(**kw, fused_v_tucker=fused))
        state = make_train_state(model_, seed=0, device="cpu")
        source = OnesSource()
        step = make_train_step(
            model_, TrainConfig(), mc_scoring=task == "mc",
            ctx_factory=lambda: Ctx(train=True, mask_source=source))
        assert np.isfinite(float(step(state, b, 1e-3)["loss"]))
        counts.append(source.shapes.count(b["v"].shape))
    assert counts[1] == (1 if reads else counts[0])


@pytest.mark.parametrize("task,model,cls", [
    ("mc", "cti", TanModel), ("mc", "tan", TanModel), ("mc", "ban", BanModelMC),
    ("mc", "san", StackedAttentionModelMC),
    ("mc", "stacked_attention", StackedAttentionModelMC)])
def test_build_model_builds_every_mc_model(task, model, cls):
    """Each name of JAX's ``_MC`` table builds its model, whose parameters
    are JAX's tree paths (a strict load of ``numpy_params``) and whose head
    has 2 classes."""
    cfg = ModelConfig(**dict(SMALL, task=task, model=model))
    built = load_jax_params(build_model(cfg), numpy_params(cfg, seed=1))
    assert type(built) is cls and cfg.num_classes == 2
    jtree = jax.eval_shape(jax_build_model(JaxModelConfig(
        **dict(SMALL, model=model))).init, jax.random.PRNGKey(0))
    shapes = {k: tuple(v.shape) for k, v in torch_state_from_jax(
        jax.tree.map(lambda x: np.zeros(x.shape, np.float32), jtree)).items()}
    assert shapes == {k: tuple(v.shape) for k, v in built.state_dict().items()}


def jax_state(jmodel, params):
    """JAX's train state on the given weights (``jsteps.make_train_state``
    without its eager ``init``)."""
    tx = jsteps.make_optimizer(jsteps._frozen_mask_fn(jmodel, False),
                               "float32")
    zero = jnp.zeros([], jnp.int32)
    return jax.jit(lambda p: jsteps.TrainState(
        p, tx.init(p), jax.tree.map(jnp.zeros_like, p), zero, zero))(
        jax.tree.map(jnp.asarray, params))


def tied_logits(rng, groups=64):
    """Integer logits: most groups hold tied largest margins."""
    return rng.randint(-2, 3, (groups * 4, 2)).astype(np.float32)


def test_compute_score_mc_matches_jax_exactly():
    rng = np.random.RandomState(0)
    for logits in (rng.randn(64 * 4, 2).astype(np.float32),
                   tied_logits(rng)):
        labels = np.eye(4, dtype=np.float32)[rng.randint(0, 4, 64)].reshape(-1)
        target = np.stack([labels, 1 - labels], 1)
        want = jax_eval_mc.compute_score_mc(logits, target)
        assert eval_mc.compute_score_mc(logits, target) == want
        assert float(compute_score_mc(torch.from_numpy(logits),
                                      torch.from_numpy(target))) == want
        assert float(jsteps.compute_score_mc_jnp(
            jnp.asarray(logits), jnp.asarray(target))) == want


def test_compute_score_with_emb_matches_jax_exactly():
    """Nearest candidate embedding, scored by the reference's sum-equality
    test: a candidate whose coordinates differ from the truth's but sum to
    the same counts as right, in both packages."""
    rng = np.random.RandomState(1)
    pred = rng.randn(6, 5).astype(np.float32)
    mc = rng.randn(6, 4, 5).astype(np.float32)
    gt = mc[np.arange(6), rng.randint(0, 4, 6)].copy()
    gt[0] = mc[0, np.linalg.norm(pred[0] - mc[0], axis=1).argmin()][::-1]
    got = eval_mc.compute_score_with_emb(pred, mc, gt)
    want = jax_eval_mc.compute_score_with_emb(pred, mc, gt)
    np.testing.assert_array_equal(got, want)
    assert got[0] and got.dtype == bool


STEP_BATCHES = [dict(n=4, seed=20 + i) for i in range(2)]
# tests/test_torch_train.py's bf16 budget: |port - jax32| <= 2 |jax16 -
# jax32| + BF16_FLOOR |jax32|, JAX's bf16 step on its xla backend (its
# Pallas backend takes no bf16 step)
BF16_FLOOR = 2.0 ** -10


def port_steps(kw, params, compute_dtype):
    model = port(kw, params)
    state = make_train_state(model, device="cpu")
    step = make_train_step(model, TrainConfig(
        update_freq=1, deterministic=True, compute_dtype=compute_dtype),
        mc_scoring=True)
    metrics = [step(state, rows(kw, **b), 1e-3) for b in STEP_BATCHES]
    return metrics, jax_params_from_torch(model.state_dict())


@pytest.fixture(scope="module")
def jax_steps(small):
    """JAX's two deterministic TanModel steps (``mc_scoring``, xla
    backend) at float32 and bf16: {dtype: (metrics, final params)}."""
    kw, params, _ = small["tan"]
    jmodel = jax_build_model(JaxModelConfig(**kw))
    out = {}
    for dtype in ("float32", "bfloat16"):
        state = jax_state(jmodel, params)
        jstep = jsteps.make_train_step(jmodel, JaxTrainConfig(
            update_freq=1, deterministic=True, compute_dtype=dtype),
            mc_scoring=True)
        metrics = []
        for b in STEP_BATCHES:
            state, m = jstep(state, jax_batch(rows(kw, **b)),
                             jnp.float32(1e-3), jax.random.PRNGKey(1))
            metrics.append({k: float(v) for k, v in m.items()})
        out[dtype] = (metrics, jax.tree.map(np.asarray, state.params))
    return out


def test_mc_train_step_matches_jax(small, jax_steps):
    """Two deterministic steps with ``mc_scoring``: loss, grad norm, group
    score and the final weights within 1e-4 of JAX's; the 2-class target
    passes the densify step untouched."""
    kw, params, _ = small["tan"]
    got, got_p = port_steps(kw, params, "float32")
    want, want_p = jax_steps["float32"]
    for g, w in zip(got, want):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(g[k]), w[k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)
        for k in ("batch_score", "updated", "skipped"):
            assert float(g[k]) == w[k], k
    for w, g in zip(jax.tree.leaves(want_p), jax.tree.leaves(got_p)):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def test_mc_bf16_steps_within_budget(small, jax_steps):
    """Two bf16 TanModel steps: the loss, the pre-clip grad norm and each
    leaf's l2 norm within the budget of JAX's float32 and bf16 steps."""
    kw, params, _ = small["tan"]
    got, got_p = port_steps(kw, params, "bfloat16")

    def fingerprint(metrics, p):
        return {"loss": np.array([float(m["loss"]) for m in metrics]),
                "grad_norm": np.array([float(m["grad_norm"])
                                       for m in metrics]),
                "param_l2": param_stats(p)["l2"]}

    got = fingerprint(got, got_p)
    jax32, jax16 = (fingerprint(*jax_steps[d])
                    for d in ("float32", "bfloat16"))
    for k in got:
        bound = (2 * np.abs(jax16[k] - jax32[k])
                 + BF16_FLOOR * np.abs(jax32[k]))
        assert (np.abs(got[k] - jax32[k]) <= bound).all(), k


def test_mc_eval_step_matches_jax(small):
    kw, params, _ = small["ban_counter"]
    b = rows(kw, n=8, seed=30)
    jmodel = jax_build_model(JaxModelConfig(**kw))
    want = jsteps.make_eval_step(jmodel, mc_scoring=True)(
        jax.tree.map(jnp.asarray, params), jax_batch(b))
    got = make_eval_step(port(kw, params), mc_scoring=True)(b)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=TOL)
    assert float(got["score"]) == float(want["score"])
    assert "upper_bound" not in got and "upper_bound" not in want


# -- the full-width goldens ----------------------------------------------------

FULL = dict(ntoken=20000, v_dim=2048, num_ans_candidates=3129, num_hid=1024,
            h_mm=512, rank=32, gamma=2, task="mc")
GOLDENS = {"tan": dict(FULL, model="tan"),
           "ban_mc": dict(FULL, model="ban", use_counter=True),
           "san_mc": dict(FULL, model="san", num_stacks=2)}


@pytest.mark.parametrize("name", list(GOLDENS))
def test_full_width_golden_logits(name):
    """The goldens' seeds and shapes, and the port's CPU path on them:
    float32 within 1e-4 of JAX's logits (the repo's limit is 1e-3), on the
    grid path too for TanModel (V=196, zero spatials)."""
    with np.load(DATA / f"torch_{name}_golden.npz") as z:
        g = {k: z[k] for k in z.files}
    n = 32 if name == "ban_mc" else 8  # the counter's bf16 sample
    assert (int(g["n"]), int(g["param_seed"]), int(g["batch_seed"])) == (n, 0, 1)
    kw = GOLDENS[name]
    model = port(kw, numpy_params(ModelConfig(**kw), 0))
    # the first 8 questions of the batch
    first = {k: x[:32] for k, x in rows(kw, n, 1).items()}
    cases = [(first, g["logits"][:32])]
    if name == "ban_mc":
        assert g["logits_eval"].shape == g["logits"].shape
    if name == "tan":
        assert int(g["grid_seed"]) == 2
        grid = rows(kw, 8, 2, boxes=196, real_boxes=196)
        grid["b"] = np.zeros_like(grid["b"])
        cases.append((grid, g["logits_grid"]))
    assert g["logits"].shape == g["logits_bf16"].shape == (4 * n, 2)
    for b, want in cases:
        np.testing.assert_allclose(port_logits(model, b), want, atol=1e-4)


def test_tan_train_golden_seeds():
    """The trajectory goldens' seeds; the bf16 golden's float32 run is the
    float32 golden's."""
    seeds = (4, 3, 0, 40, 1e-3)
    with np.load(DATA / "torch_tan_train_golden.npz") as z:
        assert (int(z["n"]), int(z["steps"]), int(z["param_seed"]),
                int(z["batch_seed"]), float(z["lr"])) == seeds
        assert z["loss"].shape == z["grad_norm"].shape == (3,)
        assert np.isin(z["batch_score"], np.arange(5)).all()
        assert len(z["param_names"]) == len(z["param_l2"]) > 0
        f32 = {k: z[k] for k in z.files}
    with np.load(DATA / "torch_tan_train_golden_bf16.npz") as z:
        assert (int(z["n"]), int(z["steps"]), int(z["param_seed"]),
                int(z["batch_seed"]), float(z["lr"])) == seeds
        assert float(z["floor"]) == BF16_FLOOR
        np.testing.assert_array_equal(z["names"], f32["param_names"])
        for k in ("loss", "grad_norm", "param_l2"):
            np.testing.assert_array_equal(z[f"f32_{k}"], f32[k])
            assert z[f"bf16_{k}"].shape == z[f"f32_{k}"].shape
