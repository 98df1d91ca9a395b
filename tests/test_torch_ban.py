"""vqatpu_torch's BAN model (``models/ffoe.py``) against vqatpu's on the CPU:
the same numpy weights (``numpy_params``) and inputs (``numpy_batch``) go
through both.

- Logits and attention at small width (``tests/test_torch_model.py``'s
  widths), with and without the counter and at the published BAN-8 glimpse
  count, within 1e-5 of the largest logit; the dtypes at bf16 compute.
- The full width of bench.py with the counter (ntoken 20000, 2048-d
  features, 3129 answers, num_hid 1024, 2 glimpses, 10 objects) and
  without it: the JAX goldens that chip_smoke.py holds the card to,
  written when missing, else read; the port within 1e-3 in float32 and
  within the bf16 budget (2x JAX's own largest bf16 error against its
  float32 logits, plus 1e-4) at bf16 compute, at B=4 and, with the
  counter, at B=32.
- Training with the counter and the distillation loss: a dropout-active
  step under injected masks (every site in JAX's order), a fully padded
  sample with finite gradients, 3-step trajectories at small width (1e-4)
  and the full-width golden trajectories at lr 1e-4 (1e-4) and at the
  reference lr of 1e-3 (the float32 drift measured for both packages).
- Weights and checkpoints across the packages; serving without answer
  tokens on every wire, by id, through the MicroBatcher and over HTTP;
  the teacher logits on the three input paths and the distillation loop
  through the CLIs.

The counter is ill-conditioned, so two of its checks take measured
limits.  At bf16 its soft count moves by up to 0.37 from float32 on the
CPU (B=32, seed 2) and JAX's own bf16 logits by up to 0.64, and on the
H100 one sample of the B=4 golden counted 7.91 where the port's CPU path
counted 7.44, past a budget that JAX's own error on four samples set:
the card is held on the B=32 golden, where it meets the budget on every
sample (chip_smoke.py prints the counts of a sample over it).  In training
at lr 1e-3, Adamax's steps of about +-lr carry float32 rounding forward
through the counter: see ``REFERENCE_LR_TOL``.
"""

import os
import pickle
import shutil
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vqatpu.config import ModelConfig as JaxModelConfig
from vqatpu.config import TrainConfig as JaxTrainConfig
from vqatpu.data.dictionary import Dictionary as JaxDictionary
from vqatpu.data.datasets import VQAFeatureDataset as JaxVQA
from vqatpu.models import build_model as jax_build_model
from vqatpu.ops import bilinear as jbil
from vqatpu.ops.module import Ctx as JaxCtx
from vqatpu.serve import InferenceSession as JaxSession
from vqatpu.serve import ResidentFeatures as JaxResidentFeatures
from vqatpu.train import checkpoints as jckpt
from vqatpu.train import loop as jloop
from vqatpu.train import steps as jsteps
from vqatpu_torch.cli import ffoe_test, ffoe_train
from vqatpu_torch.cli import serve as cli
from vqatpu_torch.config import ModelConfig, TrainConfig
from vqatpu_torch.data import batching
from vqatpu_torch.data.datasets import VQAFeatureDataset
from vqatpu_torch.data.device_store import DeviceFeatureStore
from vqatpu_torch.data.dictionary import Dictionary
from vqatpu_torch.data.native import NativeBatchLoader
from vqatpu_torch.data.synthetic import make_vqa_fixture
from vqatpu_torch.models import build_model
from vqatpu_torch.models.ffoe import BanModel
from vqatpu_torch.ops.bilinear import BCNet
from vqatpu_torch.ops.module import Ctx
from vqatpu_torch.serve import InferenceSession, MicroBatcher, ResidentFeatures
from vqatpu_torch.train import checkpoints as pckpt
from vqatpu_torch.train import loop as ploop
from vqatpu_torch.train import make_eval_step, make_train_state, make_train_step
from vqatpu_torch.weights import (jax_params_from_torch, load_jax_params,
                                  numpy_batch, numpy_params, param_stats,
                                  torch_state_from_jax)

TOL, TRAIN_TOL, SERVE_TOL = 1e-5, 1e-4, 1e-3
BF16_BUDGET, BF16_FLOOR = 2.0, 1e-4
SMALL = dict(ntoken=50, v_dim=32, num_ans_candidates=17, model="ban",
             num_hid=32, gamma=2)  # tests/test_models.py
FULL = dict(ntoken=20000, v_dim=2048, num_ans_candidates=3129, model="ban",
            num_hid=1024, gamma=2, use_counter=True)  # bench.py:50-52
DATA = Path(__file__).parent / "data"
GOLDEN = DATA / "torch_ban_golden.npz"
GOLDEN_BF16 = DATA / "torch_ban_golden_bf16.npz"
GOLDEN_PARAM_SEED, GOLDEN_BATCH_SEED, GOLDEN_N = 0, 1, 4
GOLDEN_BF16_N32 = DATA / "torch_ban_golden_bf16_n32.npz"
GOLDEN_N32, GOLDEN_BATCH_SEED_N32 = 32, 2
TRAIN_GOLDEN = DATA / "torch_ban_train_golden.npz"
TRAIN_GOLDEN_LR3 = DATA / "torch_ban_train_golden_lr1e-3.npz"
TRAIN_BATCH_SEED, TRAIN_STEPS, TRAIN_LR = 40, 3, 1e-4
ANS = [f"ans{i}" for i in range(17)]


def jax_batch(batch):
    return {k: jnp.asarray(x.astype(np.int32) if x.dtype == np.int64 else x)
            for k, x in batch.items()}


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def small_batch(kw, n=3, seed=4, **extra):
    """Inputs at small width: 8 boxes, 6 real; the last sample's boxes all
    padded."""
    batch = numpy_batch(ModelConfig(**kw), n, seed=seed, boxes=8,
                        real_boxes=6, **extra)
    batch["v"][-1] = 0.0
    batch["b"][-1] = 0.0
    return batch


def jax_apply(kw, params, batch, ctx=None):
    jm = jax_build_model(JaxModelConfig(**kw))
    fn = jm.apply if ctx is not None else jax.jit(jm.apply)
    out, att = fn(jax.tree.map(jnp.asarray, params), jax_batch(batch),
                  *(() if ctx is None else (ctx,)))
    return np.asarray(out), None if att is None else np.asarray(att)


def port_apply(kw, params, batch, ctx=None):
    model = load_jax_params(build_model(ModelConfig(**kw)), params).eval()
    with torch.inference_mode():
        out, att = model(t(batch["v"]), t(batch["q"]), ctx=ctx,
                         b=t(batch["b"]))
    return out.numpy(), None if att is None else att.numpy()


# -- the model ---------------------------------------------------------------

@pytest.mark.parametrize("extra", [dict(), dict(use_counter=True),
                                   dict(use_counter=True, gamma=8)],
                         ids=["ban", "ban-counter", "ban8-counter"])
def test_ban_small_width_matches_jax(extra):
    """Logits within 1e-5 of the largest (they reach ~33 at 8 glimpses),
    the [B, G, V, Q] attention within 1e-5; the padded boxes and the fully
    padded sample get no attention."""
    kw = dict(SMALL, **extra)
    params = numpy_params(ModelConfig(**kw), seed=3)
    batch = small_batch(kw)
    want, att_want = jax_apply(kw, params, batch)
    got, att = port_apply(kw, params, batch)
    assert got.shape == (3, 17) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max())
    assert att.shape == (3, kw["gamma"], 8, 12)
    np.testing.assert_allclose(att, att_want, atol=TOL)
    np.testing.assert_array_equal(att[:, :, 6:], 0.0)
    np.testing.assert_array_equal(att[-1], 0.0)


def test_registry_builds_the_free_form_models():
    cfg = ModelConfig(**dict(SMALL, use_counter=True))
    ban = build_model(cfg)
    assert isinstance(ban, BanModel) and ban.counter is not None
    assert ban.inputs == ("v", "q", "b")
    assert build_model(ModelConfig(**SMALL)).inputs == ("v", "q")
    for name in ("san", "stacked_attention"):
        m = build_model(ModelConfig(**dict(SMALL, model=name)))
        assert type(m).__name__ == "StackedAttentionModel"
    # the default configuration is BAN's
    assert ModelConfig(ntoken=5, v_dim=4, num_ans_candidates=3).model == "ban"
    assert isinstance(build_model(ModelConfig(5, 4, 3, num_hid=8)), BanModel)
    with pytest.raises(ValueError, match="unknown model"):
        build_model(ModelConfig(**dict(SMALL, model="mlp")))


def test_ban_counter_needs_spatials():
    model = build_model(ModelConfig(**dict(SMALL, use_counter=True)))
    batch = small_batch(SMALL)
    with pytest.raises(ValueError, match="spatials"):
        model(t(batch["v"]), t(batch["q"]))


def test_ban_bf16_dtype_flow_matches_jax(monkeypatch):
    """At bf16 (parameters and ``v`` bf16, ``b`` float32, as the eval and
    train steps run) each glimpse's pooling sees the question states in
    JAX's dtype: bf16 at the first glimpse, float32 after the counter's
    float32 residual; the logits and the attention dtypes too."""
    kw = dict(SMALL, use_counter=True)
    params = numpy_params(ModelConfig(**kw), seed=3)
    batch = small_batch(kw)
    seen = {"jax": [], "torch": []}

    def recording(side, fn):
        def pool(self, *args):  # (p,) v, q, w_qv, ctx
            out = fn(self, *args)
            seen[side].append(tuple(str(x.dtype).replace("torch.", "")
                                    for x in (args[-3], args[-2], out)))
            return out
        return pool

    monkeypatch.setattr(jbil.BCNet, "apply_with_weights_qv",
                        recording("jax", jbil.BCNet.apply_with_weights_qv))
    monkeypatch.setattr(BCNet, "apply_with_weights_qv",
                        recording("torch", BCNet.apply_with_weights_qv))
    jm = jax_build_model(JaxModelConfig(**kw))
    jb = jax_batch(batch)
    jb["v"] = jb["v"].astype(jnp.bfloat16)
    jl, jatt = jax.jit(jm.apply)(jsteps.cast_floats(
        jax.tree.map(jnp.asarray, params), jnp.bfloat16), jb)
    model = load_jax_params(build_model(ModelConfig(**kw)), params)
    with torch.inference_mode():
        tl, tatt = model.to(torch.bfloat16)(
            t(batch["v"]).to(torch.bfloat16), t(batch["q"]), b=t(batch["b"]))
    assert seen["jax"] == [("bfloat16", "bfloat16", "bfloat16"),
                           ("float32", "bfloat16", "float32")]
    assert seen["torch"] == seen["jax"]
    assert (str(jl.dtype), str(jatt.dtype)) == ("float32", "bfloat16")
    assert (tl.dtype, tatt.dtype) == (torch.float32, torch.bfloat16)


def assert_bf16_budget(got, want_bf16, want_f32):
    """The port at bf16 within twice JAX's own bf16 error against JAX's
    float32 logits, plus the floor, both the largest over the batch."""
    assert np.isfinite(got).all()
    err, own = np.abs(got - want_f32).max(), np.abs(want_bf16 - want_f32).max()
    assert err <= BF16_BUDGET * own + BF16_FLOOR, (err, own)


def jax_eval_logits(kw, params, batch, compute_dtype):
    jm = jax_build_model(JaxModelConfig(**kw))
    out = jsteps.make_eval_step(jm, compute_dtype=compute_dtype)(
        jax.tree.map(jnp.asarray, params), jax_batch(batch))
    return np.asarray(out["logits"])


def test_ban_bf16_small_width_within_budget():
    """The eval step at bf16 (``b`` float32) and the session at bf16 (``b``
    cast to bf16, ``vqatpu/serve.py:203-204``), each against its JAX
    counterpart's error."""
    kw = dict(SMALL, use_counter=True)
    params = numpy_params(ModelConfig(**kw), seed=3)
    batch = small_batch(kw, n=4)
    want32 = jax_eval_logits(kw, params, batch, "float32")
    model = load_jax_params(build_model(ModelConfig(**kw)), params).eval()
    got = make_eval_step(model, compute_dtype="bfloat16")(batch)["logits"]
    assert got.dtype == torch.float32
    assert_bf16_budget(got.numpy(), jax_eval_logits(kw, params, batch,
                                                    "bfloat16"), want32)
    jsess = JaxSession(jax_build_model(JaxModelConfig(**kw)),
                       jax.tree.map(jnp.asarray, params), ANS, max_boxes=8,
                       compute_dtype="bfloat16")
    sess = InferenceSession(model, ANS, max_boxes=8, compute_dtype="bfloat16",
                            device="cpu")
    args = (batch["v"], batch["b"], batch["q"])
    assert_bf16_budget(sess.logits(*args), jsess.logits(*args), want32)


# -- full width: the goldens of the chip check --------------------------------

def read_golden(path, make, **seeds):
    """The golden at ``path``: JAX's numbers from ``make()``, written with
    their ``seeds`` when the file is missing, else read as they are (the
    JAX package does not change), after its seeds are checked."""
    if not path.exists():
        np.savez_compressed(path, **make(), **seeds)
    with np.load(path) as z:
        for k, v in seeds.items():
            assert z[k] == v, (path.name, k, z[k], v)
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def full_params():
    return numpy_params(ModelConfig(**FULL), seed=GOLDEN_PARAM_SEED)


FULL_PLAIN = dict(FULL, use_counter=False)
LOGIT_SEEDS = dict(n=GOLDEN_N, param_seed=GOLDEN_PARAM_SEED,
                   batch_seed=GOLDEN_BATCH_SEED)


def golden_batch(n=GOLDEN_N, seed=GOLDEN_BATCH_SEED):
    return numpy_batch(ModelConfig(**FULL), n, seed=seed)


def plain_params():
    return numpy_params(ModelConfig(**FULL_PLAIN), seed=GOLDEN_PARAM_SEED)


def jax_served_bf16(kw, params, batch):
    return JaxSession(jax_build_model(JaxModelConfig(**kw)),
                      jax.tree.map(jnp.asarray, params), ANS,
                      compute_dtype="bfloat16").logits(
        batch["v"], batch["b"], batch["q"])


@pytest.fixture(scope="module")
def golden32(full_params):
    """JAX's float32 logits at full width (V=50, 44 real boxes), with the
    counter (``logits``) and without it (``logits_nocounter``, its own
    seeded tree)."""
    def make():
        batch = golden_batch()
        return dict(logits=jax_apply(FULL, full_params, batch)[0],
                    logits_nocounter=jax_apply(FULL_PLAIN, plain_params(),
                                               batch)[0])
    return read_golden(GOLDEN, make, **LOGIT_SEEDS)


def test_jax_golden_logits(full_params, golden32):
    """The port's CPU path within 1e-3 of JAX's float32 golden, with and
    without the counter."""
    batch = golden_batch()
    got, _ = port_apply(FULL, full_params, batch)
    assert got.shape == (GOLDEN_N, 3129) and np.isfinite(got).all()
    np.testing.assert_allclose(got, golden32["logits"], atol=SERVE_TOL)
    got, _ = port_apply(FULL_PLAIN, plain_params(), batch)
    np.testing.assert_allclose(got, golden32["logits_nocounter"],
                               atol=SERVE_TOL)


def test_jax_golden_bf16_logits(full_params, golden32):
    """JAX's bf16 logits at full width, served (``logits``: the session
    casts ``b`` to bf16; ``logits_nocounter`` without the counter) and
    evaluated (``logits_eval``: ``b`` float32); the port's CPU path meets
    the budget on each."""
    batch = golden_batch()

    def make():
        return dict(logits=jax_served_bf16(FULL, full_params, batch),
                    logits_nocounter=jax_served_bf16(FULL_PLAIN,
                                                     plain_params(), batch),
                    logits_eval=jax_eval_logits(FULL, full_params, batch,
                                                "bfloat16"))
    g16 = read_golden(GOLDEN_BF16, make, **LOGIT_SEEDS)
    args = (batch["v"], batch["b"], batch["q"])
    golden, golden_plain = golden32["logits"], golden32["logits_nocounter"]

    def port_session(kw, params):
        model = load_jax_params(build_model(ModelConfig(**kw)), params).eval()
        return model, InferenceSession(model, ANS, compute_dtype="bfloat16",
                                       device="cpu")

    model, sess = port_session(FULL, full_params)
    assert_bf16_budget(sess.logits(*args), g16["logits"], golden)
    got = make_eval_step(model, compute_dtype="bfloat16")(batch)["logits"]
    assert_bf16_budget(got.numpy(), g16["logits_eval"], golden)
    _, sess = port_session(FULL_PLAIN, plain_params())
    assert_bf16_budget(sess.logits(*args), g16["logits_nocounter"],
                       golden_plain)


def test_jax_golden_bf16_logits_n32(full_params):
    """The counter's bf16 golden at B=32 (its own batch seed), which the
    card is held to: JAX's float32 logits (``logits``), served at bf16
    (``logits_bf16``) and through the eval step at bf16 (``logits_eval``);
    the port's CPU path meets the budget, the largest error over all 32
    samples, on both bf16 paths."""
    batch = golden_batch(GOLDEN_N32, GOLDEN_BATCH_SEED_N32)

    def make():
        return dict(logits=jax_apply(FULL, full_params, batch)[0],
                    logits_bf16=jax_served_bf16(FULL, full_params, batch),
                    logits_eval=jax_eval_logits(FULL, full_params, batch,
                                                "bfloat16"))
    g = read_golden(GOLDEN_BF16_N32, make, n=GOLDEN_N32,
                    param_seed=GOLDEN_PARAM_SEED,
                    batch_seed=GOLDEN_BATCH_SEED_N32)
    model = load_jax_params(build_model(ModelConfig(**FULL)),
                            full_params).eval()
    sess = InferenceSession(model, ANS, compute_dtype="bfloat16",
                            device="cpu")
    assert_bf16_budget(sess.logits(batch["v"], batch["b"], batch["q"]),
                       g["logits_bf16"], g["logits"])
    got = make_eval_step(model, compute_dtype="bfloat16")(batch)["logits"]
    assert_bf16_budget(got.numpy(), g["logits_eval"], g["logits"])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's entry points run there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_golden_logits(cuda, full_params):
    """On the card, the float32 session's logits against the JAX golden
    (1e-3), and the launch counts of the CTI kernels stay zero."""
    from vqatpu_torch.kernels import trilinear as K

    batch = golden_batch()
    model = load_jax_params(build_model(ModelConfig(**FULL)), full_params)
    K.reset_launches()
    got = InferenceSession(model, ANS, device=cuda).logits(
        batch["v"], batch["b"], batch["q"])
    # the registry also counts the split-bf16 GEMM, which any model's large
    # float32 products take
    assert sum(n for k, n in K.launches.items()
               if not k.startswith("linear_f32")) == 0, K.launches
    with np.load(GOLDEN) as z:
        np.testing.assert_allclose(got, z["logits"], atol=SERVE_TOL)


# -- training ------------------------------------------------------------------

def jax_run(kw, params, batches, tcfg, lr=1e-3, ctx_factory=None):
    jm = jax_build_model(JaxModelConfig(**kw))
    state = jsteps.make_train_state(jm, jax.random.PRNGKey(0))
    state = state._replace(params=jax.tree.map(jnp.asarray, params))
    step = jsteps.make_train_step(jm, tcfg)
    metrics = []
    for b in batches:
        if ctx_factory is not None:
            step = jsteps.make_train_step(jm, tcfg, ctx_factory=ctx_factory)
        state, m = step(state, jax_batch(b), jnp.float32(lr),
                        jax.random.PRNGKey(1), False)
        metrics.append({k: np.asarray(v) for k, v in m.items()})
    return metrics, jax.tree.map(np.asarray, state.params)


def torch_run(kw, params, batches, tcfg, lr=1e-3, ctx_factory=None):
    model = build_model(ModelConfig(**kw))
    model.load_state_dict(torch_state_from_jax(params))
    state = make_train_state(model, device="cpu")
    step = make_train_step(model, tcfg, ctx_factory=ctx_factory)
    metrics = [{k: v.numpy() for k, v in step(state, b, lr).items()}
               for b in batches]
    return metrics, state


def assert_metrics_close(got, want, tol=TRAIN_TOL):
    for g, w in zip(got, want, strict=True):
        for k in ("loss", "grad_norm", "batch_score"):
            np.testing.assert_allclose(g[k], w[k], rtol=tol, atol=tol,
                                       err_msg=k)


def assert_params_close(model, want, tol=TRAIN_TOL):
    got = jax_params_from_torch(model.state_dict())
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree.leaves(got)):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))


def kd_batches(kw, n_steps=3, seed=10):
    batches = [small_batch(kw, n=4, seed=seed + i, target=True, teacher=True)
               for i in range(n_steps)]
    real = numpy_batch(ModelConfig(**kw), 1, seed=99, boxes=8, real_boxes=6)
    for b in batches[1:]:  # only the first batch has a fully padded sample
        b["v"][-1], b["b"][-1] = real["v"][0], real["b"][0]
    return batches


@pytest.mark.parametrize("counter,distill", [(True, True), (False, True)],
                         ids=["counter-kd", "kd"])
def test_ban_trajectory_matches_jax(counter, distill):
    """Three deterministic steps at small width (update_freq 1), the first
    batch with a fully padded sample: per-step loss, pre-clip grad norm,
    batch score and the params within 1e-4."""
    kw = dict(SMALL, use_counter=counter)
    params = numpy_params(ModelConfig(**kw), seed=3)
    batches = kd_batches(kw)
    tcfg = dict(update_freq=1, deterministic=True, distillation=distill)
    want, want_params = jax_run(kw, params, batches, JaxTrainConfig(**tcfg))
    got, state = torch_run(kw, params, batches, TrainConfig(**tcfg))
    assert all(np.isfinite(m["grad_norm"]) for m in got)
    assert_metrics_close(got, want)
    assert_params_close(state.model, want_params)
    for i in range(8) if counter else ():  # weight[0] pinned under autograd
        assert getattr(state.model.counter, f"f{i}").weight[0] == 0.0


def test_ban_distillation_changes_the_loss():
    """The KD loss replaces BCE for BAN (the CTI step ignores the flag)."""
    kw = dict(SMALL, use_counter=True)
    params = numpy_params(ModelConfig(**kw), seed=3)
    batches = kd_batches(kw, n_steps=1)
    plain, _ = torch_run(kw, params, batches, TrainConfig(
        update_freq=1, deterministic=True))
    kd, _ = torch_run(kw, params, batches, TrainConfig(
        update_freq=1, deterministic=True, distillation=True))
    assert abs(float(plain[0]["loss"]) - float(kd[0]["loss"])) > 1e-3


class OrderedMasks:
    """Records the masks JAX's step asks for, in order; the port's step
    must then ask for the same shapes in the same order."""

    def __init__(self, seed, keep=0.7):
        self.rs = np.random.RandomState(seed)
        self.keep, self.masks, self.at, self.replaying = keep, [], 0, False

    def next_mask(self, shape):
        if not self.replaying:
            m = (self.rs.rand(*shape) < self.keep).astype(np.float32)
            self.masks.append(m)
            return m
        m = self.masks[self.at]
        assert m.shape == tuple(shape), (self.at, m.shape, tuple(shape))
        self.at += 1
        return m


@pytest.mark.parametrize("counter", [True, False], ids=["counter", "plain"])
def test_ban_dropout_active_step_under_injected_masks(counter):
    """A step with dropout on: v_att's BCNet (v_net, q_net, then
    ``dropout[1]`` on v_), each glimpse's b_net, q_prj (and c_prj, rate 0)
    and the classifier, mask for mask in JAX's order."""
    kw = dict(SMALL, use_counter=counter)
    params = numpy_params(ModelConfig(**kw), seed=3)
    batches = kd_batches(kw, n_steps=1)
    src = OrderedMasks(20)
    tcfg = dict(update_freq=1, distillation=True)
    want, want_params = jax_run(
        kw, params, batches, JaxTrainConfig(**tcfg),
        ctx_factory=lambda: JaxCtx(train=True, mask_source=src))
    n_masks = len(src.masks)
    src.replaying = True
    got, state = torch_run(kw, params, batches, TrainConfig(**tcfg),
                           ctx_factory=lambda: Ctx(train=True,
                                                   mask_source=src))
    assert src.at == n_masks == 3 + 3 * kw["gamma"] + 1
    assert_metrics_close(got, want)
    assert_params_close(state.model, want_params)


def traj_record(metrics, params):
    stats = param_stats(params)
    out = {k: np.array([float(m[k]) for m in metrics])
           for k in ("loss", "grad_norm", "batch_score")}
    out.update({f"param_{k}": v for k, v in stats.items()})
    return out


def assert_traj_close(got, want, tol=None):
    """Per-step metrics and per-leaf norms within ``tol`` relative (by key;
    TRAIN_TOL where none is given), a leaf's sum within its ``param_sum``
    tolerance of its l1 norm."""
    tol = dict.fromkeys(("loss", "grad_norm", "batch_score", "param_l2",
                         "param_l1", "param_sum"), TRAIN_TOL) | (tol or {})
    assert (got["param_names"] == want["param_names"]).all()
    for k in ("loss", "grad_norm", "batch_score", "param_l2", "param_l1"):
        np.testing.assert_allclose(got[k], want[k], rtol=tol[k],
                                   atol=TRAIN_TOL, err_msg=k)
    err = np.abs(got["param_sum"] - want["param_sum"]) / want["param_l1"]
    assert (err <= tol["param_sum"]).all(), err.max()


def golden_trajectory(path, lr):
    """-> (JAX's 3-step trajectory at full width, B=4, with the counter and
    the distillation loss, written to ``path`` when missing; the port's on
    the CPU from the same weights and batches)."""
    cfg = ModelConfig(**FULL)
    params = numpy_params(cfg, seed=GOLDEN_PARAM_SEED)
    batches = [numpy_batch(cfg, GOLDEN_N, seed=TRAIN_BATCH_SEED + i,
                           target=True, teacher=True)
               for i in range(TRAIN_STEPS)]
    tcfg = dict(update_freq=1, deterministic=True, distillation=True)
    golden = read_golden(
        path, lambda: traj_record(*jax_run(
            FULL, params, batches, JaxTrainConfig(**tcfg), lr=lr)),
        n=GOLDEN_N, steps=TRAIN_STEPS, param_seed=GOLDEN_PARAM_SEED,
        batch_seed=TRAIN_BATCH_SEED, lr=lr)
    got, state = torch_run(FULL, params, batches, TrainConfig(**tcfg), lr=lr)
    return golden, traj_record(got, jax_params_from_torch(
        state.model.state_dict()))


def test_full_width_golden_trajectory():
    """At lr 1e-4, the trajectory chip_smoke.py holds the card to: the
    port's CPU trajectory within 1e-4 of JAX's."""
    golden, got = golden_trajectory(TRAIN_GOLDEN, TRAIN_LR)
    assert_traj_close(got, golden)


# At the reference lr of 1e-3 both float32 trajectories drift from the
# float64 one (the port's module in double), on the CPU
# (tests/torch_ban_drift.py): over nine batch seeds the third step's grad
# norm by up to 3.6e-2 (JAX's, seed 80; the port's up to 1.2e-2, seeds 40
# and 50), the losses by up to 8.8e-4 and the per-leaf norms and sums by
# up to 3.8e-4 (JAX's, seed 50).  At the float64 run's own params both
# give its third grad norm within 5e-6 (seed 40): Adamax's steps of about
# +-lr carry the rounding forward through the counter, in either package.
# The limits are those readings, rounded up.
REFERENCE_LR_TOL = dict(loss=1e-3, grad_norm=4e-2, param_l2=4e-4,
                        param_l1=4e-4, param_sum=4e-4)


def test_full_width_golden_trajectory_at_reference_lr():
    """At lr 1e-3, the port's CPU trajectory against JAX's within the
    float32 drift measured for both packages (``REFERENCE_LR_TOL``)."""
    golden, got = golden_trajectory(TRAIN_GOLDEN_LR3, 1e-3)
    assert_traj_close(got, golden, REFERENCE_LR_TOL)


# -- weights and checkpoints ---------------------------------------------------

def test_state_round_trips_and_strict_loading():
    """JAX's init tree (structure and shapes of ``numpy_params``) loads
    strictly and comes back unchanged; a missing leaf, an extra leaf or a
    wrong shape raise."""
    kw = dict(SMALL, use_counter=True)
    jtree = jax.tree.map(np.array, jax_build_model(JaxModelConfig(**kw)).init(
        jax.random.PRNGKey(4)))
    ours = numpy_params(ModelConfig(**kw), seed=1)
    assert jax.tree.structure(jtree) == jax.tree.structure(ours)
    assert jax.tree.map(np.shape, jtree) == jax.tree.map(np.shape, ours)
    model = load_jax_params(build_model(ModelConfig(**kw)), jtree)
    back = jax_params_from_torch(model.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(jtree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(a, b)
    assert "counter.f3.weight" in torch_state_from_jax(jtree)
    assert "v_att.h_mat_g" in torch_state_from_jax(jtree)
    for broken in ("missing", "extra", "shape"):
        tree = jax.tree.map(np.copy, jtree)
        if broken == "missing":
            del tree["c_prj1"]
        elif broken == "extra":
            tree["counter"]["f8"] = {"weight": np.ones(17, np.float32)}
        else:
            tree["v_att"]["bc"]["h_mat"] = np.ones((1, 3, 1, 96), np.float32)
        with pytest.raises(RuntimeError):
            load_jax_params(build_model(ModelConfig(**kw)), tree)


def test_checkpoints_resume_across_packages(tmp_path):
    """JAX's checkpoint of a BAN (counter) run resumes in the port and the
    port's in JAX: the next step's loss and grad norm agree (1e-4)."""
    kw = dict(SMALL, use_counter=True)
    params = numpy_params(ModelConfig(**kw), seed=3)
    b0, b1 = kd_batches(kw, n_steps=2)
    tcfg = dict(update_freq=1, deterministic=True, distillation=True)
    jm = jax_build_model(JaxModelConfig(**kw))
    jstate = jsteps.make_train_state(jm, jax.random.PRNGKey(0))
    jstate = jstate._replace(params=jax.tree.map(jnp.asarray, params))
    jstep = jsteps.make_train_step(jm, JaxTrainConfig(**tcfg))
    jstate, _ = jstep(jstate, jax_batch(b0), jnp.float32(1e-3),
                      jax.random.PRNGKey(1), False)
    path = str(tmp_path / "jax.ckpt")
    jckpt.save_checkpoint(path, jstate, 2, extra={"best_eval": 0.5})
    model = build_model(ModelConfig(**kw))
    state = make_train_state(model, device="cpu")
    state, start, extra = pckpt.restore_train_state(path, state)
    assert start == 3 and extra == {"best_eval": 0.5} and state.step == 1
    step = make_train_step(model, TrainConfig(**tcfg))
    mp = step(state, b1, 1e-3)
    jstate2, mj = jstep(jstate, jax_batch(b1), jnp.float32(1e-3),
                        jax.random.PRNGKey(1), False)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(mp[k]), float(mj[k]), rtol=TRAIN_TOL)

    path = str(tmp_path / "port.ckpt")
    pckpt.save_checkpoint(path, state, 3, extra={"model": "ban"})
    back, start, _ = jckpt.restore_train_state(
        path, jsteps.make_train_state(jm, jax.random.PRNGKey(5)))
    assert start == 4 and int(back.step) == 2
    for a, b in zip(jax.tree.leaves(back.params),
                    jax.tree.leaves(jstate2.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=TRAIN_TOL, atol=TRAIN_TOL)


# -- serving ------------------------------------------------------------------

WIRES = {"float32": None, "float16": np.float16, "bfloat16": jnp.bfloat16,
         "int8": "int8"}
SESSION = dict(batch_buckets=(2, 4, 8), max_boxes=10)


@pytest.fixture(scope="module")
def served():
    kw = dict(SMALL, use_counter=True)
    params = numpy_params(ModelConfig(**kw), seed=6)
    model = load_jax_params(build_model(ModelConfig(**kw)), params)
    return kw, params, model


def requests(n, seed=7, boxes=8):
    batch = numpy_batch(ModelConfig(**SMALL), n, seed=seed, boxes=boxes,
                        real_boxes=boxes - 2)
    return batch["v"], batch["b"], batch["q"]


@pytest.mark.parametrize("wire", list(WIRES))
def test_serving_without_answer_tokens_on_every_wire(served, wire):
    """BAN with the counter takes no answer tokens; its spatials ship in
    the wire's dtype (float16 on the int8 wire); logits within 1e-5 of
    JAX's session on the same wire, over three buckets and a chunk."""
    kw, params, model = served
    sess = InferenceSession(model, ANS, transfer_dtype=wire, device="cpu",
                            **SESSION)
    ref = JaxSession(jax_build_model(JaxModelConfig(**kw)),
                     jax.tree.map(jnp.asarray, params), ANS,
                     transfer_dtype=WIRES[wire], **SESSION)
    for n in (1, 3, 11):
        v, b, q = requests(n)
        got = sess.logits(v, b, q)
        assert got.shape == (n, 17)
        np.testing.assert_allclose(got, ref.logits(v, b, q), atol=TOL)
    assert sess.answer(v, b, q) == ref.answer(v, b, q)
    host, _ = sess.pack(v[:3], q[:3], b=b[:3])
    assert "a" not in host and host["b"].shape == (4, 10, 6)
    want_b = {"float32": np.float32, "float16": np.float16,
              "int8": np.float16}.get(wire)
    if want_b is not None:
        assert host["b"].dtype == want_b
    else:
        assert host["b"].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="spatials"):
        sess.logits(v, None, q)


def test_ban_without_counter_and_cti_requirements(served):
    """BAN without the counter needs neither spatials nor answer tokens."""
    kw, params, _ = served
    plain = load_jax_params(build_model(ModelConfig(**SMALL)),
                            numpy_params(ModelConfig(**SMALL), seed=6))
    sess = InferenceSession(plain, ANS, device="cpu", **SESSION)
    v, b, q = requests(3)
    np.testing.assert_array_equal(sess.logits(v, None, q),
                                  sess.logits(v, b, q))
    host, _ = sess.pack(v, q, b=b)  # spatials it never reads stay home
    assert "b" not in host


@pytest.fixture(scope="module")
def byid_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ban_byid") / "data_vqa")
    make_vqa_fixture(root, n_train=8, n_val=8, n_images=6, v_dim=32)
    return root


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "int8"])
def test_by_id_serving_gathers_spatials(served, byid_root, quantize):
    """By-id serving with the card-resident tables gathers each box's
    spatials too: the logits equal JAX's by-id session (1e-5) and, with
    float32 tables, the upload path's."""
    kw, params, model = served
    rf = ResidentFeatures.from_dataroot(byid_root, "val", max_boxes=10)
    sess = InferenceSession(model, ANS, device="cpu", **SESSION)
    sess.attach_features(rf, placement="device", quantize=quantize)
    ref = JaxSession(jax_build_model(JaxModelConfig(**kw)),
                     jax.tree.map(jnp.asarray, params), ANS, **SESSION)
    ref.attach_features(JaxResidentFeatures.from_dataroot(
        byid_root, "val", max_boxes=10), placement="device",
        quantize=quantize)
    ids = list(rf.img_id2idx)[:5] * 2
    q = requests(10)[2]
    got = sess.logits_by_id(ids, q)
    np.testing.assert_allclose(got, ref.logits_by_id(ids, q), atol=TOL)
    if not quantize:
        v, b = rf.gather(ids)
        np.testing.assert_allclose(got, sess.logits(v, b, q), atol=TOL)
        assert sess.answer_by_id(ids, q) == ref.answer_by_id(ids, q)


def test_micro_batcher_coalesces_ban_requests(served):
    _, _, model = served
    sess = InferenceSession(model, ANS, device="cpu", **SESSION)
    mb = MicroBatcher(sess, max_batch=8, max_wait_ms=50)
    reqs = [requests(n, seed=20 + n) for n in (1, 2, 3)]
    out = [None] * 3

    def call(i):
        out[i] = mb.logits(*reqs[i])

    try:
        threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        for (v, b, q), got in zip(reqs, out):
            np.testing.assert_allclose(got, sess.logits(v, b, q), atol=TOL)
        assert mb.rows_served == 6
        with pytest.raises(ValueError, match="spatials"):
            mb.logits(reqs[0][0], None, reqs[0][2])
    finally:
        mb.close()


def test_http_cli_serves_ban(served, byid_root, tmp_path):
    """``cli.serve --model ban --use_counter`` over HTTP: JSON requests
    with spatials and no answer tokens, and by id."""
    import json
    import urllib.request

    kw, _, _ = served
    d = JaxDictionary.load_from_file(os.path.join(byid_root,
                                                  "dictionary.pkl"))
    with open(os.path.join(byid_root, "cache", "trainval_label2ans.pkl"),
              "rb") as f:
        labels = pickle.load(f)
    jkw = dict(kw, ntoken=d.ntoken, num_ans_candidates=len(labels))
    jstate = jsteps.make_train_state(jax_build_model(JaxModelConfig(**jkw)),
                                     jax.random.PRNGKey(2))
    jckpt.save_checkpoint(str(tmp_path / "sm" / "model_epoch1.ckpt"),
                          jstate, 1)
    args = cli.build_parser().parse_args([
        "--dataroot", byid_root, "--input", str(tmp_path / "sm"), "--epoch",
        "1", "--model", "ban", "--use_counter", "--v_dim", "32",
        "--num_hid", "32", "--max_boxes", "10", "--device", "cpu", "--port",
        "0", "--feature_split", "val"])
    session, server = cli.build_server(args)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    port = server.server_address[1]

    def post(path, body):
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            return json.loads(r.read())

    try:
        v, b, q = requests(3)
        q = np.minimum(q, d.ntoken)
        out = post("/logits", {"features": v.tolist(), "spatials": b.tolist(),
                               "question_tokens": q.tolist()})
        np.testing.assert_allclose(np.asarray(out["logits"]),
                                   session.logits(v, b, q), atol=TOL)
        ids = list(session.features.img_id2idx)[:3]
        out = post("/answer_by_id", {"image_ids": ids,
                                     "questions": ["what color is it?"] * 3})
        assert len(out["answers"]) == 3
        with pytest.raises(urllib.error.HTTPError):
            post("/answer", {"features": v.tolist(),
                             "question_tokens": q.tolist()})
    finally:
        server.shutdown()
        server.server_close()


# -- the distillation loop's inputs and CLIs ----------------------------------

@pytest.fixture(scope="module")
def kd_roots(tmp_path_factory):
    """A dataroot with ``train_teacher_logits.pkl`` (float16 logits per
    question, as ``ffoe_test --model cti`` writes them), twice: (JAX's copy,
    the port's copy)."""
    root = str(tmp_path_factory.mktemp("ban_kd") / "data_vqa")
    make_vqa_fixture(root, n_train=40, n_val=10, n_images=12, v_dim=32)
    d = Dictionary.load_from_file(os.path.join(root, "dictionary.pkl"))
    ds = VQAFeatureDataset("train", d, dataroot=root, max_boxes=16)
    rs = np.random.RandomState(3)
    teacher = {int(e["question_id"]): (3 * rs.randn(ds.num_ans_candidates))
               .astype(np.float16) for e in ds.entries}
    with open(os.path.join(root, "train_teacher_logits.pkl"), "wb") as f:
        pickle.dump(teacher, f)
    shutil.copytree(root, root + "_port")
    return root, root + "_port", teacher


def test_teacher_logits_reach_every_input_path(kd_roots):
    """``t_logits`` in the Python loader's batches, the C++ loader's and the
    card-resident store's fields-only batches, each the teacher's logits of
    the batch's questions."""
    root, _, teacher = kd_roots
    d = Dictionary.load_from_file(os.path.join(root, "dictionary.pkl"))
    ds = VQAFeatureDataset("train", d, dataroot=root, max_boxes=16,
                           distillation=True)
    loaders = {"python": batching.BatchLoader(ds, 8, shuffle=True, seed=2),
               "native": NativeBatchLoader(ds, 8, shuffle=True, seed=2),
               "store": batching.BatchLoader(ds, 8, shuffle=True, seed=2,
                                             fields_only=True)}
    store = DeviceFeatureStore.build(ds, device="cpu")
    seen = {}
    try:
        for name, loader in loaders.items():
            seen[name] = []
            for batch in loader:
                want = np.stack([teacher[int(q)] for q in batch["qid"]])
                np.testing.assert_array_equal(batch["t_logits"],
                                              want.astype(np.float32))
                if name == "store":
                    assert "v" not in batch
                    assert store.gather(batch["ds_idx"])["b"].shape == (
                        8, 16, 6)
                seen[name].append(batch["t_logits"])
    finally:
        loaders["native"].close()
    for name in ("native", "store"):
        np.testing.assert_array_equal(np.concatenate(seen[name]),
                                      np.concatenate(seen["python"]))


def recording(make_step, record):
    def make(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def run(*a, **kw):
            out = step(*a, **kw)  # JAX's step returns (state, metrics)
            record.append(float((out[1] if isinstance(out, tuple)
                                 else out)["loss"]))
            return out
        return run
    return make


def test_kd_loop_three_ways_matches_jax(kd_roots, tmp_path, monkeypatch):
    """BAN with the counter and distillation trained by ``train()`` from the
    card-resident store, the C++ loader and the Python loader: the same
    per-step losses, and JAX's loop from the same params within 1e-4."""
    jroot, proot, _ = kd_roots
    d = Dictionary.load_from_file(os.path.join(proot, "dictionary.pkl"))
    pds = VQAFeatureDataset("train", d, dataroot=proot, max_boxes=16,
                            distillation=True)
    kw = dict(SMALL, use_counter=True, ntoken=d.ntoken, v_dim=pds.v_dim,
              num_ans_candidates=pds.num_ans_candidates)
    params = numpy_params(ModelConfig(**kw), seed=5)
    cfg = dict(epochs=2, batch_size=8, update_freq=1, saving_epoch=99,
               deterministic=True, seed=7, distillation=True)
    runs = {"store": (dict(device_features="on"), False),
            "native": (dict(device_features="off"), True),
            "python": (dict(device_features="off"), False)}
    losses = {}
    for name, (tcfg, use_native) in runs.items():
        record = []
        monkeypatch.setattr(ploop, "make_train_step",
                            recording(ploop.make_train_step, record))
        model = build_model(ModelConfig(**kw))
        model.load_state_dict(torch_state_from_jax(params))
        ploop.train(model, pds, None, TrainConfig(**cfg, **tcfg),
                    str(tmp_path / name),
                    state=make_train_state(model, device="cpu"),
                    use_native_loader=use_native, device="cpu",
                    print_interval=10 ** 6)
        monkeypatch.undo()
        losses[name] = record
    assert len(losses["python"]) == 10
    for name in runs:
        np.testing.assert_allclose(losses[name], losses["python"], rtol=1e-6,
                                   err_msg=name)
    record = []
    monkeypatch.setattr(jloop, "make_train_step",
                        recording(jloop.make_train_step, record))
    jd = JaxDictionary.load_from_file(os.path.join(jroot, "dictionary.pkl"))
    jds = JaxVQA("train", jd, dataroot=jroot, max_boxes=16, distillation=True)
    jm = jax_build_model(JaxModelConfig(**kw))
    js = jsteps.make_train_state(jm, jax.random.PRNGKey(0))
    js = js._replace(params=jax.tree.map(jnp.asarray, params))
    jloop.train(jm, jds, None, JaxTrainConfig(**cfg, device_features="on"),
                str(tmp_path / "jax"), state=js, use_mesh=False,
                use_native_loader=False, print_interval=10 ** 6)
    np.testing.assert_allclose(losses["store"], record, rtol=TRAIN_TOL)


@pytest.mark.parametrize("student", [["ban", "--use_counter"], ["san"]],
                         ids=["ban", "san"])
def test_kd_loop_through_the_clis(tmp_path, student):
    """The distillation loop on the CPU: ``ffoe_train --model cti``, then
    ``ffoe_test --split train`` writes the teacher pkl, which trains
    ``--model ban --use_counter --distillation`` (or ``--model san``);
    ``ffoe_test`` of the student writes its EvalAI JSON and no teacher
    pkl."""
    root = str(tmp_path / "data_vqa")
    make_vqa_fixture(root, n_train=24, n_val=8, n_images=8, v_dim=16)
    dims = ["--num_hid", "16", "--h_mm", "8", "--rank", "2", "--batch_size",
            "8", "--max_boxes", "12", "--device", "cpu", "--dataroot", root]
    # checkpoints are written from epoch 9 on (saving_epoch, as in JAX)
    ffoe_train.main(["--model", "cti", *dims, "--output",
                     str(tmp_path / "cti"), "--epochs", "10"])
    teacher = ffoe_test.main(["--model", "cti", *dims, "--split", "train",
                              "--input", str(tmp_path / "cti"), "--epoch",
                              "9", "--results", str(tmp_path / "res")])
    shutil.copy(teacher["teacher_logits"],
                os.path.join(root, "train_teacher_logits.pkl"))
    out_dir = str(tmp_path / student[0])
    ffoe_train.main(["--model", *student, "--distillation", *dims,
                     "--output", out_dir, "--epochs", "10"])
    log = open(os.path.join(out_dir, "log.txt")).read()
    assert log.count("train_loss") == 10
    out = ffoe_test.main(["--model", *student, *dims, "--split", "val",
                          "--input", out_dir, "--epoch", "9", "--results",
                          str(tmp_path / "res")])
    assert set(out) == {"json"}
    assert os.path.basename(out["json"]) == f"val_{student[0]}c16_epoch9.json"
