"""vqatpu_torch's SAN (``StackedAttention`` in ``ops/attention.py``,
``StackedAttentionModel`` in ``models/ffoe.py``) and the GRU's last state
(``ops/rnn.py``) against vqatpu's on the CPU, on the same numpy weights and
inputs: the ops within 1e-5, the model's logits within 1e-5 of the
largest, a dropout-active step under injected masks and a 3-step
trajectory with the distillation loss within 1e-4, bf16 compute within the
budget of ``tests/test_torch_ban.py`` (2x JAX's own bf16 error plus 1e-4),
the full-width golden that chip_smoke.py holds the card to, the weights
across the packages and serving without answer tokens on every wire."""

import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vqatpu.config import ModelConfig as JaxModelConfig
from vqatpu.config import TrainConfig as JaxTrainConfig
from vqatpu.models import build_model as jax_build_model
from vqatpu.ops import attention as jatt
from vqatpu.ops import linear as jlin
from vqatpu.ops import rnn as jrnn
from vqatpu.ops.module import Ctx as JaxCtx
from vqatpu.serve import InferenceSession as JaxSession
from vqatpu.train import steps as jsteps
from tests.test_torch_ban import read_golden
from vqatpu_torch.config import ModelConfig, TrainConfig
from vqatpu_torch.models import build_model
from vqatpu_torch.ops.attention import StackedAttention
from vqatpu_torch.ops.linear import FCSTL, Linear
from vqatpu_torch.ops.module import Ctx, MaskSource
from vqatpu_torch.ops.rnn import QuestionEmbedding
from vqatpu_torch.serve import InferenceSession
from vqatpu_torch.train import make_eval_step, make_train_state, make_train_step
from vqatpu_torch.weights import (jax_params_from_torch, load_jax_params,
                                  numpy_batch, numpy_params,
                                  torch_state_from_jax)

TOL, TRAIN_TOL, SERVE_TOL = 1e-5, 1e-4, 1e-3
BF16_BUDGET, BF16_FLOOR = 2.0, 1e-4
SMALL = dict(ntoken=50, v_dim=32, num_ans_candidates=17, model="san",
             num_hid=32)
FULL = dict(ntoken=20000, v_dim=2048, num_ans_candidates=3129, model="san",
            num_hid=1024, num_stacks=2)  # bench.py:50-52, SURVEY.md 2.6
GOLDEN = Path(__file__).parent / "data" / "torch_san_golden.npz"
GOLDEN_PARAM_SEED, GOLDEN_BATCH_SEED, GOLDEN_N = 0, 1, 4
ANS = [f"ans{i}" for i in range(17)]


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def jax_batch(batch):
    return {k: jnp.asarray(x.astype(np.int32) if x.dtype == np.int64 else x)
            for k, x in batch.items()}


def small_batch(kw, n=3, seed=4, **extra):
    """8 boxes, 6 real, the last sample all padded."""
    batch = numpy_batch(ModelConfig(**kw), n, seed=seed, boxes=8,
                        real_boxes=6, **extra)
    batch["v"][-1] = 0.0
    return batch


class Recorder:
    def __init__(self, seed, keep=0.6):
        self.rs, self.keep, self.masks = np.random.RandomState(seed), keep, []

    def next_mask(self, shape):
        m = (self.rs.rand(*shape) < self.keep).astype(np.float32)
        self.masks.append(m)
        return m


@pytest.mark.parametrize("bias", [True, False])
def test_linear_matches_jax(rng, bias):
    """Plain ``nn.Linear`` with the JAX tree's leaves ``w`` and ``b``."""
    jm = jlin.Linear(12, 5, bias)
    params = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(1)))
    x = rng.randn(3, 4, 12).astype(np.float32)
    port = Linear(12, 5, bias)
    port.load_state_dict(torch_state_from_jax(params), strict=True)
    with torch.inference_mode():
        got = port(t(x))
    np.testing.assert_allclose(got.numpy(), jm.apply(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x)), atol=TOL)


def test_fcstl_matches_jax_with_injected_dropout(rng):
    """``Dropout -> Linear -> Tanh`` (``l0``), the mask injected on both."""
    jm = jlin.FCSTL(12, 5, dropout=0.3)
    params = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(2)))
    x = rng.randn(3, 12).astype(np.float32)
    rec = Recorder(5)
    want = jm.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                    JaxCtx(train=True, mask_source=rec))
    port = FCSTL(12, 5, dropout=0.3)
    port.load_state_dict(torch_state_from_jax(params), strict=True)
    src = MaskSource(rec.masks)
    with torch.inference_mode():
        got = port(t(x), Ctx(train=True, mask_source=src))
        plain = port(t(x))
    src.assert_exhausted()
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)
    np.testing.assert_allclose(plain.numpy(), jm.apply(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x)), atol=TOL)


def test_question_embedding_last_state_matches_jax(rng):
    jm = jrnn.QuestionEmbedding(12, 16)
    params = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(0)))
    x = rng.randn(3, 7, 12).astype(np.float32)
    port = QuestionEmbedding(12, 16)
    port.load_state_dict(torch_state_from_jax(params), strict=True)
    with torch.inference_mode():
        got = port.forward_last(t(x))
    assert got.shape == (3, 16)
    np.testing.assert_allclose(got.numpy(), jm.apply_last(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x)), atol=TOL)


@pytest.mark.parametrize("num_stacks", [1, 2, 3])
@pytest.mark.parametrize("padded", [True, False])
def test_stacked_attention_matches_jax(rng, num_stacks, padded):
    """Each round's boxes are masked where its image projection is an
    all-zero row: with ``padded``, the last two boxes of every sample and
    every box of the last sample; without, no box."""
    jm = jatt.StackedAttention(num_stacks, 24, 16, 20, 0.5)
    params = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(num_stacks)))
    img = rng.randn(3, 8, 24).astype(np.float32)
    if padded:
        img[:, 6:] = 0.0
        img[2] = 0.0
    q = rng.randn(3, 16).astype(np.float32)
    port = StackedAttention(num_stacks, 24, 16, 20, 0.5)
    port.load_state_dict(torch_state_from_jax(params), strict=True)
    with torch.inference_mode():
        got = port(t(img), t(q))
    want = jm.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(img),
                    jnp.asarray(q))
    assert got.shape == (3, 20) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


def test_stacked_attention_dropout_sites_in_jax_order(rng):
    jm = jatt.StackedAttention(3, 24, 16, 20, 0.5)
    params = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(7)))
    img = rng.randn(3, 8, 24).astype(np.float32)
    q = rng.randn(3, 16).astype(np.float32)
    rec = Recorder(3)
    want = jm.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(img),
                    jnp.asarray(q), ctx=JaxCtx(train=True, mask_source=rec))
    port = StackedAttention(3, 24, 16, 20, 0.5)
    port.load_state_dict(torch_state_from_jax(params), strict=True)
    src = MaskSource(rec.masks)
    with torch.inference_mode():
        got = port(t(img), t(q), ctx=Ctx(train=True, mask_source=src))
    src.assert_exhausted()
    assert len(rec.masks) == 3
    np.testing.assert_allclose(got.numpy(), want, atol=TOL)


@pytest.mark.parametrize("num_stacks", [1, 2])
def test_san_small_width_matches_jax(num_stacks):
    kw = dict(SMALL, num_stacks=num_stacks)
    params = numpy_params(ModelConfig(**kw), seed=3)
    batch = small_batch(kw)
    want, att = jax.jit(jax_build_model(JaxModelConfig(**kw)).apply)(
        jax.tree.map(jnp.asarray, params), jax_batch(batch))
    assert att is None
    model = load_jax_params(build_model(ModelConfig(**kw)), params).eval()
    with torch.inference_mode():
        got, gatt = model(t(batch["v"]), t(batch["q"]))
        # SAN reads neither the batch's v_mask nor b nor a
        again, _ = model(t(batch["v"]), t(batch["q"]), t(batch["a"]),
                         torch.ones(3, 8, dtype=torch.bool),
                         b=t(batch["b"]))
    assert gatt is None and model.inputs == ("v", "q")
    np.testing.assert_allclose(got.numpy(), want,
                               atol=TOL * np.abs(np.asarray(want)).max())
    torch.testing.assert_close(got, again, rtol=0, atol=0)


def jax_run(kw, params, batches, tcfg, ctx_factory=None):
    jm = jax_build_model(JaxModelConfig(**kw))
    state = jsteps.make_train_state(jm, jax.random.PRNGKey(0))
    state = state._replace(params=jax.tree.map(jnp.asarray, params))
    metrics = []
    step = jsteps.make_train_step(jm, tcfg)
    for b in batches:
        if ctx_factory is not None:  # a trace bakes the injected masks in
            step = jsteps.make_train_step(jm, tcfg, ctx_factory=ctx_factory)
        state, m = step(state, jax_batch(b), jnp.float32(1e-3),
                        jax.random.PRNGKey(1), False)
        metrics.append({k: np.asarray(v) for k, v in m.items()})
    return metrics, jax.tree.map(np.asarray, state.params)


def torch_run(kw, params, batches, tcfg, ctx_factory=None):
    model = build_model(ModelConfig(**kw))
    model.load_state_dict(torch_state_from_jax(params))
    state = make_train_state(model, device="cpu")
    step = make_train_step(model, tcfg, ctx_factory=ctx_factory)
    metrics = [{k: v.numpy() for k, v in step(state, b, 1e-3).items()}
               for b in batches]
    return metrics, state


def assert_run_close(got, state, want, want_params):
    for g, w in zip(got, want, strict=True):
        for k in ("loss", "grad_norm", "batch_score"):
            np.testing.assert_allclose(g[k], w[k], rtol=TRAIN_TOL,
                                       atol=TRAIN_TOL, err_msg=k)
    back = jax_params_from_torch(state.model.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(want_params)
    for (path, w), g in zip(
            jax.tree_util.tree_flatten_with_path(want_params)[0],
            jax.tree.leaves(back)):
        np.testing.assert_allclose(g, w, rtol=TRAIN_TOL, atol=TRAIN_TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_san_trajectory_with_distillation_matches_jax():
    """Three deterministic steps with the distillation loss (the first
    batch has a fully padded sample)."""
    params = numpy_params(ModelConfig(**SMALL), seed=3)
    batches = [small_batch(SMALL, n=4, seed=10 + i, target=True, teacher=True)
               for i in range(3)]
    tcfg = dict(update_freq=1, deterministic=True, distillation=True)
    want, want_params = jax_run(SMALL, params, batches, JaxTrainConfig(**tcfg))
    got, state = torch_run(SMALL, params, batches, TrainConfig(**tcfg))
    assert_run_close(got, state, want, want_params)


def test_san_dropout_active_step_under_injected_masks():
    params = numpy_params(ModelConfig(**SMALL), seed=3)
    batches = [small_batch(SMALL, n=4, seed=10, target=True, teacher=True)]
    rec = Recorder(20)
    tcfg = dict(update_freq=1, distillation=True)
    want, want_params = jax_run(
        SMALL, params, batches, JaxTrainConfig(**tcfg),
        ctx_factory=lambda: JaxCtx(train=True, mask_source=rec))
    src = MaskSource(rec.masks)
    got, state = torch_run(SMALL, params, batches, TrainConfig(**tcfg),
                           ctx_factory=lambda: Ctx(train=True,
                                                   mask_source=src))
    src.assert_exhausted()
    assert len(rec.masks) == 3  # two attention rounds, the classifier
    assert_run_close(got, state, want, want_params)


def assert_bf16_budget(got, want_bf16, want_f32):
    own = np.abs(want_bf16 - want_f32).max()
    err = np.abs(got - want_f32).max()
    assert err <= BF16_BUDGET * own + BF16_FLOOR, (err, own)


def jax_eval(kw, params, batch, compute_dtype):
    jm = jax_build_model(JaxModelConfig(**kw))
    return np.asarray(jsteps.make_eval_step(jm, compute_dtype=compute_dtype)(
        jax.tree.map(jnp.asarray, params), jax_batch(batch))["logits"])


def test_san_bf16_within_budget():
    params = numpy_params(ModelConfig(**SMALL), seed=3)
    batch = small_batch(SMALL, n=4)
    model = load_jax_params(build_model(ModelConfig(**SMALL)), params).eval()
    got = make_eval_step(model, compute_dtype="bfloat16")(batch)["logits"]
    assert got.dtype == torch.float32
    assert_bf16_budget(got.numpy(), jax_eval(SMALL, params, batch, "bfloat16"),
                       jax_eval(SMALL, params, batch, "float32"))


def test_jax_golden_logits():
    """JAX's full-width logits, float32 (``logits``) and served at bf16
    (``logits_bf16``), written when missing, else read; the port's CPU
    path within 1e-3 and within the bf16 budget."""
    cfg = ModelConfig(**FULL)
    params = numpy_params(cfg, seed=GOLDEN_PARAM_SEED)
    batch = numpy_batch(cfg, GOLDEN_N, seed=GOLDEN_BATCH_SEED)

    def make():
        jm = jax_build_model(JaxModelConfig(**FULL))
        jp = jax.tree.map(jnp.asarray, params)
        return dict(
            logits=np.asarray(jax.jit(jm.apply)(jp, jax_batch(batch))[0]),
            logits_bf16=JaxSession(jm, jp, ANS, compute_dtype="bfloat16")
            .logits(batch["v"], None, batch["q"]))
    z = read_golden(GOLDEN, make, n=GOLDEN_N, param_seed=GOLDEN_PARAM_SEED,
                    batch_seed=GOLDEN_BATCH_SEED)
    golden, golden16 = z["logits"], z["logits_bf16"]
    model = load_jax_params(build_model(cfg), params).eval()
    got = InferenceSession(model, ANS, device="cpu").logits(
        batch["v"], None, batch["q"])
    assert got.shape == (GOLDEN_N, 3129) and np.isfinite(got).all()
    np.testing.assert_allclose(got, golden, atol=SERVE_TOL)
    got16 = InferenceSession(model, ANS, compute_dtype="bfloat16",
                             device="cpu").logits(batch["v"], None,
                                                  batch["q"])
    assert_bf16_budget(got16, golden16, golden)


def test_state_round_trips_and_strict_loading():
    kw = dict(SMALL, num_stacks=3)
    jtree = jax.tree.map(np.array, jax_build_model(JaxModelConfig(**kw)).init(
        jax.random.PRNGKey(4)))
    ours = numpy_params(ModelConfig(**kw), seed=1)
    assert jax.tree.map(np.shape, jtree) == jax.tree.map(np.shape, ours)
    model = load_jax_params(build_model(ModelConfig(**kw)), jtree)
    back = jax_params_from_torch(model.state_dict())
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(a, b)
    assert "v_att.w1_h.w" in torch_state_from_jax(jtree)
    del jtree["v_att"]["fc15"]
    with pytest.raises(RuntimeError):
        load_jax_params(build_model(ModelConfig(**kw)), jtree)


WIRES = {"float32": None, "float16": np.float16, "bfloat16": jnp.bfloat16,
         "int8": "int8"}


@pytest.mark.parametrize("wire", list(WIRES))
def test_serving_without_answer_tokens_on_every_wire(wire):
    params = numpy_params(ModelConfig(**SMALL), seed=6)
    model = load_jax_params(build_model(ModelConfig(**SMALL)), params)
    session = dict(batch_buckets=(2, 4, 8), max_boxes=10)
    sess = InferenceSession(model, ANS, transfer_dtype=wire, device="cpu",
                            **session)
    ref = JaxSession(jax_build_model(JaxModelConfig(**SMALL)),
                     jax.tree.map(jnp.asarray, params), ANS,
                     transfer_dtype=WIRES[wire], **session)
    for n in (1, 5, 11):
        batch = numpy_batch(ModelConfig(**SMALL), n, seed=n, boxes=8,
                            real_boxes=6)
        got = sess.logits(batch["v"], None, batch["q"])
        assert got.shape == (n, 17)
        np.testing.assert_allclose(
            got, ref.logits(batch["v"], None, batch["q"]), atol=TOL)
        np.testing.assert_array_equal(
            got, sess.logits(batch["v"], batch["b"], batch["q"]))


def test_http_cli_serves_san(tmp_path):
    """``cli.serve --model san``: requests with neither spatials nor answer
    tokens, over HTTP, equal to the session's logits."""
    import json
    import threading
    import urllib.request

    from vqatpu.data.synthetic import make_vqa_fixture
    from vqatpu.train.checkpoints import save_checkpoint
    from vqatpu_torch.cli import serve as cli

    root = str(tmp_path / "data_vqa")
    d = make_vqa_fixture(root, n_train=8, n_val=8, n_images=6, v_dim=32)
    with open(tmp_path / "data_vqa" / "cache" / "trainval_label2ans.pkl",
              "rb") as f:
        kw = dict(SMALL, ntoken=d.ntoken,
                  num_ans_candidates=len(pickle.load(f)))
    state = jsteps.make_train_state(jax_build_model(JaxModelConfig(**kw)),
                                    jax.random.PRNGKey(2))
    save_checkpoint(str(tmp_path / "sm" / "model_epoch1.ckpt"), state, 1)
    args = cli.build_parser().parse_args([
        "--dataroot", root, "--input", str(tmp_path / "sm"), "--epoch", "1",
        "--model", "san", "--v_dim", "32", "--num_hid", "32", "--max_boxes",
        "10", "--device", "cpu", "--port", "0"])
    session, server = cli.build_server(args)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        batch = numpy_batch(ModelConfig(**kw), 3, seed=5, boxes=8,
                            real_boxes=6)
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/logits",
            data=json.dumps({"features": batch["v"].tolist(),
                             "question_tokens": batch["q"].tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            got = np.asarray(json.loads(r.read())["logits"])
        np.testing.assert_allclose(
            got, session.logits(batch["v"], None, batch["q"]), atol=TOL)
    finally:
        server.shutdown()
        server.server_close()
