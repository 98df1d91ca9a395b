"""vqatpu_torch CTIModel against vqatpu's on the same param tree (CPU):
small widths, the full width of bench.py, the JAX golden logits that the
chip check compares the card with, and strict weight loading."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from vqatpu.config import ModelConfig as JaxModelConfig
from vqatpu.models import build_model as jax_build_model
from vqatpu.ops.trilinear import TCNet as JaxTCNet
from vqatpu.train import steps as jsteps
from vqatpu_torch.config import ModelConfig
from vqatpu_torch.models import build_model
from vqatpu_torch.ops.trilinear import TCNet
from vqatpu_torch.weights import (load_jax_params, numpy_batch, numpy_params,
                                  torch_state_from_jax)

GOLDEN = Path(__file__).parent / "data" / "torch_cti_golden.npz"
GOLDEN_BF16 = Path(__file__).parent / "data" / "torch_cti_golden_bf16.npz"
SMALL = dict(ntoken=50, v_dim=32, num_ans_candidates=17, model="cti",
             num_hid=32, h_mm=16, rank=4, gamma=2)  # tests/test_models.py
FULL = dict(ntoken=20000, v_dim=2048, num_ans_candidates=3129, model="cti",
            num_hid=1024, h_mm=512, rank=32, gamma=2)  # bench.py:50-52
GOLDEN_PARAM_SEED, GOLDEN_BATCH_SEED, GOLDEN_N = 0, 1, 4


def jax_logits(kw, params, batch, backend="xla"):
    model = jax_build_model(JaxModelConfig(**kw, kernel_backend=backend))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with pltpu.force_tpu_interpret_mode():
        logits, att = jax.jit(model.apply)(params, jb)
    return np.asarray(logits), np.asarray(att)


def torch_logits(kw, params, batch):
    model = load_jax_params(build_model(ModelConfig(**kw)), params).eval()
    with torch.inference_mode():
        logits, att = model(*(torch.from_numpy(batch[k]) for k in "vqa"))
    return logits.numpy(), att.numpy()


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_cti_small_width_matches_jax(backend):
    params = numpy_params(ModelConfig(**SMALL), seed=3)
    batch = numpy_batch(ModelConfig(**SMALL), 2, seed=4, boxes=8,
                        real_boxes=6)
    want, att_want = jax_logits(SMALL, params, batch, backend)
    got, att_got = torch_logits(SMALL, params, batch)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(att_got, att_want, atol=1e-5)
    assert att_got.shape == (2, 8, 12, 3, 2)
    np.testing.assert_array_equal(att_got[:, 6:], 0.0)


@pytest.fixture(scope="module")
def full_params():
    return numpy_params(ModelConfig(**FULL), seed=GOLDEN_PARAM_SEED)


def test_cti_full_width_matches_jax(full_params):
    """bench.py's config at B=2, V=50 with 44 real boxes: the logit-parity
    target of BASELINE.md, 1e-3."""
    batch = numpy_batch(ModelConfig(**FULL), 2, seed=7)
    want, _ = jax_logits(FULL, full_params, batch)
    got, _ = torch_logits(FULL, full_params, batch)
    assert got.shape == (2, 3129) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-3)


def test_jax_golden_logits(full_params):
    """The JAX logits that chip_smoke.py holds the card to: written when
    missing, else recomputed and checked (1e-4: the same JAX math on
    another CPU), and the port's CPU path agrees with them (1e-3)."""
    batch = numpy_batch(ModelConfig(**FULL), GOLDEN_N, seed=GOLDEN_BATCH_SEED)
    want, _ = jax_logits(FULL, full_params, batch)
    if not GOLDEN.exists():
        GOLDEN.parent.mkdir(exist_ok=True)
        np.savez_compressed(GOLDEN, logits=want, n=GOLDEN_N,
                            param_seed=GOLDEN_PARAM_SEED,
                            batch_seed=GOLDEN_BATCH_SEED)
    with np.load(GOLDEN) as z:
        assert int(z["n"]) == GOLDEN_N
        assert int(z["param_seed"]) == GOLDEN_PARAM_SEED
        assert int(z["batch_seed"]) == GOLDEN_BATCH_SEED
        golden = z["logits"]
    np.testing.assert_allclose(want, golden, atol=1e-4)
    got, _ = torch_logits(FULL, full_params, batch)
    np.testing.assert_allclose(got, golden, atol=1e-3)


# -- bf16 compute -----------------------------------------------------------------
#
# The reference is JAX's Pallas backend at compute_dtype="bfloat16" (the
# path the port mirrors: float32 kernel outputs, promotion after the first
# glimpse), run as its eval step runs it: parameters and v cast to bf16.
# The port rounds to bf16 at the same ops but its GEMMs, GRU and norms
# round their own way, so it is held by an error budget against JAX's
# float32 logits, BF16_BUDGET times JAX's own bf16 error plus 1e-4, and
# directly to JAX's bf16 logits within BF16_DIRECT of the largest float32
# logit (measured on the CPU: 0.34% at small width, 0.61% at full width,
# 1.8e-2 and 8.2e-3 absolute).

BF16_BUDGET, BF16_DIRECT = 2.0, 1e-2


def jax_eval_logits(kw, params, batch, compute_dtype):
    model = jax_build_model(JaxModelConfig(**kw, kernel_backend="pallas"))
    jb = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
          for k, v in batch.items()}
    with pltpu.force_tpu_interpret_mode():
        out = jsteps.make_eval_step(model, compute_dtype=compute_dtype)(
            jax.tree.map(jnp.asarray, params), jb)
    return np.asarray(out["logits"])


def torch_logits_bf16(kw, params, batch):
    model = load_jax_params(build_model(ModelConfig(**kw)), params)
    model = model.to(torch.bfloat16).eval()
    with torch.inference_mode():
        logits, _ = model(torch.from_numpy(batch["v"]).to(torch.bfloat16),
                          *(torch.from_numpy(batch[k]) for k in "qa"))
    return logits.float().numpy()


def assert_bf16_budget(got, want_bf16, want_f32):
    """``got`` (the port at bf16) within the budget against JAX's float32
    logits, and within the direct bound of JAX's bf16 logits."""
    own = np.abs(want_bf16 - want_f32).max()
    err = np.abs(got - want_f32).max()
    assert err <= BF16_BUDGET * own + 1e-4, (err, own)
    direct = np.abs(got - want_bf16).max()
    assert direct <= BF16_DIRECT * np.abs(want_f32).max(), direct


def test_cti_bf16_small_width_matches_jax_pallas_backend():
    params = numpy_params(ModelConfig(**SMALL), seed=3)
    batch = numpy_batch(ModelConfig(**SMALL), 2, seed=4, boxes=8,
                        real_boxes=6)
    want32 = jax_eval_logits(SMALL, params, batch, "float32")
    want16 = jax_eval_logits(SMALL, params, batch, "bfloat16")
    got = torch_logits_bf16(SMALL, params, batch)
    assert got.shape == want16.shape and np.isfinite(got).all()
    assert_bf16_budget(got, want16, want32)


def test_cti_bf16_dtype_flow_matches_jax_pallas_backend(monkeypatch):
    """At bf16 the dtypes of ``att``, of each glimpse's ``joint`` and
    ``q_state`` (and ``a_state``) and of the logits are JAX's Pallas
    backend's: the kernels' outputs are float32 and promote the states
    after the first glimpse."""
    params = numpy_params(ModelConfig(**SMALL), seed=3)
    batch = numpy_batch(ModelConfig(**SMALL), 2, seed=4, boxes=8,
                        real_boxes=6)
    seen = {"jax": [], "torch": []}

    def recording(side, fn):
        def apply_with_weights(self, *args, **kw):
            q, a = args[-4], args[-3]
            joint = fn(self, *args, **kw)
            seen[side].append((str(q.dtype), str(a.dtype), str(joint.dtype)))
            return joint
        return apply_with_weights

    monkeypatch.setattr(JaxTCNet, "apply_with_weights",
                        recording("jax", JaxTCNet.apply_with_weights))
    monkeypatch.setattr(TCNet, "apply_with_weights",
                        recording("torch", TCNet.apply_with_weights))
    jmodel = jax_build_model(JaxModelConfig(**SMALL, kernel_backend="pallas"))
    jb = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
          for k, v in batch.items()}
    jb["v"] = jb["v"].astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        jl, jatt = jmodel.apply(jsteps.cast_floats(
            jax.tree.map(jnp.asarray, params), jnp.bfloat16), jb)
    model = load_jax_params(build_model(ModelConfig(**SMALL)), params)
    with torch.inference_mode():
        tl, tatt = model.to(torch.bfloat16)(
            torch.from_numpy(batch["v"]).to(torch.bfloat16),
            *(torch.from_numpy(batch[k]) for k in "qa"))
    jax_flow = seen["jax"]
    torch_flow = [tuple(x.replace("torch.", "") for x in r)
                  for r in seen["torch"]]
    assert jax_flow == [("bfloat16", "bfloat16", "float32"),
                        ("float32", "float32", "float32")]
    assert torch_flow == jax_flow
    assert (str(jatt.dtype), str(jl.dtype)) == ("float32", "float32")
    assert (tatt.dtype, tl.dtype) == (torch.float32, torch.float32)


def test_jax_golden_bf16_logits(full_params):
    """JAX's Pallas-backend bf16 logits at full width, with the seeds of
    ``torch_cti_golden.npz``: the golden chip_smoke.py holds the card's bf16
    serving to.  Written when missing, else recomputed and checked (within
    the direct bound: XLA's bf16 rounding on another CPU), and the port's
    CPU path meets the budget against it and JAX's float32 golden."""
    batch = numpy_batch(ModelConfig(**FULL), GOLDEN_N, seed=GOLDEN_BATCH_SEED)
    want16 = jax_eval_logits(FULL, full_params, batch, "bfloat16")
    if not GOLDEN_BF16.exists():
        np.savez_compressed(GOLDEN_BF16, logits=want16, n=GOLDEN_N,
                            param_seed=GOLDEN_PARAM_SEED,
                            batch_seed=GOLDEN_BATCH_SEED)
    with np.load(GOLDEN_BF16) as z, np.load(GOLDEN) as z32:
        assert (int(z["n"]), int(z["param_seed"]), int(z["batch_seed"])) == (
            int(z32["n"]), int(z32["param_seed"]), int(z32["batch_seed"]))
        golden16, golden32 = z["logits"], z32["logits"]
    scale = np.abs(golden32).max()
    np.testing.assert_allclose(want16, golden16, atol=BF16_DIRECT * scale)
    got = torch_logits_bf16(FULL, full_params, batch)
    assert_bf16_budget(got, golden16, golden32)


@pytest.mark.parametrize("num_layers", [1, 2])
def test_numpy_params_has_the_jax_tree_layout(num_layers):
    kw = dict(SMALL, num_layers=num_layers)
    want = jax_build_model(JaxModelConfig(**kw)).init(jax.random.PRNGKey(0))
    got = numpy_params(ModelConfig(**kw), seed=0)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert np.shape(a) == np.shape(b) and np.asarray(a).dtype == np.float32


def test_torch_state_round_trips():
    """Every leaf lands in the parameter its path names, unchanged, and
    the GRU leaves take nn.GRU's names."""
    params = numpy_params(ModelConfig(**SMALL), seed=1)
    model = load_jax_params(build_model(ModelConfig(**SMALL)), params)
    state = torch_state_from_jax(params)
    assert set(state) == set(model.state_dict())
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, state[k], rtol=0, atol=0)
    np.testing.assert_array_equal(
        model.q_emb.weight_ih_l0.detach().numpy(), params["q_emb"]["fwd"]["w_ih"])
    np.testing.assert_array_equal(
        model.t_att.tc.v_net.l0.v.detach().numpy(),
        params["t_att"]["tc"]["v_net"]["l0"]["v"])
    np.testing.assert_array_equal(
        model.t_net0.v_tucker.l0.g.detach().numpy(),
        params["t_net0"]["v_tucker"]["l0"]["g"])


def _drop_leaf(p):
    del p["classifier"]["l2"]["b"]


def _extra_leaf(p):
    p["t_net0"]["v_tucker"]["l0"]["extra"] = np.zeros(3, np.float32)


def _wrong_shape(p):
    p["t_att"]["tc"]["T_g"] = p["t_att"]["tc"]["T_g"][:1]


@pytest.mark.parametrize("edit", [_drop_leaf, _extra_leaf, _wrong_shape])
def test_loading_is_strict(edit):
    params = numpy_params(ModelConfig(**SMALL), seed=1)
    edit(params)
    with pytest.raises(RuntimeError):
        load_jax_params(build_model(ModelConfig(**SMALL)), params)


def test_bidirectional_gru_weights_are_refused():
    params = numpy_params(ModelConfig(**SMALL), seed=1)
    params["q_emb"]["bwd"] = params["q_emb"]["fwd"]
    with pytest.raises(NotImplementedError, match="bidirectional"):
        torch_state_from_jax(params)


@pytest.mark.parametrize("task,model", [
    ("mc", "cti"), ("mc", "ban"), ("mc", "san"), ("mc", "tan")])
def test_mc_models_build_and_load(task, model):
    """Every multiple-choice model builds, loads its seeded weights
    strictly and gives 2-class logits for 4 candidate rows."""
    cfg = dataclasses.replace(ModelConfig(**SMALL), task=task, model=model)
    built = load_jax_params(build_model(cfg), numpy_params(cfg, seed=1))
    batch = numpy_batch(ModelConfig(**SMALL), 4, seed=2, boxes=8,
                        real_boxes=6, a_len=6)
    with torch.inference_mode():
        logits, _ = built.eval()(*(torch.from_numpy(batch[k]) for k in "vqa"),
                                 b=torch.from_numpy(batch["b"]))
    assert logits.shape == (4, 2) and torch.isfinite(logits).all()
