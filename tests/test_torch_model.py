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
from vqatpu_torch.config import ModelConfig
from vqatpu_torch.models import build_model
from vqatpu_torch.weights import (load_jax_params, numpy_batch, numpy_params,
                                  torch_state_from_jax)

GOLDEN = Path(__file__).parent / "data" / "torch_cti_golden.npz"
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
    ("ffoe", "ban"), ("ffoe", "san"), ("mc", "cti"), ("mc", "ban")])
def test_unported_models_raise(task, model):
    cfg = dataclasses.replace(ModelConfig(**SMALL), task=task, model=model)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(cfg)
