"""The LSTM, bidirectional and multi-layer question encoders against
``vqatpu.ops.rnn.QuestionEmbedding`` on the CPU: the same JAX-initialised
weights (through :func:`vqatpu_torch.weights.torch_state_from_jax`) and the
same numpy inputs, every step's state and the last state within 1e-5; two
layers in training with the inter-layer dropout fed the same injected
masks; and the weight names' round trip."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vqatpu.ops import rnn as jrnn
from vqatpu.ops.module import Ctx as JaxCtx
from vqatpu.ops.module import MaskSource as JaxMaskSource
from vqatpu_torch.ops.module import Ctx, MaskSource
from vqatpu_torch.ops.rnn import QuestionEmbedding
from vqatpu_torch.weights import jax_params_from_torch, torch_state_from_jax

TOL = 1e-5
IN, H, T, B = 20, 16, 12, 3

CASES = {"lstm": dict(rnn_type="LSTM"),
         "bigru": dict(bidirect=True),
         "bilstm": dict(bidirect=True, rnn_type="LSTM"),
         "gru_2layers": dict(nlayers=2),
         "bilstm_2layers": dict(bidirect=True, rnn_type="LSTM", nlayers=2)}


def pair(case, dropout=0.0, seed=0):
    kw = dict(CASES[case], dropout=dropout)
    jm = jrnn.QuestionEmbedding(IN, H, **kw)
    p = jax.tree.map(np.array, jm.init(jax.random.PRNGKey(seed)))
    port = QuestionEmbedding(IN, H, **kw)
    port.load_state_dict({k[len("q."):]: v for k, v in
                          torch_state_from_jax({"q": p}).items()}, strict=True)
    return jm, p, port


@pytest.mark.parametrize("case", sorted(CASES))
def test_encoder_matches_jax(rng, case):
    jm, p, port = pair(case)
    x = rng.randn(B, T, IN).astype(np.float32)
    with torch.inference_mode():
        got = port.eval()(torch.from_numpy(x)).numpy()
        last = port.forward_last(torch.from_numpy(x)).numpy()
    jp = jax.tree.map(jnp.asarray, p)
    want, want_last = jax.jit(lambda p_, x_: (
        jm.apply_all(p_, x_), jm.apply_last(p_, x_)))(jp, jnp.asarray(x))
    ndir = 2 if jm.bidirect else 1
    assert got.shape == (B, T, H * ndir) and last.shape == (B, H * ndir)
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL)
    np.testing.assert_allclose(last, np.asarray(want_last), atol=TOL)


@pytest.mark.parametrize("case", ["gru_2layers", "bilstm_2layers"])
def test_inter_layer_dropout_matches_jax_under_injected_masks(rng, case):
    """Training mode, inter-layer dropout 0.3: the mask between the layers
    is the port's own dropout, fed JAX's mask; no other site draws."""
    jm, p, port = pair(case, dropout=0.3)
    x = rng.randn(B, T, IN).astype(np.float32)
    ndir = 2 if jm.bidirect else 1
    mask = (rng.rand(B, T, H * ndir) < 0.7).astype(np.float32)
    want = jax.jit(lambda p_, x_: jm.apply_all(p_, x_, JaxCtx(
        train=True, mask_source=JaxMaskSource([mask]))))(
            jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    source = MaskSource([mask])
    got = port.train()(torch.from_numpy(x),
                       Ctx(train=True, mask_source=source))
    source.assert_exhausted()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_weights_round_trip(case):
    """JAX's ``fwd``/``bwd``/``fwd_l1``/``bwd_l1`` leaves -> torch's
    ``*_l{n}[_reverse]`` names -> back, unchanged, and loaded strictly."""
    _, p, port = pair(case, seed=1)
    tree = {"q_emb": p}
    state = torch_state_from_jax(tree)
    assert {k[len("q_emb."):] for k in state} == set(port.state_dict())
    back = jax_params_from_torch(state)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
