"""vqatpu_torch's counting module (``ops/counter.py``) and distillation
loss (``ops/losses.py``) against vqatpu's on the CPU, values and
gradients: ``PiecewiseLin`` and the loss within 1e-5, the counter within
``COUNT_TOL`` (below).

The counter keeps the ``objects`` boxes of highest attention.  Its math is
invariant to their order but not to which of two tied boxes it keeps, so
the ties that occur are tested: fewer real boxes than ``objects`` (the
padded boxes' logits are all -inf, their spatials all zero) and two real
boxes of equal attention at the cut.  A fully padded sample keeps finite
gradients.

The count features are ill-conditioned in float32: the dedup similarity is
a product of ten ``PiecewiseLin`` values, so a last-bit difference in a
head's cumulative sum (``jnp.cumsum`` and ``torch.cumsum`` sum in other
orders) moves the output by up to ~40 ulps.  Against the same math in
float64 (the port's module in double), JAX's float32 output erred by up to
1.85e-5 and the port's by up to 1.24e-5 over 40 draws of 16 samples of 50
boxes (CPU).  So the counter's outputs and gradients are held to
``COUNT_TOL`` = 3e-5 against JAX's and to 2e-5 against float64, where the
other ops of the port keep 1e-5."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vqatpu.ops import counter as jcounter
from vqatpu.ops import losses as jlosses
from vqatpu_torch.ops.counter import Counter, PiecewiseLin
from vqatpu_torch.ops.losses import distillation_loss
from vqatpu_torch.weights import torch_state_from_jax

TOL = 1e-5
COUNT_TOL, F64_TOL = 3e-5, 2e-5
OBJECTS = 10


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def counter_params(rng, perturb=True):
    """The JAX init (ones, ``weight[0] = 0``), moved off it so that each
    head differs; ``weight[0]`` stays 0."""
    p = jax.tree.map(np.array, jcounter.Counter(OBJECTS).init(
        jax.random.PRNGKey(0)))
    if perturb:
        for head in p.values():
            head["weight"][1:] = rng.uniform(0.2, 2.0, 16).astype(np.float32)
    return p


def make_boxes(rng, b, m, real=None):
    """[b, 4, m] (x1, y1, x2, y2) boxes in [0, 1]; zero past ``real``."""
    corners = np.sort(rng.rand(b, 2, 2, m), axis=2)
    boxes = corners.transpose(0, 2, 1, 3).reshape(b, 4, m).astype(np.float32)
    if real is not None:
        boxes[:, :, real:] = 0.0
    return boxes


@jax.jit
def jax_counter(params, boxes, att, cot):
    """JAX's output and the gradients of ``sum(out * cot)`` in the params
    and the attention."""
    jm = jcounter.Counter(OBJECTS)

    def loss(p, a):
        out = jm.apply(p, boxes, a)
        return (out * cot).sum(), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1),
                                         has_aux=True)(params, att)
    return out, grads


def run_both(params, boxes, att, cot=None):
    """(JAX's output and gradients, the port's, the port's in float64) of
    ``sum(out * cot)`` with respect to every head's weights and the
    attention."""
    cot = np.ones((boxes.shape[0], OBJECTS + 1), np.float32) if cot is None \
        else cot
    want, (jg_p, jg_a) = jax_counter(jax.tree.map(jnp.asarray, params),
                                     jnp.asarray(boxes), jnp.asarray(att),
                                     jnp.asarray(cot))
    jgrads = {f"{k}.weight": np.asarray(v["weight"]) for k, v in jg_p.items()}
    sides = []
    for dtype in (torch.float32, torch.float64):
        port = Counter(OBJECTS).to(dtype)
        port.load_state_dict(torch_state_from_jax(params), strict=True)
        ta = t(att).to(dtype).requires_grad_()
        got = port(t(boxes).to(dtype), ta)
        (got * t(cot).to(dtype)).sum().backward()
        grads = {n: p.grad.numpy() for n, p in port.named_parameters()}
        sides.append((got.detach().numpy(), grads, ta.grad.numpy()))
    return (np.asarray(want), jgrads, np.asarray(jg_a)), sides[0], sides[1]


def assert_same(want, got, f64=None):
    (w, wg, wa), (g, gg, ga) = want, got
    assert g.shape == w.shape and g.dtype == np.float32
    np.testing.assert_allclose(g, w, atol=COUNT_TOL)
    if f64 is not None:
        np.testing.assert_allclose(g, f64[0], atol=F64_TOL)
    assert sorted(gg) == sorted(wg)
    for name in wg:
        assert np.isfinite(gg[name]).all(), name
        np.testing.assert_allclose(gg[name], wg[name], atol=COUNT_TOL,
                                   rtol=COUNT_TOL, err_msg=name)
    assert np.isfinite(ga).all()
    np.testing.assert_allclose(ga, wa, atol=COUNT_TOL, rtol=COUNT_TOL)


@pytest.mark.parametrize("n", [1, 16])
def test_piecewise_lin_matches_jax(rng, n):
    """Values at the knots, the ends and between; the gradient keeps the
    zero ``weight[0]`` at zero (``w * sign(w)``)."""
    jm = jcounter.PiecewiseLin(n)
    w = np.concatenate([[0.0], rng.uniform(-2, 2, n)]).astype(np.float32)
    x = np.concatenate([[0.0, 1.0, 0.5], np.arange(n) / n,
                        rng.rand(20)]).astype(np.float32)
    cot = rng.randn(*x.shape).astype(np.float32)
    want = jm.apply({"weight": jnp.asarray(w)}, jnp.asarray(x))
    jg = jax.grad(lambda p: (jm.apply(p, jnp.asarray(x)) * cot).sum())(
        {"weight": jnp.asarray(w)})["weight"]
    port = PiecewiseLin(n)
    port.load_state_dict({"weight": t(w)})
    got = port(t(x))
    (got * t(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=TOL)
    np.testing.assert_allclose(port.weight.grad.numpy(), jg, atol=TOL)
    assert port.weight.grad[0] == 0.0


@pytest.mark.parametrize("m", [6, 12, 50])
def test_counter_matches_jax(rng, m):
    """Random boxes and attention logits; ``m`` below, above and far above
    ``objects`` (``min(objects, m)`` kept)."""
    boxes = make_boxes(rng, 4, m)
    att = (2 * rng.randn(4, m)).astype(np.float32)
    cot = rng.randn(4, OBJECTS + 1).astype(np.float32)
    assert_same(*run_both(counter_params(rng), boxes, att, cot))


def test_counter_float32_error_against_float64(rng):
    """The conditioning that sets ``COUNT_TOL``: both packages' float32
    outputs within ``F64_TOL`` of the float64 evaluation, on 8 draws of 16
    samples of 50 boxes."""
    for _ in range(8):
        boxes = make_boxes(rng, 16, 50)
        att = (2 * rng.randn(16, 50)).astype(np.float32)
        want, got, f64 = run_both(counter_params(rng), boxes, att)
        assert_same(want, got, f64)
        np.testing.assert_allclose(want[0], f64[0], atol=F64_TOL)


def test_counter_fewer_real_boxes_than_objects(rng):
    """6 real boxes of 20: the 14 padded ones tie at -inf (sigmoid 0) with
    identical zero boxes, so the choice among them changes nothing."""
    boxes = make_boxes(rng, 3, 20, real=6)
    att = rng.randn(3, 20).astype(np.float32)
    att[:, 6:] = -np.inf
    assert_same(*run_both(counter_params(rng), boxes, att))


def test_counter_two_real_boxes_tied_at_the_cut(rng):
    """Two distinct real boxes with equal attention share the 10th place:
    nine boxes score higher, the rest lower.  Both packages keep the lower
    index, and the choice matters (keeping the other box moves the count
    features)."""
    boxes = make_boxes(rng, 2, 14)
    att = np.full((2, 14), -1.0, np.float32)
    tied = ((9, 12), (1, 6))
    for row, pair in enumerate(tied):
        higher = [i for i in range(14) if i not in pair][:9]
        att[row, higher] = np.linspace(3.0, 1.0, 9)
        att[row, list(pair)] = 0.5
    params = counter_params(rng)
    want, got, _ = run_both(params, boxes, att)
    assert_same(want, got)
    swapped = boxes.copy()
    for row, (i, j) in enumerate(tied):
        swapped[row][:, [i, j]] = swapped[row][:, [j, i]]
    other, _, _ = run_both(params, swapped, att)
    assert (np.abs(other[0] - want[0]).max(1) > 1e-3).all()


def test_counter_fully_padded_sample_has_finite_gradients(rng):
    boxes = make_boxes(rng, 2, 12, real=None)
    boxes[1] = 0.0
    att = rng.randn(2, 12).astype(np.float32)
    att[1] = -np.inf
    want, got, _ = run_both(counter_params(rng), boxes, att,
                            rng.randn(2, OBJECTS + 1).astype(np.float32))
    assert_same(want, got)
    assert np.isfinite(got[0]).all()


def test_counter_init_pins_weight_zero():
    port = Counter(OBJECTS)
    for i in range(8):
        w = getattr(port, f"f{i}").weight
        assert w.shape == (17,) and w[0] == 0.0 and (w[1:] == 1.0).all()


@pytest.mark.parametrize("T,alpha", [(1.5, 0.2), (1.0, 0.7)])
def test_distillation_loss_and_gradient_match_jax(rng, T, alpha):
    """Hinton KD, its value and its gradient in the student's logits; a
    teacher whose softmax underflows to 0 on some answers (``log t`` read
    as 0 there)."""
    s = (3 * rng.randn(5, 17)).astype(np.float32)
    tl = (3 * rng.randn(5, 17)).astype(np.float32)
    tl[0, :4] = -300.0  # softmax underflows to exactly 0
    z = rng.rand(5, 17).astype(np.float32)

    def jloss(x):
        return jlosses.distillation_loss(x, jnp.asarray(tl), jnp.asarray(z),
                                         T, alpha)

    want, jg = jax.value_and_grad(jloss)(jnp.asarray(s))
    ts = t(s).requires_grad_()
    got = distillation_loss(ts, t(tl), t(z), T, alpha)
    got.backward()
    assert torch.isfinite(got)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(ts.grad.numpy(), jg, atol=1e-6)
