"""The yardstick's counts: the kernels' bytes and operations against the
figures of ``PERF.md``'s kernel table, and the model's operations against
``torch``'s own count of the reference's products at a small width."""

from __future__ import annotations

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts, gen, weights
from benchmark.reference import cti, tan
from benchmark.reference.trilinear import Dropout, bce_mean
from conftest import ROOT, TINY_MODEL

# B, V, Q, A -> (MB, GFLOP) as PERF.md's kernel table gives them
# (R = 32, X = 16, G = 2, D = 1024)
K1 = [((128, 50, 12, 3), (33.8, 0.472)), ((256, 50, 12, 6), (109.1, 1.887)),
      ((256, 196, 12, 6), (207.2, 7.399))]
K2 = [((128, 50, 12, 3), (35.5, 0.482)), ((256, 50, 12, 6), (76.0, 1.928))]
K2_BWD = [((256, 50, 12, 3), (141.0, 2.831)), ((256, 50, 12, 6), (151.0, 5.662))]


def _close(cost, mb, gflop):
    assert round(cost[0] / 1e6, 1) == mb
    assert round(cost[1] / 1e9, 3) == gflop


@pytest.mark.parametrize("shape, want", K1)
def test_k1_counts_match_the_kernel_table(shape, want):
    B, V, Q, A = shape
    _close(counts.k1(B, V, 32, 16, Q, A, 2), *want)


@pytest.mark.parametrize("shape, want", K2)
def test_k2_counts_match_the_kernel_table(shape, want):
    B, V, Q, A = shape
    _close(counts.k2(B, V, Q, A, 1024), *want)


@pytest.mark.parametrize("shape, want", K2_BWD)
def test_k2_backward_counts_match_the_kernel_table(shape, want):
    B, V, Q, A = shape
    _close(counts.k2_backward(B, V, Q, A, 1024), *want)


def test_softmax_backward_bytes_match_the_kernel_table():
    assert round(counts.softmax_backward(256, 50, 12, 3, 2)[0] / 1e6, 1) == 11.1


def test_bound_takes_the_larger_of_bytes_and_operations():
    peak = counts.peaks_for("NVIDIA H100 80GB HBM3")
    assert peak == (3.35e12, 67e12, 989e12)
    assert counts.bound_s((3.35e12, 1.0), peak) == pytest.approx(1.0)
    assert counts.bound_s((1.0, 67e12), peak) == pytest.approx(1.0)
    assert counts.peaks_for("NVIDIA H100 PCIe") is None
    assert counts.peaks_for("some other card") is None


def _model(arch, name):
    m = json.loads((ROOT / "benchmark" / "configs" / name).read_text())["model"]
    m.update(TINY_MODEL)
    if arch is cti:
        m["num_ans_candidates"] = 7
    return m


@pytest.mark.parametrize("arch, config", [(cti, "cti_vqa2.json"),
                                          (tan, "tan_v7w.json")])
@pytest.mark.parametrize("train", [False, True])
def test_model_flop_matches_torchs_count_of_the_products(arch, config, train):
    """At a small width the hand count agrees with what torch counts in the
    reference's forward (and backward): every matmul, bmm and einsum."""
    m = _model(arch, config)
    B, V, Q, A = 3, 5, 4, 2
    w = weights.make(arch.leaves(m), gen.derive(1, gen.WEIGHTS), "cpu")
    for t in w.values():
        t.requires_grad_(True)
    g = torch.Generator().manual_seed(0)
    v = torch.rand(B, V, m["v_dim"], generator=g)
    q = torch.randint(0, m["ntoken"], (B, Q), generator=g)
    a = torch.randint(0, m["ntoken"], (B, A), generator=g)
    mask = torch.ones(B, V, dtype=torch.bool)
    with FlopCounterMode(display=False) as fc:
        logits = arch.forward(w, m, v, q, a, mask, Dropout(None))
        if train:
            bce_mean(logits, torch.zeros_like(logits)).backward()
    rows_per_sample = 4 if arch is tan else 1
    want = arch.model_flop(m, V, Q, A, train) * B / rows_per_sample
    # the hand count adds the pool's last elementwise product, which torch
    # does not count
    assert fc.get_total_flops() == pytest.approx(want, rel=0.01)


def test_model_flop_of_one_gemm_chain_by_hand():
    """The classifier's chain by hand: one more answer adds a column to its
    last product, [1, 2H] x [2H, 1]: 2 * 2H operations a row forward, and
    twice that again backward (its weight's and its input's gradients)."""
    m = _model(cti, "cti_vqa2.json")
    H = m["num_hid"]
    more = dict(m, num_ans_candidates=m["num_ans_candidates"] + 1)
    for train, times in ((False, 1), (True, 3)):
        grown = cti.model_flop(more, 5, 4, 2, train) - cti.model_flop(
            m, 5, 4, 2, train)
        assert grown == times * 2 * 2 * H
