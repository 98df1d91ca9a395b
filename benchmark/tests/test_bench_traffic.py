"""The traffic makers at tiny sizes on the CPU: the same seed gives the
same inputs, every seed the same sizes; the store's layout is the program's
(``DeviceFeatureStore``'s)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import gen, store

M = dict(ntoken=50, num_ans_candidates=7)
SHAPES = dict(question_len=12, answer_len=3)
FF = dict(questions=40, question_tokens=[4, 12], answer_tokens=[1, 3],
          labels=[1, 3])
MC = dict(questions=40, question_tokens=[4, 12], answer_tokens=[1, 6],
          candidates=4)
BIG = 2**40 + 12345


def test_derive_takes_seeds_past_32_bits_and_keeps_streams_apart():
    seeds = {gen.derive(s, t) for s in (0, 1, 2**31 + 5, BIG) for t in
             (gen.WEIGHTS, gen.STORE)}
    assert len(seeds) == 8 and all(0 <= s < 2**63 for s in seeds)
    assert gen.derive(BIG, gen.ORDER) == gen.derive(BIG, gen.ORDER)


def test_free_form_fields():
    f = gen.fields(M, SHAPES, FF, BIG)
    g = gen.fields(M, SHAPES, FF, BIG)
    assert all(np.array_equal(f[k], g[k]) for k in f)
    assert f["q"].shape == (40, 12) and f["a"].shape == (40, 3)
    assert f["q"].dtype == np.int32
    real = (f["q"] != M["ntoken"]).sum(1)
    assert real.min() >= 4 and real.max() <= 12
    # the pad token only after the real ones
    assert all((row[n:] == M["ntoken"]).all() for row, n in zip(f["q"], real))
    labels = [set(l[s > 0]) for l, s in zip(f["t_label"], f["t_score"])]
    assert all(1 <= len(x) <= 3 for x in labels)
    assert all(len(set(l)) == len(l) for l in f["t_label"])
    assert set(np.unique(f["t_score"])) <= {0.0, 0.3, 0.6, 0.9, 1.0} | set(
        gen.SCORES.tolist())
    other = gen.fields(M, SHAPES, FF, BIG + 1)
    assert not np.array_equal(f["q"], other["q"])
    b = gen.batch(f, np.array([3, 1]), M["num_ans_candidates"])
    assert b["target"].shape == (2, 7)
    for row, i in enumerate((3, 1)):
        nz = f["t_score"][i] > 0
        assert np.allclose(b["target"][row, f["t_label"][i][nz]],
                           f["t_score"][i][nz])
        assert b["target"][row].astype(bool).sum() == nz.sum()


def test_multiple_choice_fields_and_rows():
    f = gen.fields(M, dict(SHAPES, answer_len=6), MC, BIG)
    assert f["ans_mc"].shape == (40, 4, 6)
    assert (f["label"].sum(1) == 1).all()
    b = gen.batch(f, np.array([5, 9]), 2)
    r = gen.expand(b)
    assert r["q"].shape == (8, 12) and r["a"].shape == (8, 6)
    assert np.array_equal(r["ds_idx"], [5] * 4 + [9] * 4)
    assert np.array_equal(r["target"][:, 0], f["label"][[5, 9]].reshape(-1))
    assert np.array_equal(r["target"].sum(1), np.ones(8))


def test_streams():
    f = gen.fields(M, SHAPES, FF, BIG)
    s = gen.Stream(f, 7, 8, BIG, shuffle=True)
    batches = gen.first(s, 5)
    seen = np.concatenate([b["ds_idx"] for b in batches])
    assert len(set(seen.tolist())) == 40  # one pass: every question once
    again = gen.first(gen.Stream(f, 7, 8, BIG, shuffle=True), 5)
    assert all(np.array_equal(a["q"], b["q"]) for a, b in zip(batches, again))
    seq = gen.first(gen.Stream(f, 7, 16, BIG, shuffle=False), 3)
    at = seq[0]["ds_idx"][0]
    assert np.array_equal(np.concatenate([b["ds_idx"] for b in seq]),
                          (at + np.arange(48)) % 40)
    stop = gen.Stream(f, 7, 8, BIG, shuffle=True)
    it = iter(stop)
    next(it)
    stop.stop()
    assert list(it) == []


@pytest.mark.parametrize("layout", ["boxes", "grid"])
@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_store_layout(layout, dtype):
    wl = dict(images=9, max_boxes=6, store=dtype, questions=30)
    wl.update({"boxes": [2, 8]} if layout == "boxes" else {"grid": 6})
    t = store.make(wl, 16, BIG, "cpu")
    again = store.make(wl, 16, BIG, "cpu")
    assert torch.equal(t["feats"], again["feats"])
    n_rows = t["sentinel"]
    assert t["feats"].shape == (n_rows + 1, 16)
    assert not t["feats"][n_rows].any() and not t["spats"][n_rows].any()
    assert t["feats"].dtype == (torch.int8 if dtype == "int8" else torch.float32)
    assert (t["scales"] is not None) == (dtype == "int8")
    rows = t["rows_table"]
    assert rows.shape == (9, 6) and rows.dtype == np.int32
    assert rows.min() >= 0 and rows.max() <= n_rows
    real = rows != n_rows
    # each image's real slots come first and are consecutive rows
    for r, k in zip(rows, real.sum(1)):
        assert (r[:k] == r[0] + np.arange(k)).all()
    if layout == "grid":
        assert real.all() and not t["spats"].any()
    assert np.array_equal(np.bincount(t["sample_img"], minlength=9).clip(3, 4),
                          np.bincount(t["sample_img"], minlength=9))
