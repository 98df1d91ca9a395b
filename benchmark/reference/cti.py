"""The free-form CTI model (``FFOE/base_model.py``): the trilinear body
under ``t_att`` and a head over the answer vocabulary."""

from __future__ import annotations

from benchmark.reference import trilinear

ATT = "t_att"


def n_classes(m: dict) -> int:
    return m["num_ans_candidates"]


def leaves(m: dict):
    return trilinear.leaves(m, ATT, n_classes(m))


def forward(w, m: dict, v, q, a, v_mask, drop):
    return trilinear.forward(w, m, ATT, v, q, a, v_mask, drop)


def model_flop(m: dict, V: int, Q: int, A: int, train: bool) -> int:
    """Operations of one question (one row)."""
    return trilinear.model_flop(m, n_classes(m), V, Q, A, train)
