"""The multiple-choice TanModel (``MC/base_model.py``): the trilinear body
under ``v_att`` and a 2-way match head, one row per (question, candidate)."""

from __future__ import annotations

from benchmark.reference import trilinear

ATT = "v_att"
CANDIDATES = 4  # Visual7W's choices a question (Zhu et al., CVPR 2016)


def n_classes(m: dict) -> int:
    return 2


def leaves(m: dict):
    return trilinear.leaves(m, ATT, n_classes(m))


def forward(w, m: dict, v, q, a, v_mask, drop):
    return trilinear.forward(w, m, ATT, v, q, a, v_mask, drop)


def model_flop(m: dict, V: int, Q: int, A: int, train: bool) -> int:
    """Operations of one question: its four candidate rows."""
    return CANDIDATES * trilinear.model_flop(m, n_classes(m), V, Q, A, train)
