"""The comparison that decides ``correct``: the numbers read from the
program's timed path against the plain reference's, each held to the
limit its cell's workload file states (``limits``), set from measured
readings (``PERF.md``).

Training (the steps before the window, through the window's own call):

- ``loss_gap``: the largest ``|L - L_ref| / |L_ref|`` of the losses of
  the microbatches before the first update (the later ones move with
  Adamax's steps of ``lr`` on gradients that round-off sets the sign of,
  by up to 2.7e-4 on a few seeds: ``PERF.md``);
- ``grad_gap``: each leaf's norm of the first update's gradient as Adamax
  takes it (the program's worked out from its first moment, ``m / (1 -
  b1)``), the worst leaf's ``|n - n_ref|``, over the larger of the leaf's
  reference norm and the median leaf's;
- ``change_gap``: the same for each leaf's change after the last check
  update, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (they move by round-off alone).

The logits sweep (a sample of the window's batches drawn from the seed):

- ``logit_gap``: the largest ``|logit - logit_ref|`` over the largest
  ``|logit_ref|`` of the sample;
- ``rows_misplaced``: rows whose question id is not the one asked for
  (exact: limit 0).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

SILENT_LEAF = 1e-3  # of the median leaf's reference gradient


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
              keep=None) -> Tuple[float, str]:
    names = [n for n in ref if keep is None or keep[n]]
    r = np.array([ref[n] for n in names], np.float64)
    p = np.array([prog.get(n, np.inf) for n in names], np.float64)
    scale = np.maximum(r, np.median(r))
    gaps = np.abs(p - r) / scale
    i = int(np.argmax(gaps))
    return float(gaps[i]), names[i]


def train_readings(prog: dict, ref: dict, first: int) -> Dict[str, float]:
    """``prog``: ``losses`` (a sequence) and ``grad``/``change`` ({leaf:
    norm}); ``ref``: :func:`benchmark.reference.train.train`'s result;
    ``first``: the microbatches before the first update, whose losses are
    compared."""
    names = ref["names"]
    rl = np.asarray(ref["losses"], np.float64)
    pl = np.asarray(prog["losses"], np.float64)
    if pl.shape != rl.shape:
        return {"loss_gap": float("inf"), "grad_gap": float("inf"),
                "change_gap": float("inf")}
    rg = dict(zip(names, np.asarray(ref["grad"], np.float64)))
    rc = dict(zip(names, np.asarray(ref["change"], np.float64)))
    floor = SILENT_LEAF * float(np.median(list(rg.values())))
    keep = {n: rg[n] >= floor for n in names}
    grad_gap, grad_leaf = _leaf_gap(prog["grad"], rg)
    change_gap, change_leaf = _leaf_gap(prog["change"], rc, keep)
    gaps = np.abs(pl - rl) / np.abs(rl)
    return {"loss_gap": float(np.max(gaps[:first])),
            "grad_gap": grad_gap, "change_gap": change_gap,
            "_loss_gaps": [float(x) for x in gaps],
            "_grad_leaf": grad_leaf, "_change_leaf": change_leaf,
            "_silent_leaves": sorted(n for n in names if not keep[n])}


def logit_readings(prog: List[np.ndarray], ref: List[np.ndarray],
                   qids: List[np.ndarray],
                   asked: List[np.ndarray]) -> Dict[str, float]:
    p = np.concatenate(prog).astype(np.float64)
    r = np.concatenate(ref).astype(np.float64)
    if p.shape != r.shape:
        return {"logit_gap": float("inf"), "rows_misplaced": float(len(r))}
    return {"logit_gap": float(np.max(np.abs(p - r)) / np.max(np.abs(r))),
            "rows_misplaced": float(np.sum(np.concatenate(qids)
                                           != np.concatenate(asked)))}


def judge(readings: Dict[str, float],
          limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """-> (every compared number within its limit, ``{name: {"value",
    "limit"}}``).  A number with no limit, or not finite, fails."""
    checks, ok = {}, True
    for name, value in readings.items():
        if name.startswith("_"):
            continue
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if limit is None or not np.isfinite(value) or value > limit:
            ok = False
    return ok, checks
