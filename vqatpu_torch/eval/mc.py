"""Multiple-choice (Visual7W) scoring and evaluation (``vqatpu/eval/mc.py:
20-91``, reference ``MC/train.py:14-19`` and ``MC/test.py``).

The logits come from the ``x4``-expanded batch: in each group of 4
candidate rows the argmax of the class-0 ("match") probability picks the
candidate, and the score is that candidate's label.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from vqatpu_torch.data.mc_dataset import NUM_CANDIDATES, expand_mc_batch
from vqatpu_torch.eval.ffoe import maybe_shard
from vqatpu_torch.train.steps import make_eval_step, wire_cast

_EVAL_KEYS = ("v", "v_scale", "b", "q", "a")


def compute_score_mc(logits: np.ndarray, labels: np.ndarray) -> float:
    """``logits`` [4B, 2], ``labels`` [4B, 2] -> the number of correct
    picks.  Softmax is monotone, so the argmax of the class-0 probability
    in a group is the argmax of ``logit0 - logit1``."""
    groups = logits.shape[0] // NUM_CANDIDATES
    margin = logits[:, 0] - logits[:, 1]
    pick = margin.reshape(groups, NUM_CANDIDATES).argmax(1)
    return float(labels[:, 0].reshape(groups, NUM_CANDIDATES)[
        np.arange(groups), pick].sum())


def compute_score_with_emb(pred_emb: np.ndarray, mc_emb: np.ndarray,
                           gt_emb: np.ndarray) -> np.ndarray:
    """Embedding-space scoring (``MC/trainer.py:302-312``): pick the
    candidate whose embedding is nearest (L2) to the prediction; correct
    where it equals the ground truth's.  ``pred_emb`` [B, D], ``mc_emb``
    [B, 4, D], ``gt_emb`` [B, D] -> bool [B].

    The equality test is the reference's ``(chosen - gt).sum() == 0``, as
    JAX keeps it: two vectors whose coordinates differ but sum to the same
    total count as equal."""
    d = np.linalg.norm(pred_emb[:, None, :] - mc_emb, axis=2)  # [B, 4]
    pick = d.argmin(axis=1)
    chosen = mc_emb[np.arange(mc_emb.shape[0]), pick]
    return (chosen - gt_emb).sum(axis=1) == 0


def evaluate_mc(model, loader, compute_dtype: str = "float32",
                transfer_dtype: str = "float32",
                dev_store=None, mesh=None) -> Tuple[float, float]:
    """-> (accuracy over the loader's valid questions, upper bound 1.0),
    with training's ``x4`` expansion (``MC/test.py:89-126``).  Padded
    questions (``valid`` False) are not scored.

    With ``dev_store`` (a :class:`~vqatpu_torch.data.device_store.
    DeviceFeatureStore`; the loader is then ``fields_only``) the expanded
    slabs are gathered on the card by the repeated ``ds_idx``.  The
    gathered ``v_mask`` is dropped, as JAX drops it: neither path ships a
    mask, the model takes the boxes whose features are not all zero, and
    the sentinel rows gather to exact zeros, so the logits are the wire
    path's.

    With a ``mesh`` of several data indices each rank scores its rows of
    the questions, where the data axis divides them
    (:func:`vqatpu_torch.eval.ffoe.maybe_shard`, before the expansion, so
    that a rank holds whole groups of 4), and the counts are added over
    the data axis (``vqatpu/eval/mc.py:47-80``)."""
    eval_step = make_eval_step(model, compute_dtype=compute_dtype)
    scores = np.zeros(2)  # whole batches', split batches'
    n = 0
    for batch in loader:
        n += int(batch["valid"].sum())
        batch, split = maybe_shard(batch, mesh)
        valid = batch.pop("valid")
        ex = expand_mc_batch(batch)
        ds_idx = ex.pop("ds_idx", None)
        db = wire_cast({k: ex[k] for k in _EVAL_KEYS if k in ex},
                       transfer_dtype)
        if dev_store is not None:
            g = dev_store.gather(ds_idx)
            db.update({k: g[k] for k in ("v", "v_scale", "b") if k in g})
        logits = eval_step(db)["logits"].cpu().numpy()
        rows = np.repeat(valid, NUM_CANDIDATES)
        if rows.any():
            scores[int(split)] += compute_score_mc(logits[rows],
                                                   ex["target"][rows])
    score = float(scores[0])
    if mesh is not None:
        split = torch.tensor(scores[1], dtype=torch.float64,
                             device=next(model.parameters()).device)
        score += float(mesh.data.all_reduce(split))
    return score / max(n, 1), 1.0
