"""FFOE evaluation and inference export (``vqatpu/eval/ffoe.py:22-199``).

Reference: ``FFOE/test.py``: the batched no-grad logit sweep
(``get_logits``, ``:78-111``), the EvalAI submission JSON (``make_json``,
``:114-122``) and the CTI teacher-logits pkl (``make_json_with_logits``,
``:125-130``) that the knowledge-distillation loop reads.  File names and
formats are the JAX package's.

The sweeps run the model's eval step (:func:`vqatpu_torch.train.steps.
make_eval_step`) on the model's device; a batch is wire-cast on the host
(``transfer_dtype``) as JAX's ``_eval_batch`` does, or, with a
``dev_store`` (:class:`~vqatpu_torch.data.device_store.DeviceFeatureStore`)
and a ``fields_only`` loader, its ``v``/``b``/``v_mask`` are gathered on
the card from the batch's ``ds_idx``.  Padded rows (``valid`` False) never
count.  ``evaluate`` adds the scores on the card, in float64, and reads
them back once.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Tuple

import numpy as np
import torch

from vqatpu_torch.parallel.sharding import shard_batch
from vqatpu_torch.train.steps import make_eval_step, wire_cast

_EVAL_KEYS = ("v", "v_scale", "b", "q", "a", "v_mask", "target")


def _eval_batch(batch: dict, transfer_dtype: str, dev_store=None) -> dict:
    """The wire's fields, and the store's slabs gathered by ``ds_idx``."""
    ds_idx = batch.pop("ds_idx", None)
    db = wire_cast({k: v for k, v in batch.items() if k in _EVAL_KEYS},
                   transfer_dtype)
    if dev_store is not None:
        db.update(dev_store.gather(ds_idx))
    return db


def get_logits(model, loader, compute_dtype: str = "float32",
               transfer_dtype: str = "float32",
               dev_store=None) -> Tuple[np.ndarray, np.ndarray]:
    """Sweep the loader; -> (pred [N, num_ans] float32, qids [N])."""
    eval_step = make_eval_step(model, compute_dtype=compute_dtype)
    preds, qids = [], []
    for batch in loader:
        valid = batch.pop("valid")
        out = eval_step(_eval_batch(batch, transfer_dtype, dev_store))
        preds.append(out["logits"].cpu().numpy()[valid])
        qids.append(batch["qid"][valid])
    return np.concatenate(preds, 0), np.concatenate(qids, 0)


_warned_eval_fallback = False


def maybe_shard(batch: dict, mesh) -> Tuple[dict, bool]:
    """``_maybe_shard``'s rule (``vqatpu/eval/ffoe.py:57-80``): with several
    data indices, this rank's rows of an eval batch where the data axis
    divides it, else the whole batch (JAX's warning, once); -> (batch,
    split?)."""
    if mesh is None or mesh.dp == 1:
        return batch, False
    rows = len(next(iter(batch.values())))
    if rows % mesh.dp != 0:
        global _warned_eval_fallback
        if not _warned_eval_fallback:
            print(f"| WARNING: eval batch {rows} not divisible by the "
                  f"data-mesh size {mesh.dp}; evaluating without batch "
                  "sharding (slower on pods — pick a divisible eval batch)")
            _warned_eval_fallback = True
        return batch, False
    return shard_batch(batch, mesh), True


def evaluate(model, loader, compute_dtype: str = "float32",
             transfer_dtype: str = "float32",
             dev_store=None, mesh=None) -> Tuple[float, float]:
    """Soft accuracy and its upper bound over a val loader
    (``FFOE/train.py:119-149``), as fractions of the valid rows.  With a
    ``mesh`` of several data indices each rank scores its rows of a batch
    (:func:`maybe_shard`) and the sums are added over the data axis
    (``vqatpu/eval/ffoe.py:83-103``); every rank returns the totals."""
    eval_step = make_eval_step(model, compute_dtype=compute_dtype)
    dev = next(model.parameters()).device
    # [whole batches' score, upper bound, split batches' score, bound]
    sums = torch.zeros(4, dtype=torch.float64, device=dev)
    n = 0
    for batch in loader:
        n += int(batch["valid"].sum())
        batch, split = maybe_shard(batch, mesh)
        valid = batch.pop("valid")
        db = _eval_batch(batch, transfer_dtype, dev_store)
        # a padded row's target is zero already; masking by ``valid``, as
        # JAX does, keeps the sums exact for any loader
        db["target"] = np.where(valid[:, None], db["target"], 0.0).astype(
            np.float32)
        out = eval_step(db)
        at = 2 if split else 0
        sums[at] += out["score"].double()
        sums[at + 1] += out["upper_bound"].double()
    if mesh is not None:
        mesh.data.all_reduce(sums[2:])
    score, upper = (sums[:2] + sums[2:]).tolist()
    return score / max(n, 1), upper / max(n, 1)


def compute_score_with_embedding(pred_emb: np.ndarray, labels: np.ndarray,
                                 ans_emb: np.ndarray) -> np.ndarray:
    """Embedding-distance scoring (``FFOE/test.py:68-75``): predict the
    answer whose embedding is nearest (L2) to the model output, score it
    against the soft targets.  ``pred_emb [N, D]``, ``ans_emb [num_ans, D]``,
    ``labels [N, num_ans]`` -> per-sample soft scores [N]."""
    d = np.linalg.norm(pred_emb[:, None, :] - ans_emb[None, :, :], axis=2)
    pick = d.argmin(axis=1)
    return labels[np.arange(labels.shape[0]), pick]


def ensemble_logits(paths) -> Tuple[np.ndarray, np.ndarray]:
    """Average raw-logit dumps (``ffoe_test --logits``, ``.npz`` with
    ``logits`` and ``question_ids``) of N ensemble members -> (logits,
    qids).  Members are aligned by ``question_id``, so sweeps may order
    differently; mismatched question sets raise."""
    if not paths:
        raise ValueError("ensemble needs at least one logits dump")
    logit_sum = None
    ref_qids = None
    for p in paths:
        with np.load(p) as d:
            logits, qids = d["logits"], d["question_ids"]
        if np.unique(qids).size != qids.size:
            raise ValueError(
                f"{p}: duplicate question_ids in dump; members align by "
                "qid, so duplicates would average misaligned rows")
        order = np.argsort(qids, kind="stable")
        logits, qids = logits[order], qids[order]
        if ref_qids is None:
            ref_qids = qids
            logit_sum = logits.astype(np.float64)
        else:
            if not np.array_equal(qids, ref_qids):
                raise ValueError(
                    f"{p}: question_ids differ from {paths[0]}; ensemble "
                    "members must cover the same split")
            if logits.shape != logit_sum.shape:
                raise ValueError(
                    f"{p}: logits shape {logits.shape} != {logit_sum.shape}")
            logit_sum += logits
    return (logit_sum / len(paths)).astype(np.float32), ref_qids


def make_json(logits: np.ndarray, qids: np.ndarray, label2ans) -> list:
    """EvalAI format: [{question_id, answer}] (``test.py:114-122``)."""
    assert logits.shape[0] == len(qids)
    return [
        {"question_id": int(qids[i]), "answer": label2ans[int(logits[i].argmax())]}
        for i in range(logits.shape[0])
    ]


def make_json_with_logits(logits: np.ndarray, qids: np.ndarray) -> dict:
    """Teacher-logit dump {qid: float16 logits} (``test.py:125-130``), the
    input of ``VQAFeatureDataset(distillation=True)``."""
    assert logits.shape[0] == len(qids)
    return {int(qids[i]): logits[i].astype(np.float16)
            for i in range(logits.shape[0])}


def export_results(output_dir: str, split: str, model_name: str, op: str,
                   num_hid: int, epoch, logits: np.ndarray, qids: np.ndarray,
                   label2ans, dump_teacher_logits: bool = False) -> dict:
    """Write the reference's result artifacts (``test.py:177-187``):
    ``{split}_{model}{op}{num_hid}_epoch{epoch}.json`` and, with
    ``dump_teacher_logits``, ``cti_{split}_logits.pkl``."""
    os.makedirs(output_dir, exist_ok=True)
    paths = {}
    json_path = os.path.join(
        output_dir, f"{split}_{model_name}{op}{num_hid}_epoch{epoch}.json")
    with open(json_path, "w") as f:
        json.dump(make_json(logits, qids, label2ans), f)
    paths["json"] = json_path
    if dump_teacher_logits:
        pkl_path = os.path.join(output_dir, f"cti_{split}_logits.pkl")
        with open(pkl_path, "wb") as f:
            pickle.dump(make_json_with_logits(logits, qids), f)
        paths["teacher_logits"] = pkl_path
    return paths
