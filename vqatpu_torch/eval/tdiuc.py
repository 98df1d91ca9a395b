"""TDIUC per-question-type metrics, a copy of ``vqatpu.eval.tdiuc``
(``vqatpu/eval/tdiuc.py:18-104``): the arithmetic and harmonic mean per
question type (MPT), with and without per-answer normalization.

Reference: ``src/evaluate_TDIUC.py``, an offline script over a predictions
JSON (EvalAI format), the ground-truth annotations and an answerkey CSV
mapping answer string -> index.  The metrics come back as a dict;
:func:`format_report` gives the script's printed summary.
"""

from __future__ import annotations

import csv
import json
from collections import defaultdict
from typing import Dict, List, Sequence


def load_answerkey(path: str) -> Dict[str, int]:
    with open(path) as f:
        return {rows[0]: int(rows[1]) for rows in csv.reader(f)}


def align_predictions(pred_json_path: str, gt_ann: Sequence[dict],
                      answerkey: Dict[str, int]) -> List[int]:
    """Order predictions by the ground-truth annotation order
    (``evaluate_TDIUC.py:9-24``)."""
    with open(pred_json_path) as f:
        preds = {p["question_id"]: p["answer"] for p in json.load(f)}
    return [int(answerkey[preds[a["question_id"]]]) for a in gt_ann]


def _hmean(xs: Sequence[float]) -> float:
    return len(xs) / sum(1.0 / x for x in xs)


def mean_per_type(predictions: Sequence[int], gt_ann: Sequence[dict],
                  answerkey: Dict[str, int]) -> dict:
    """Port of ``mean_per_class`` (``evaluate_TDIUC.py:26-94``)."""
    res = defaultdict(list)
    gt_answers_idx = []
    notfound = 0
    for idx, pred in enumerate(predictions):
        gt_answer = gt_ann[idx]["answers"][0]["answer"]
        gt_type = gt_ann[idx]["question_type"]
        res[gt_type + "_pred"].append(pred)
        if gt_answer in answerkey:
            gt_idx = int(answerkey[gt_answer])
            res[gt_type + "_gt"].append(gt_idx)
            gt_answers_idx.append(gt_idx)
            res[gt_type + ("_t" if gt_idx == pred else "_f")].append(pred)
        else:
            gt_answers_idx.append(-1)
            res[gt_type + "_f"].append(pred)
            res[gt_type + "_gt"].append(-1)
            notfound += 1

    types = sorted({a["question_type"] for a in gt_ann})
    eps = 1e-10
    out = {"notfound": notfound, "types": {}}

    # without per-answer normalization
    accs = []
    for tp in types:
        acc = 100.0 * len(res[tp + "_t"]) / len(res[tp + "_t"] + res[tp + "_f"])
        accs.append(acc + eps)
        out["types"][tp] = acc
    out["arithmetic_mpt"] = sum(accs) / len(accs)
    out["harmonic_mpt"] = _hmean(accs)
    matches = [int(p == g) for p, g in zip(predictions, gt_answers_idx)]
    out["overall"] = 100.0 * sum(matches) / len(matches)

    # with per-answer normalization
    accs_n = []
    out["types_norm"] = {}
    for tp in types:
        per_ans = defaultdict(int)
        for g, p in zip(res[tp + "_gt"], res[tp + "_pred"]):
            per_ans[f"{g}_gt"] += 1
            if g == p:
                per_ans[str(g)] += 1
        uniq = set(res[tp + "_gt"])
        unq_acc = sum(per_ans[str(u)] / per_ans[f"{u}_gt"] for u in uniq)
        acc = 100.0 * unq_acc / len(uniq)
        accs_n.append(acc + eps)
        out["types_norm"][tp] = acc
    out["arithmetic_mpt_norm"] = sum(accs_n) / len(accs_n)
    out["harmonic_mpt_norm"] = _hmean(accs_n)
    return out


def format_report(metrics: dict) -> str:
    lines = [f"{metrics['notfound']} of validation answers were not in the answerkey",
             "", "NOT USING PER-ANSWER NORMALIZATION", ""]
    for tp, acc in metrics["types"].items():
        lines.append(f"Accuracy for {tp} is {acc:.2f}")
    lines.append(f"Arithmetic MPT Accuracy is {metrics['arithmetic_mpt']:.2f}")
    lines.append(f"Harmonic MPT Accuracy is {metrics['harmonic_mpt']:.2f}")
    lines.append(f"Overall Traditional Accuracy is {metrics['overall']:.2f}")
    lines += ["", "USING PER-ANSWER NORMALIZATION", ""]
    for tp, acc in metrics["types_norm"].items():
        lines.append(f"Accuracy for {tp} is {acc:.2f}")
    lines.append(f"Arithmetic MPT Accuracy is {metrics['arithmetic_mpt_norm']:.2f}")
    lines.append(f"Harmonic MPT Accuracy is {metrics['harmonic_mpt_norm']:.2f}")
    return "\n".join(lines)
