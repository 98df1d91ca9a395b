"""Soft-score targets (``vqatpu/tools/compute_softscore.py:17-99``,
reference ``tools/compute_softscore.py``): the answers kept by
min-occurrence, the ``ans2label``/``label2ans`` caches and each question's
soft targets.  Host only.

Run: ``python -m vqatpu_torch.tools.compute_softscore --dataroot data_vqa``
(``--min_occurence 9``).  It reads ``v2_mscoco_{train,val}2014_annotations
.json`` and writes ``{dataroot}/cache/trainval_ans2label.pkl``,
``trainval_label2ans.pkl`` (kept where the first exists already, as in
JAX), ``train_target.pkl`` and ``val_target.pkl``.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
from typing import Dict, List, Sequence

from vqatpu_torch.tools.vqa_normalize import get_score, preprocess_answer


def filter_answers(answers_dset: Sequence[dict],
                   min_occurence: int = 9) -> Dict[str, set]:
    """Answers that are the ground truth of at least ``min_occurence``
    distinct questions (``compute_softscore.py:139-157``)."""
    occurence: Dict[str, set] = {}
    for entry in answers_dset:
        gtruth = preprocess_answer(entry["multiple_choice_answer"])
        occurence.setdefault(gtruth, set()).add(entry["question_id"])
    return {a: qs for a, qs in occurence.items() if len(qs) >= min_occurence}


def _dump(obj, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def create_ans2label(occurence: Dict[str, set], name: str,
                     cache_root: str) -> Dict[str, int]:
    """Labels in ``occurence``'s order; writes ``{name}_ans2label.pkl`` and
    ``{name}_label2ans.pkl``."""
    label2ans: List[str] = list(occurence)
    ans2label = {a: i for i, a in enumerate(label2ans)}
    os.makedirs(cache_root, exist_ok=True)
    _dump(ans2label, os.path.join(cache_root, f"{name}_ans2label.pkl"))
    _dump(label2ans, os.path.join(cache_root, f"{name}_label2ans.pkl"))
    return ans2label


def compute_target(answers_dset: Sequence[dict], ans2label: Dict[str, int],
                   name: str, cache_root: str,
                   preprocessed: bool = False) -> List[dict]:
    """Per question, the labels of its annotators' answers that have one and
    their soft scores (``compute_softscore.py:184-218``); writes
    ``{name}_target.pkl``."""
    target = []
    for entry in answers_dset:
        counts: Dict[str, int] = {}
        for answer in entry["answers"]:
            a = (answer["answer"] if preprocessed
                 else preprocess_answer(answer["answer"]))
            counts[a] = counts.get(a, 0) + 1
        labels, scores = [], []
        for answer, n in counts.items():
            if answer in ans2label:
                labels.append(ans2label[answer])
                scores.append(get_score(n))
        target.append({"question_id": entry["question_id"],
                       "image_id": entry["image_id"],
                       "labels": labels, "scores": scores})
    os.makedirs(cache_root, exist_ok=True)
    _dump(target, os.path.join(cache_root, f"{name}_target.pkl"))
    return target


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataroot", default="data_vqa")
    parser.add_argument("--min_occurence", type=int, default=9)
    args = parser.parse_args(argv)

    annotations = []
    for split in ("train", "val"):
        path = os.path.join(args.dataroot,
                            f"v2_mscoco_{split}2014_annotations.json")
        with open(path) as f:
            annotations.append(json.load(f)["annotations"])
    train_answers, val_answers = annotations

    cache_root = os.path.join(args.dataroot, "cache")
    occurence = filter_answers(train_answers + val_answers, args.min_occurence)
    print(f"Num of answers that appear >= {args.min_occurence} times: "
          f"{len(occurence)}")
    cache_path = os.path.join(cache_root, "trainval_ans2label.pkl")
    if os.path.isfile(cache_path):
        with open(cache_path, "rb") as f:
            ans2label = pickle.load(f)
    else:
        ans2label = create_ans2label(occurence, "trainval", cache_root)
    compute_target(train_answers, ans2label, "train", cache_root)
    compute_target(val_answers, ans2label, "val", cache_root)


if __name__ == "__main__":
    main()
