"""The Visual7W multiple-choice dataset, a copy of ``vqatpu.data.
mc_dataset`` (``vqatpu/data/mc_dataset.py:21-169``, reference
``src/MC/dataset.py``), so that a sample's every field is bit-equal to the
JAX package's.

Each question has 4 candidate answers and its ground truth from
``answer_{split}.json`` (``MC/dataset.py:98-118, 135-137``); questions are
12 tokens and answers 6, both tokenized with the MC tokenizer, which also
strips ``'.'`` (``MC/dataset.py:49``).  ``use_feature="grid"`` takes the
196 fixed grid cells of ``v7w/{split}`` with zero spatials
(``MC/dataset.py:150-158``).

:func:`expand_mc_batch` turns a batch of questions into the model's batch
of ``4 x`` candidate rows with 2-class ``[match, non-match]`` targets
(``MC/train.py:74-83``).
"""

from __future__ import annotations

import json
import os
import pickle
from typing import List

import numpy as np

from vqatpu_torch.data.dictionary import Dictionary
from vqatpu_torch.data.features import FeatureStore, ZeroArray
from vqatpu_torch.train.profiling import span

MC_QUESTION_LEN = 12
MC_ANS_LEN = 6  # MC/dataset.py:189
NUM_CANDIDATES = 4


def _load_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def load_v7w_entries(dataroot: str, name: str, img_id2idx: dict,
                     ans_candidates: dict) -> List[dict]:
    """One entry per question of ``v7w_{name}_questions.json``, in
    question-id order, with its candidates, their 0/1 labels and the
    ground-truth answer."""
    with open(os.path.join(dataroot, f"v7w_{name}_questions.json")) as f:
        questions = sorted(json.load(f)["questions"],
                           key=lambda x: x["question_id"])
    entries = []
    for question in questions:
        cand = ans_candidates[str(question["question_id"])]
        entries.append({
            "question_id": question["question_id"],
            "image_id": question["image_id"],
            "image": img_id2idx[question["image_id"]],
            "question": question["question"],
            "label": cand["label"],
            "ans_gt": cand["ans_gt"],
            "ans_mc": cand["mc"],
        })
    return entries


class V7WDataset:
    def __init__(self, name: str, dictionary: Dictionary,
                 dataroot: str = "data_v7w", max_boxes: int = 50,
                 question_len: int = MC_QUESTION_LEN, adaptive: bool = True,
                 use_feature: str = "bottom-up",
                 features_in_memory: bool = True,
                 quantize_features: bool = False):
        if name not in ("train", "val", "test"):
            raise ValueError(f"unknown Visual7W split {name!r}")
        self.dictionary = dictionary
        self.max_boxes = max_boxes
        self.adaptive = adaptive

        with open(os.path.join(dataroot, f"answer_{name}.json")) as f:
            self.answer_candidates = json.load(f)
        self.ans2label = _load_pickle(
            os.path.join(dataroot, "cache", "trainval_ans2label.pkl"))
        self.label2ans = _load_pickle(
            os.path.join(dataroot, "cache", "trainval_label2ans.pkl"))
        self.num_ans_candidates = len(self.ans2label)

        suffix = "" if adaptive else "36"
        if use_feature == "grid":
            # 196 fixed grid cells, zero spatials (MC/dataset.py:150-158)
            self.adaptive = False
            self.img_id2idx = _load_pickle(
                os.path.join(dataroot, "v7w", f"{name}_imgid2idx.pkl"))
            feat_base = os.path.join(dataroot, "v7w", name)
        else:
            self.img_id2idx = _load_pickle(
                os.path.join(dataroot, f"{name}{suffix}_imgid2idx.pkl"))
            feat_base = os.path.join(dataroot, f"{name}{suffix}")
        if os.path.exists(feat_base + ".hdf5"):
            self.store = FeatureStore.from_hdf5(feat_base + ".hdf5",
                                                adaptive=self.adaptive,
                                                in_memory=features_in_memory,
                                                quantize=quantize_features)
        else:
            self.store = FeatureStore.from_npz(feat_base + ".npz")
            if quantize_features:
                self.store = self.store.quantize()
        if use_feature == "grid":
            # zero spatials of the features' shape, as JAX's; a streaming
            # store gets a lazy stand-in rather than a features-sized block
            # (float32 over an int8-resident store too)
            self.store.spatials = (
                np.zeros(self.store.features.shape, np.float32)
                if self.store.in_memory
                else ZeroArray(self.store.features.shape))

        self.entries = load_v7w_entries(dataroot, name, self.img_id2idx,
                                        self.answer_candidates)
        for e in self.entries:
            e["q_token"] = np.asarray(
                dictionary.tokenize_padded(e["question"], question_len,
                                           strip_period=True), np.int32)
            e["ans_gt_token"] = np.asarray(
                dictionary.tokenize_padded(e["ans_gt"], MC_ANS_LEN,
                                           strip_period=True), np.int32)
            e["ans_mc_token"] = np.asarray(
                [dictionary.tokenize_padded(a, MC_ANS_LEN, strip_period=True)
                 for a in e["ans_mc"]], np.int32)

    @property
    def v_dim(self) -> int:
        return self.store.v_dim

    @property
    def s_dim(self) -> int:
        return self.store.s_dim

    def sample_fields(self, index: int) -> dict:
        """The fields without the features: ``q``, ``label`` [4] 0/1 per
        candidate, ``ans_mc`` [4, 6], ``ans_gt`` [6] and ``qid``."""
        e = self.entries[index]
        return {
            "q": e["q_token"],
            "label": np.asarray(e["label"], np.float32),
            "ans_mc": e["ans_mc_token"],
            "ans_gt": e["ans_gt_token"],
            "qid": np.int64(e["question_id"]),
        }

    def sample(self, index: int) -> dict:
        out = self.sample_fields(index)
        feats, spats, mask = self.store.get(self.entries[index]["image"],
                                            self.max_boxes)
        out.update(v=feats, b=spats, v_mask=mask)
        return out

    def __len__(self) -> int:
        return len(self.entries)


def expand_mc_batch(batch: dict) -> dict:
    """The ``x4`` candidate expansion (``MC/train.py:74-83``) on the host:
    ``q``, ``qid`` and the feature slabs (``v``, ``b``, ``v_mask``,
    ``v_scale``) repeat once per candidate, ``ans_mc`` [B, 4, 6] flattens
    to ``a`` [4B, 6], and ``target`` is ``[label, 1 - label]`` [4B, 2].  A
    ``fields_only`` batch (the card-resident store's wire) repeats its
    ``ds_idx`` instead, so that the store's gather gives the expanded slabs
    directly.  A ``feed.expand`` span (:mod:`vqatpu_torch.train.
    profiling`)."""
    with span("feed.expand"):
        B = batch["q"].shape[0]
        n = NUM_CANDIDATES

        def tile(x):
            return np.repeat(x[:, None], n, axis=1).reshape(
                (B * n,) + x.shape[1:])

        a = batch["label"].reshape(B * n, 1)
        out = {
            "q": tile(batch["q"]),
            "a": batch["ans_mc"].reshape(B * n, -1),
            "target": np.concatenate([a, 1.0 - a], axis=1).astype(np.float32),
            "qid": tile(batch["qid"]),
        }
        for k in ("v", "b", "v_mask", "v_scale", "ds_idx"):
            if k in batch:
                out[k] = tile(batch[k])
        return out
