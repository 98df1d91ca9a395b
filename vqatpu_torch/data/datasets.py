"""FFOE datasets: VQA-2.0, TDIUC, VisualGenome augmentation; a copy of
``vqatpu.data.datasets`` (``vqatpu/data/datasets.py:35-435``), so that a
sample's every field is bit-equal to the JAX package's.

Reference: the original ``FFOE/dataset.py``.  Artifact layout on disk is
identical to the reference (pickle caches, HDF5 or ``.npz`` features,
question JSONs) so preprocessed reference data drops in unchanged.

Deliberate divergences from reference bugs (SURVEY.md §7 "do NOT reproduce"):
- no ``questions[:10000]`` train/val truncation (``dataset.py:131-132``);
- the test2015 path builds complete entries (``:152`` passed 4 of 5 args);
- the TDIUC loader builds complete entries too (``:183`` also passes 4 of
  5 args to ``_create_entry`` — every reference TDIUC run crashes at
  dataset construction; pinned live in tests/test_dataset_oracle.py);
- ``name == 'train'`` instead of the ``is`` identity compare (``:390``).

Samples are plain numpy dicts with *static* shapes (boxes padded to
``max_boxes`` with a validity mask); see :mod:`vqatpu_torch.data.batching`.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, List, Optional

import numpy as np

from vqatpu_torch.data.dictionary import Dictionary
from vqatpu_torch.data.features import FeatureStore

QUESTION_LEN = 12  # FFOE/main.py:47
ANS_LEN = 3  # FFOE/dataset.py:311


def _load_pickle(path: str):
    with open(path, "rb") as f:
        return pickle.load(f)


def _make_entry(image: int, question: dict, answer: Optional[dict],
                ans: Optional[str], teacher_logit) -> dict:
    return {
        "question_id": question["question_id"],
        "image_id": question["image_id"],
        "image": image,
        "question": question["question"],
        "answer": answer,
        "ans": ans if ans is not None else "",
        "teacher_logit": teacher_logit,
    }


def load_vqa_entries(dataroot: str, name: str, img_id2idx: dict,
                     label2ans: list, teacher_logits: dict) -> List[dict]:
    """VQA-2.0 entries (``_load_dataset``, ``FFOE/dataset.py:108-155``)."""
    suffix = name + "2014" if name[:4] != "test" else name
    question_path = os.path.join(
        dataroot, f"v2_OpenEnded_mscoco_{suffix}_questions.json")
    with open(question_path) as f:
        questions = sorted(json.load(f)["questions"], key=lambda x: x["question_id"])
    entries = []
    if name[:4] != "test":
        answers = _load_pickle(os.path.join(dataroot, "cache", f"{name}_target.pkl"))
        answers = sorted(answers, key=lambda x: x["question_id"])
        assert len(questions) == len(answers), (len(questions), len(answers))
        for question, answer in zip(questions, answers):
            assert question["question_id"] == answer["question_id"]
            assert question["image_id"] == answer["image_id"]
            # argmax answer string feeds the CTI answer stream (dataset.py:137-141)
            if answer["scores"]:
                ans = label2ans[answer["labels"][int(np.argmax(answer["scores"]))]]
            else:
                ans = ""
            t_logit = teacher_logits.get(question["question_id"]) if teacher_logits else None
            entries.append(_make_entry(img_id2idx[question["image_id"]],
                                       question, answer, ans, t_logit))
    else:
        for question in questions:
            entries.append(_make_entry(img_id2idx[question["image_id"]],
                                       question, None, None, None))
    return entries


def load_tdiuc_entries(dataroot: str, name: str, img_id2idx: dict,
                       teacher_logits: dict) -> List[dict]:
    """TDIUC entries (``_load_TDIUC_dataset``, ``FFOE/dataset.py:157-187``)."""
    with open(os.path.join(dataroot, f"TDIUC_{name}_questions.json")) as f:
        questions = sorted(json.load(f)["questions"], key=lambda x: x["question_id"])
    answers = _load_pickle(os.path.join(dataroot, "cache", f"{name}_target.pkl"))
    answers = sorted(answers, key=lambda x: x["question_id"])
    assert len(questions) == len(answers)
    entries = []
    for question, answer in zip(questions, answers):
        assert question["question_id"] == answer["question_id"]
        assert question["image_id"] == answer["image_id"]
        t_logit = teacher_logits.get(question["question_id"]) if teacher_logits else None
        entries.append(_make_entry(img_id2idx[question["image_id"]],
                                   question, answer, None, t_logit))
    return entries


class _FeatureDatasetBase:
    """Shared plumbing: feature store, target scatter, static samples."""

    def __init__(self, dataroot: str, name: str, dictionary: Dictionary,
                 max_boxes: int, adaptive: bool, fixed36_suffix: bool = True,
                 features_in_memory: bool = True,
                 quantize_features: bool = False):
        self.name = name
        self.dataroot = dataroot
        self.dictionary = dictionary
        self.max_boxes = max_boxes
        self.adaptive = adaptive
        suffix = "" if adaptive else ("36" if fixed36_suffix else "")
        self.img_id2idx = _load_pickle(
            os.path.join(dataroot, f"{name}{suffix}_imgid2idx.pkl"))
        h5_path = os.path.join(dataroot, f"{name}{suffix}.hdf5")
        npz_path = os.path.join(dataroot, f"{name}{suffix}.npz")
        if os.path.exists(h5_path):
            # features_in_memory=False streams per-image slices from the open
            # HDF5 instead of the reference's whole-file read
            # (FFOE/dataset.py:282-287) — low-RAM hosts can train.
            # quantize_features keeps the resident features int8 (4x RAM
            # cut, loaded chunk-wise; see FeatureStore.from_hdf5)
            self.store = FeatureStore.from_hdf5(h5_path, adaptive=adaptive,
                                                in_memory=features_in_memory,
                                                quantize=quantize_features)
        else:
            self.store = FeatureStore.from_npz(npz_path)
            if quantize_features:
                self.store = self.store.quantize()
        self.ans2label = _load_pickle(
            os.path.join(dataroot, "cache", "trainval_ans2label.pkl"))
        self.label2ans = _load_pickle(
            os.path.join(dataroot, "cache", "trainval_label2ans.pkl"))
        self.num_ans_candidates = len(self.ans2label)

    @property
    def v_dim(self) -> int:
        return self.store.v_dim

    @property
    def s_dim(self) -> int:
        return self.store.s_dim

    def _target(self, answer: Optional[dict]) -> np.ndarray:
        target = np.zeros((self.num_ans_candidates,), np.float32)
        if answer is not None and answer.get("labels") is not None:
            labels = np.asarray(answer["labels"], np.int64)
            scores = np.asarray(answer["scores"], np.float32)
            if labels.size:
                target[labels] = scores
        return target

    def _target_sparse(self, answer: Optional[dict], k: int):
        """Sparse form of :meth:`_target` straight from the entry (the
        [num_ans]-wide zeros+scatter never happens): ``(t_label [k] int32,
        t_score [k] f32)``, zero-padded.  Densifying on device
        (:func:`vqatpu_torch.train.steps.densify_target`, add semantics) reproduces
        ``_target`` bit-exactly because softscore labels are unique per
        question (``tools/compute_softscore`` builds them from distinct
        answer strings; duplicates would make add diverge from _target's
        last-wins scatter; guarded in ``batching.max_target_labels``)."""
        lab = np.zeros((k,), np.int32)
        sc = np.zeros((k,), np.float32)
        if answer is not None and answer.get("labels") is not None:
            labels = np.asarray(answer["labels"], np.int64)
            if labels.size:
                lab[:labels.size] = labels
                sc[:labels.size] = np.asarray(answer["scores"], np.float32)
        return lab, sc

    def sample_fields(self, index: int) -> dict:
        """Everything except the feature slabs (v/b/v_mask): the fields of
        a ``fields_only`` batch, which never touch the store."""
        e = self.entries[index]
        out = self._fields_common(e)
        out["target"] = self._target(e["answer"])
        return out

    def sample_fields_sparse(self, index: int, k: int) -> dict:
        """Like :meth:`sample_fields` but with the target in sparse form —
        the [num_ans]-wide host densify never runs (the device-feature-store
        loader's wire, ``BatchLoader(fields_only=True, sparse_target_k=k)``)."""
        e = self.entries[index]
        out = self._fields_common(e)
        out["t_label"], out["t_score"] = self._target_sparse(e["answer"], k)
        return out

    def __len__(self) -> int:
        return len(self.entries)


class VQAFeatureDataset(_FeatureDatasetBase):
    """``VQAFeatureDataset`` (``FFOE/dataset.py:258-379``)."""

    def __init__(self, name: str, dictionary: Dictionary,
                 dataroot: str = "data_vqa", max_boxes: int = 50,
                 question_len: int = QUESTION_LEN, adaptive: bool = True,
                 distillation: bool = False, features_in_memory: bool = True,
                 quantize_features: bool = False):
        assert name in ("train", "val", "test2015", "test-dev2015")
        super().__init__(dataroot, name, dictionary, max_boxes, adaptive,
                         features_in_memory=features_in_memory,
                         quantize_features=quantize_features)
        self.teacher_logits: Dict = {}
        if distillation:
            self.teacher_logits = _load_pickle(
                os.path.join(dataroot, f"{name}_teacher_logits.pkl"))
        self.entries = load_vqa_entries(dataroot, name, self.img_id2idx,
                                        self.label2ans, self.teacher_logits)
        for e in self.entries:
            e["q_token"] = np.asarray(
                dictionary.tokenize_padded(e["question"], question_len), np.int32)
            e["ans_token"] = np.asarray(
                dictionary.tokenize_padded(e["ans"], ANS_LEN), np.int32)

    def _fields_common(self, e: dict) -> dict:
        out = {
            "q": e["q_token"],
            "a": e["ans_token"],
            "qid": np.int64(e["question_id"]),
        }
        if self.teacher_logits:
            out["t_logits"] = np.asarray(e["teacher_logit"], np.float32)
        return out

    def sample(self, index: int) -> dict:
        out = self.sample_fields(index)
        feats, spats, mask = self.store.get(self.entries[index]["image"],
                                            self.max_boxes)
        out.update(v=feats, b=spats, v_mask=mask)
        return out


class TDIUCFeatureDataset(_FeatureDatasetBase):
    """``TDIUCFeatureDataset`` (``FFOE/dataset.py:382-480``). TDIUC has no
    answer stream; ``a`` is all-padding so CTI can still run."""

    def __init__(self, name: str, dictionary: Dictionary,
                 dataroot: str = "data_TDIUC", max_boxes: int = 50,
                 question_len: int = QUESTION_LEN, adaptive: bool = True,
                 distillation: bool = False, features_in_memory: bool = True,
                 quantize_features: bool = False):
        assert name in ("train", "val")
        super().__init__(dataroot, name, dictionary, max_boxes, adaptive,
                         features_in_memory=features_in_memory,
                         quantize_features=quantize_features)
        self.teacher_logits: Dict = {}
        if distillation and name == "train":
            self.teacher_logits = _load_pickle(
                os.path.join(dataroot, f"{name}_teacher_logits.pkl"))
        self.entries = load_tdiuc_entries(dataroot, name, self.img_id2idx,
                                          self.teacher_logits)
        pad = [dictionary.padding_idx] * ANS_LEN
        for e in self.entries:
            e["q_token"] = np.asarray(
                dictionary.tokenize_padded(e["question"], question_len), np.int32)
            e["ans_token"] = np.asarray(pad, np.int32)

    def _fields_common(self, e: dict) -> dict:
        out = {
            "q": e["q_token"],
            "a": e["ans_token"],
            "qid": np.int64(e["question_id"]),
        }
        if self.teacher_logits:
            out["t_logits"] = np.asarray(e["teacher_logit"], np.float32)
        return out

    def sample(self, index: int) -> dict:
        out = self.sample_fields(index)
        feats, spats, mask = self.store.get(self.entries[index]["image"],
                                            self.max_boxes)
        out.update(v=feats, b=spats, v_mask=mask)
        return out


def build_visualgenome_entries(dataroot: str, name: str, img_id2idx: dict,
                               ans2label: dict, adaptive: bool = True
                               ) -> List[dict]:
    """Build VG augmentation entries from the raw ``question_answers.json``
    + ``image_data.json`` dumps, caching to ``cache/vg_{name}_target.pkl``
    (``_load_visualgenome``, ``FFOE/dataset.py:189-249``).  Keeps only VG
    questions whose COCO image is in this split and whose normalized answer
    is in the answer vocabulary (score 1.0)."""
    from vqatpu_torch.tools.vqa_normalize import preprocess_answer

    cache_path = os.path.join(
        dataroot, "cache", f"vg_{name}{'_adaptive' if adaptive else ''}_target.pkl")
    if os.path.isfile(cache_path):
        return _load_pickle(cache_path)

    with open(os.path.join(dataroot, "question_answers.json")) as f:
        vgq = json.load(f)
    with open(os.path.join(dataroot, "image_data.json")) as f:
        image_data = json.load(f)
    vg_to_coco = {v["image_id"]: v["coco_id"] for v in image_data
                  if v.get("coco_id") is not None}

    entries = []
    for vg in vgq:
        coco_id = vg_to_coco.get(vg["id"])
        if coco_id is None:
            continue
        img_idx = img_id2idx.get(coco_id)
        if img_idx is None:
            continue
        for q in vg["qas"]:
            label = ans2label.get(preprocess_answer(q["answer"]))
            if label is None:
                continue
            entries.append({
                "question_id": q["qa_id"],
                "image_id": coco_id,
                "image": img_idx,
                "question": q["question"],
                "answer": {"labels": [label], "scores": [1.0]},
            })
    os.makedirs(os.path.dirname(cache_path), exist_ok=True)
    with open(cache_path, "wb") as f:
        pickle.dump(entries, f)
    return entries


class VisualGenomeFeatureDataset:
    """VG question augmentation sharing an existing feature store
    (``FFOE/dataset.py:483-569``). Entries come from
    ``cache/vg_{name}_target.pkl``, built on demand from the raw VG dumps by
    :func:`build_visualgenome_entries`."""

    def __init__(self, name: str, store: FeatureStore, dictionary: Dictionary,
                 dataroot: str = "data_vqa", max_boxes: int = 50,
                 question_len: int = QUESTION_LEN,
                 img_id2idx: Optional[dict] = None):
        assert name in ("train", "val")
        self.store = store
        self.dictionary = dictionary
        self.max_boxes = max_boxes
        self.ans2label = _load_pickle(
            os.path.join(dataroot, "cache", "trainval_ans2label.pkl"))
        self.label2ans = _load_pickle(
            os.path.join(dataroot, "cache", "trainval_label2ans.pkl"))
        self.num_ans_candidates = len(self.ans2label)
        if img_id2idx is None:
            img_id2idx = _load_pickle(
                os.path.join(dataroot, f"{name}_imgid2idx.pkl"))
        self.entries = build_visualgenome_entries(
            dataroot, name, img_id2idx, self.ans2label,
            adaptive=store.adaptive)
        for e in self.entries:
            e["q_token"] = np.asarray(
                dictionary.tokenize_padded(e["question"], question_len), np.int32)

    @property
    def v_dim(self) -> int:
        return self.store.v_dim

    def _target(self, answer: dict) -> np.ndarray:
        target = np.zeros((self.num_ans_candidates,), np.float32)
        labels = np.asarray(answer["labels"], np.int64)
        scores = np.asarray(answer["scores"], np.float32)
        if labels.size:
            target[labels] = scores
        return target

    def _fields_common(self, e: dict) -> dict:
        return {
            "q": e["q_token"],
            "a": np.full((ANS_LEN,), self.dictionary.padding_idx, np.int32),
            "qid": np.int64(e["question_id"]),
        }

    def sample_fields(self, index: int) -> dict:
        e = self.entries[index]
        out = self._fields_common(e)
        out["target"] = self._target(e["answer"])
        return out

    def sample_fields_sparse(self, index: int, k: int) -> dict:
        # VG entries carry exactly one label at score 1.0
        # (build_visualgenome_entries) — the sparse wire is trivial
        e = self.entries[index]
        out = self._fields_common(e)
        out["t_label"], out["t_score"] = \
            _FeatureDatasetBase._target_sparse(self, e["answer"], k)
        return out

    def sample(self, index: int) -> dict:
        out = self.sample_fields(index)
        feats, spats, mask = self.store.get(self.entries[index]["image"],
                                            self.max_boxes)
        out.update(v=feats, b=spats, v_mask=mask)
        return out

    def __len__(self) -> int:
        return len(self.entries)


class ConcatDataset:
    """train + VG augmentation concat (replaces torch ConcatDataset usage)."""

    def __init__(self, datasets):
        self.datasets = datasets
        self._offsets = np.cumsum([0] + [len(d) for d in datasets])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    @property
    def num_ans_candidates(self):
        return self.datasets[0].num_ans_candidates

    @property
    def v_dim(self):
        return self.datasets[0].v_dim

    @property
    def max_boxes(self):
        mb = {d.max_boxes for d in self.datasets}
        assert len(mb) == 1, f"members disagree on max_boxes: {mb}"
        return mb.pop()

    def sample(self, index: int) -> dict:
        d = int(np.searchsorted(self._offsets, index, "right")) - 1
        return self.datasets[d].sample(index - int(self._offsets[d]))

    def sample_fields(self, index: int) -> dict:
        d = int(np.searchsorted(self._offsets, index, "right")) - 1
        return self.datasets[d].sample_fields(index - int(self._offsets[d]))

    def sample_fields_sparse(self, index: int, k: int) -> dict:
        d = int(np.searchsorted(self._offsets, index, "right")) - 1
        return self.datasets[d].sample_fields_sparse(
            index - int(self._offsets[d]), k)
