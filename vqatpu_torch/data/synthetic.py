"""Synthetic fixture datasets, a copy of ``vqatpu.data.synthetic``
(``vqatpu/data/synthetic.py:10-215``): the same files from the same seeds.

Generates a complete VQA-2.0- or TDIUC-shaped dataroot on disk (question
JSONs, target pickles, imgid2idx, adaptive region features, GloVe init
matrix, dictionary) so the train, eval and export pipeline runs with no
external data.  Shapes mirror the real artifacts (adaptive ``pos_boxes``
layout with 10..max boxes per image, soft-score targets).  Features go to
``{split}.hdf5`` where ``h5py`` imports, else to ``{split}.npz``.  The
Visual7W fixture waits for the MC port (ROADMAP queue A item 7).
"""

from __future__ import annotations

import json
import os
import pickle
import numpy as np

from vqatpu_torch.data.dictionary import Dictionary

WORDS = (
    "what color is the cat dog car sky person wearing holding how many are "
    "there on of a red blue green two three left right table 's standing"
).split()

ANSWERS = ["red", "blue", "green", "two", "three", "cat", "dog", "yes", "no",
           "on table", "left", "right"]


def _questions(rng: np.random.RandomState, n: int):
    qs = []
    for i in range(n):
        length = rng.randint(3, 9)
        text = " ".join(rng.choice(WORDS, size=length)) + "?"
        qs.append(text)
    return qs


def _write_features(path_base: str, rng, n_images: int, v_dim: int,
                    min_boxes: int = 10, max_boxes: int = 20):
    counts = rng.randint(min_boxes, max_boxes + 1, size=n_images)
    total = int(counts.sum())
    features = rng.randn(total, v_dim).astype(np.float32)
    spatials = rng.rand(total, 6).astype(np.float32)
    ends = np.cumsum(counts)
    pos_boxes = np.stack([ends - counts, ends], 1).astype(np.int64)
    try:
        import h5py
        with h5py.File(path_base + ".hdf5", "w") as hf:
            hf.create_dataset("image_features", data=features)
            hf.create_dataset("spatial_features", data=spatials)
            hf.create_dataset("pos_boxes", data=pos_boxes)
    except ImportError:
        np.savez(path_base + ".npz", image_features=features,
                 spatial_features=spatials, pos_boxes=pos_boxes)


def make_dictionary(dataroot: str, extra_words=()) -> Dictionary:
    d = Dictionary()
    for w in WORDS:
        d.add_word(w)
    for a in ANSWERS:
        for w in a.split():
            d.add_word(w)
    for w in extra_words:
        d.add_word(w)
    d.dump_to_file(os.path.join(dataroot, "dictionary.pkl"))
    # GloVe-300 init matrix (create_dictionary.py:51-59 analogue)
    rng = np.random.RandomState(0)
    glove = (rng.randn(d.ntoken, 300) * 0.1).astype(np.float32)
    np.save(os.path.join(dataroot, "glove6b_init_300d.npy"), glove)
    return d


def make_vqa_fixture(dataroot: str, n_train: int = 64, n_val: int = 32,
                     n_images: int = 24, v_dim: int = 64,
                     with_teacher_logits: bool = False, seed: int = 0) -> Dictionary:
    os.makedirs(os.path.join(dataroot, "cache"), exist_ok=True)
    rng = np.random.RandomState(seed)
    d = make_dictionary(dataroot)

    ans2label = {a: i for i, a in enumerate(ANSWERS)}
    with open(os.path.join(dataroot, "cache", "trainval_ans2label.pkl"), "wb") as f:
        pickle.dump(ans2label, f)
    with open(os.path.join(dataroot, "cache", "trainval_label2ans.pkl"), "wb") as f:
        pickle.dump(list(ANSWERS), f)

    for split, n in (("train", n_train), ("val", n_val)):
        img_ids = list(range(1000, 1000 + n_images))
        img_id2idx = {im: i for i, im in enumerate(img_ids)}
        with open(os.path.join(dataroot, f"{split}_imgid2idx.pkl"), "wb") as f:
            pickle.dump(img_id2idx, f)
        _write_features(os.path.join(dataroot, split), rng, n_images, v_dim)

        questions, targets = [], []
        for i in range(n):
            qid = i * 10 + (0 if split == "train" else 5)
            img = img_ids[rng.randint(n_images)]
            questions.append({
                "question_id": qid, "image_id": img,
                "question": _questions(rng, 1)[0],
            })
            k = rng.randint(1, 3)
            labels = rng.choice(len(ANSWERS), size=k, replace=False).tolist()
            scores = rng.choice([0.3, 0.6, 0.9, 1.0], size=k).tolist()
            targets.append({
                "question_id": qid, "image_id": img,
                "labels": labels, "scores": scores,
            })
        with open(os.path.join(
                dataroot, f"v2_OpenEnded_mscoco_{split}2014_questions.json"), "w") as f:
            json.dump({"questions": questions}, f)
        with open(os.path.join(dataroot, "cache", f"{split}_target.pkl"), "wb") as f:
            pickle.dump(targets, f)
        if with_teacher_logits:
            logits = {
                q["question_id"]: rng.randn(len(ANSWERS)).astype(np.float16)
                for q in questions
            }
            with open(os.path.join(dataroot, f"{split}_teacher_logits.pkl"), "wb") as f:
                pickle.dump(logits, f)
    return d


def add_visualgenome_fixture(dataroot: str, n_questions: int = 20,
                             seed: int = 5) -> None:
    """Raw VG dumps (question_answers.json + image_data.json) over the VQA
    fixture's train images, for ``build_visualgenome_entries``."""
    rng = np.random.RandomState(seed)
    with open(os.path.join(dataroot, "train_imgid2idx.pkl"), "rb") as f:
        img_id2idx = pickle.load(f)
    coco_ids = list(img_id2idx)
    image_data, vgq = [], []
    for i, coco_id in enumerate(coco_ids):
        vg_id = 90000 + i
        image_data.append({"image_id": vg_id, "coco_id": coco_id})
        qas = []
        for j in range(max(1, n_questions // len(coco_ids))):
            qas.append({
                "qa_id": 500000 + i * 100 + j,
                "question": _questions(rng, 1)[0],
                "answer": str(rng.choice(ANSWERS)),
            })
        vgq.append({"id": vg_id, "qas": qas})
    # one VG image without a COCO mapping (must be skipped)
    image_data.append({"image_id": 99999, "coco_id": None})
    vgq.append({"id": 99999,
                "qas": [{"qa_id": 599999, "question": "what?", "answer": "red"}]})
    with open(os.path.join(dataroot, "image_data.json"), "w") as f:
        json.dump(image_data, f)
    with open(os.path.join(dataroot, "question_answers.json"), "w") as f:
        json.dump(vgq, f)


def make_tdiuc_fixture(dataroot: str, n_train: int = 48, n_val: int = 24,
                       n_images: int = 16, v_dim: int = 64,
                       seed: int = 1) -> Dictionary:
    os.makedirs(os.path.join(dataroot, "cache"), exist_ok=True)
    rng = np.random.RandomState(seed)
    d = make_dictionary(dataroot)
    qtypes = ["color", "counting", "object_presence"]

    ans2label = {a: i for i, a in enumerate(ANSWERS)}
    with open(os.path.join(dataroot, "cache", "trainval_ans2label.pkl"), "wb") as f:
        pickle.dump(ans2label, f)
    with open(os.path.join(dataroot, "cache", "trainval_label2ans.pkl"), "wb") as f:
        pickle.dump(list(ANSWERS), f)

    for split, n in (("train", n_train), ("val", n_val)):
        img_ids = list(range(2000, 2000 + n_images))
        img_id2idx = {im: i for i, im in enumerate(img_ids)}
        with open(os.path.join(dataroot, f"{split}_imgid2idx.pkl"), "wb") as f:
            pickle.dump(img_id2idx, f)
        _write_features(os.path.join(dataroot, split), rng, n_images, v_dim)
        questions, targets = [], []
        for i in range(n):
            qid = i * 10
            img = img_ids[rng.randint(n_images)]
            questions.append({
                "question_id": qid, "image_id": img,
                "question": _questions(rng, 1)[0],
                "question_type": qtypes[rng.randint(len(qtypes))],
            })
            targets.append({
                "question_id": qid, "image_id": img,
                "labels": [int(rng.randint(len(ANSWERS)))], "scores": [1.0],
            })
        with open(os.path.join(dataroot, f"TDIUC_{split}_questions.json"), "w") as f:
            json.dump({"questions": questions}, f)
        with open(os.path.join(dataroot, "cache", f"{split}_target.pkl"), "wb") as f:
            pickle.dump(targets, f)
    return d
