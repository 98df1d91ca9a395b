"""Synthetic fixture datasets, a copy of ``vqatpu.data.synthetic``
(``vqatpu/data/synthetic.py:10-252``): the same files from the same seeds.

Generates a complete VQA-2.0- or TDIUC-shaped dataroot on disk (question
JSONs, target pickles, imgid2idx, adaptive region features, GloVe init
matrix, dictionary) so the train, eval and export pipeline runs with no
external data.  Shapes mirror the real artifacts (adaptive ``pos_boxes``
layout with 10..max boxes per image, soft-score targets).  Features go to
``{split}.hdf5`` where ``h5py`` imports, else to ``{split}.npz``.  The
Visual7W fixture (:func:`make_v7w_fixture`) writes the bottom-up
features as JAX's does; :func:`add_v7w_grid_fixture` adds the grid path's
fixed 196-cell features under ``v7w/``.  :func:`write_bottomup_tsv` and
:func:`write_raw_vqa` write the preprocessing tools' raw inputs.
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


def write_bottomup_tsv(path: str, image_boxes, v_dim: int = 2048,
                       seed: int = 0) -> None:
    """A bottom-up-attention TSV in the feature converter's input format,
    one row per ``(image_id, num_boxes)`` pair with base64 float32 boxes
    and features (``vqatpu/data/synthetic.py:28-48``: the same bytes)."""
    import base64

    rng = np.random.RandomState(seed)
    rows = []
    for img_id, n in image_boxes:
        boxes = (rng.rand(n, 4) * 100).astype(np.float32)
        feats = rng.randn(n, v_dim).astype(np.float32)
        rows.append("\t".join([
            str(img_id), "640", "480", str(n),
            base64.b64encode(boxes.tobytes()).decode(),
            base64.b64encode(feats.tobytes()).decode()]))
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")


def write_raw_vqa(dataroot: str, train_images, val_images, n_train: int,
                  n_val: int, emb_dim: int = 300, seed: int = 0) -> None:
    """The preprocessing tools' inputs over each split's images: VQA-2.0
    question and annotation JSONs (``v2_OpenEnded_mscoco_{split}2014_
    questions.json``, ``v2_mscoco_{split}2014_annotations.json``, ten
    annotator answers a question, drawn from :data:`ANSWERS` in raw
    spellings the normalizer maps onto them) and a GloVe text file
    ``glove/glove.6B.{emb_dim}d.txt`` over :data:`WORDS`.  Port only."""
    rng = np.random.RandomState(seed)
    spellings = {"two": ["two", "2", "Two"], "yes": ["yes", "Yes!"],
                 "on table": ["on the table", "on table"]}
    os.makedirs(os.path.join(dataroot, "glove"), exist_ok=True)
    with open(os.path.join(dataroot, "glove", f"glove.6B.{emb_dim}d.txt"),
              "w") as f:
        for w in WORDS:
            f.write(" ".join([w] + [f"{x:.5f}" for x in rng.randn(emb_dim)])
                    + "\n")
    for split, n, image_ids in (("train", n_train, list(train_images)),
                                ("val", n_val, list(val_images))):
        questions, annotations = [], []
        for i in range(n):
            qid = i * 10 + (0 if split == "train" else 5)
            img = image_ids[rng.randint(len(image_ids))]
            questions.append({"question_id": qid, "image_id": img,
                              "question": _questions(rng, 1)[0]})
            answers = rng.choice(ANSWERS, size=10)
            raw = [str(rng.choice(spellings.get(a, [a]))) for a in answers]
            annotations.append({
                "question_id": qid, "image_id": img,
                "multiple_choice_answer": raw[0],
                "answers": [{"answer": a, "answer_id": j + 1}
                            for j, a in enumerate(raw)]})
        with open(os.path.join(
                dataroot, f"v2_OpenEnded_mscoco_{split}2014_questions.json"),
                "w") as f:
            json.dump({"questions": questions}, f)
        with open(os.path.join(
                dataroot, f"v2_mscoco_{split}2014_annotations.json"), "w") as f:
            json.dump({"annotations": annotations}, f)


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


def make_v7w_fixture(dataroot: str, n_train: int = 32, n_val: int = 16,
                     n_images: int = 12, v_dim: int = 64,
                     seed: int = 2) -> Dictionary:
    """A Visual7W dataroot (``vqatpu/data/synthetic.py:216-252``): per
    split the imgid2idx, adaptive features, ``v7w_{split}_questions.json``
    and ``answer_{split}.json`` with 4 distinct candidates a question, one
    of them the ground truth."""
    os.makedirs(os.path.join(dataroot, "cache"), exist_ok=True)
    rng = np.random.RandomState(seed)
    d = make_dictionary(dataroot)

    ans2label = {a: i for i, a in enumerate(ANSWERS)}
    with open(os.path.join(dataroot, "cache", "trainval_ans2label.pkl"), "wb") as f:
        pickle.dump(ans2label, f)
    with open(os.path.join(dataroot, "cache", "trainval_label2ans.pkl"), "wb") as f:
        pickle.dump(list(ANSWERS), f)

    for split, n in (("train", n_train), ("val", n_val), ("test", n_val)):
        img_ids = list(range(3000, 3000 + n_images))
        img_id2idx = {im: i for i, im in enumerate(img_ids)}
        with open(os.path.join(dataroot, f"{split}_imgid2idx.pkl"), "wb") as f:
            pickle.dump(img_id2idx, f)
        _write_features(os.path.join(dataroot, split), rng, n_images, v_dim)
        questions, candidates = [], {}
        for i in range(n):
            qid = i * 7
            img = img_ids[rng.randint(n_images)]
            questions.append({
                "question_id": qid, "image_id": img,
                "question": _questions(rng, 1)[0],
            })
            mc = rng.choice(ANSWERS, size=4, replace=False).tolist()
            gt = int(rng.randint(4))
            label = [0.0] * 4
            label[gt] = 1.0
            candidates[str(qid)] = {"mc": mc, "ans_gt": mc[gt], "label": label}
        with open(os.path.join(dataroot, f"v7w_{split}_questions.json"), "w") as f:
            json.dump({"questions": questions}, f)
        with open(os.path.join(dataroot, f"answer_{split}.json"), "w") as f:
            json.dump(candidates, f)
    return d


def add_v7w_grid_fixture(dataroot: str, n_images: int = 12, v_dim: int = 64,
                         cells: int = 196, seed: int = 3) -> None:
    """The grid path's files beside a :func:`make_v7w_fixture` dataroot of
    the same ``n_images``: per split ``v7w/{split}_imgid2idx.pkl`` and
    fixed-layout features ``v7w/{split}`` (``image_features [n_images,
    cells, v_dim]``; ``.hdf5`` where h5py imports, else ``.npz``).  The
    dataset replaces the spatials with zeros, so those written here are
    random on purpose."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(dataroot, "v7w"), exist_ok=True)
    img_id2idx = {im: i for i, im in enumerate(range(3000, 3000 + n_images))}
    for split in ("train", "val", "test"):
        with open(os.path.join(dataroot, "v7w", f"{split}_imgid2idx.pkl"),
                  "wb") as f:
            pickle.dump(img_id2idx, f)
        features = rng.randn(n_images, cells, v_dim).astype(np.float32)
        spatials = rng.rand(n_images, cells, 6).astype(np.float32)
        base = os.path.join(dataroot, "v7w", split)
        try:
            import h5py
            with h5py.File(base + ".hdf5", "w") as hf:
                hf.create_dataset("image_features", data=features)
                hf.create_dataset("spatial_features", data=spatials)
        except ImportError:
            np.savez(base + ".npz", image_features=features,
                     spatial_features=spatials)
