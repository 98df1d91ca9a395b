"""vqatpu_torch's TDIUC scorer and its two host CLIs against vqatpu's.

- ``eval.tdiuc``: ``load_answerkey``, ``align_predictions``,
  ``mean_per_type`` (every metric, the harmonic means too) and
  ``format_report`` equal to ``vqatpu.eval.tdiuc``'s, on annotations made
  from ``vqatpu.data.synthetic.make_tdiuc_fixture``'s val split with seeded
  random predictions, answers missing from the answerkey included.
- ``cli.evaluate_tdiuc`` prints what the JAX CLI prints on the same files.
- ``cli.ensemble`` writes the JAX CLI's JSON and teacher pkl, under the
  same names, from the same member dumps, and refuses the same bad inputs.
"""

import csv
import json
import os
import pickle

import numpy as np
import pytest

from vqatpu.cli import ensemble as jensemble
from vqatpu.cli import evaluate_tdiuc as jevaluate_tdiuc
from vqatpu.data.synthetic import ANSWERS, make_tdiuc_fixture
from vqatpu.eval import tdiuc as jtdiuc
from vqatpu_torch.cli import ensemble, evaluate_tdiuc
from vqatpu_torch.eval import tdiuc


@pytest.fixture(scope="module")
def tdiuc_files(tmp_path_factory):
    """(gt_ann.json, answerkey.csv, root) from the TDIUC fixture's val
    split: each question's answer is its target label; two answers are left
    out of the answerkey, so some questions count as not found."""
    root = str(tmp_path_factory.mktemp("data_TDIUC"))
    make_tdiuc_fixture(root, n_train=8, n_val=64, n_images=6, v_dim=16)
    with open(os.path.join(root, "TDIUC_val_questions.json")) as f:
        questions = json.load(f)["questions"]
    with open(os.path.join(root, "cache", "val_target.pkl"), "rb") as f:
        targets = {t["question_id"]: t for t in pickle.load(f)}
    ann = [{"question_id": q["question_id"],
            "question_type": q["question_type"],
            "answers": [{"answer": ANSWERS[
                targets[q["question_id"]]["labels"][0]]}]}
           for q in questions]
    gt_path = os.path.join(root, "gt_ann.json")
    with open(gt_path, "w") as f:
        json.dump({"annotations": ann}, f)
    key_path = os.path.join(root, "answerkey.csv")
    with open(key_path, "w", newline="") as f:
        csv.writer(f).writerows([a, i] for i, a in enumerate(ANSWERS[:-2]))
    return gt_path, key_path, root


def write_predictions(path, gt_path, key_path, seed):
    """Seeded random answers from the answerkey, in shuffled order (the
    scorer aligns them by question id)."""
    rng = np.random.RandomState(seed)
    with open(gt_path) as f:
        ann = json.load(f)["annotations"]
    keys = list(tdiuc.load_answerkey(key_path))
    preds = [{"question_id": a["question_id"],
              "answer": keys[rng.randint(len(keys))]}
             for a in ann]
    rng.shuffle(preds)
    with open(path, "w") as f:
        json.dump(preds, f)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_and_report_equal_jax(tdiuc_files, tmp_path, seed):
    gt_path, key_path, _ = tdiuc_files
    pred_path = str(tmp_path / "pred.json")
    write_predictions(pred_path, gt_path, key_path, seed)
    key = tdiuc.load_answerkey(key_path)
    assert key == jtdiuc.load_answerkey(key_path)
    with open(gt_path) as f:
        ann = json.load(f)["annotations"]
    preds = tdiuc.align_predictions(pred_path, ann, key)
    assert preds == jtdiuc.align_predictions(pred_path, ann, key)
    got = tdiuc.mean_per_type(preds, ann, key)
    want = jtdiuc.mean_per_type(preds, ann, key)
    assert got == want
    assert got["notfound"] > 0 and set(got["types"]) == {
        "color", "counting", "object_presence"}
    assert tdiuc.format_report(got) == jtdiuc.format_report(want)


def test_metrics_by_hand():
    """A case small enough to count: color 1 of 2 right, counting 2 of 2."""
    ann = [{"question_id": i, "question_type": t, "answers": [{"answer": a}]}
           for i, (t, a) in enumerate([("color", "red"), ("color", "blue"),
                                       ("counting", "two"),
                                       ("counting", "two")])]
    key = {"red": 0, "blue": 1, "two": 2}
    m = tdiuc.mean_per_type([0, 0, 2, 2], ann, key)
    assert m["types"] == {"color": 50.0, "counting": 100.0}
    assert m["arithmetic_mpt"] == pytest.approx(75.0)
    assert m["harmonic_mpt"] == pytest.approx(2 / (1 / 50 + 1 / 100))
    assert m["overall"] == 75.0 and m["types_norm"]["color"] == 50.0
    assert m == jtdiuc.mean_per_type([0, 0, 2, 2], ann, key)


def test_evaluate_tdiuc_cli_prints_the_jax_report(tdiuc_files, tmp_path,
                                                  capsys):
    gt_path, key_path, _ = tdiuc_files
    pred_path = str(tmp_path / "pred.json")
    write_predictions(pred_path, gt_path, key_path, seed=5)
    argv = ["--gt_ann", gt_path, "--pred_ann", pred_path,
            "--answerkey", key_path]
    jevaluate_tdiuc.main(argv)
    want = capsys.readouterr().out
    metrics = evaluate_tdiuc.main(argv)
    got = capsys.readouterr().out
    assert got == want and "Harmonic MPT Accuracy is" in got
    assert metrics["notfound"] > 0


def member_dumps(tmp_path, n_members=3, n_rows=24, n_ans=len(ANSWERS)):
    """Seeded logit dumps, each member's rows in another order (members are
    aligned by question id)."""
    rng = np.random.RandomState(0)
    qids = rng.permutation(1000)[:n_rows].astype(np.int64)
    paths = []
    for i in range(n_members):
        order = rng.permutation(n_rows)
        logits = rng.randn(n_rows, n_ans).astype(np.float32)
        path = str(tmp_path / f"logits{i}.npz")
        np.savez(path, logits=logits[order], question_ids=qids[order])
        paths.append(path)
    return paths, qids


def test_ensemble_cli_writes_the_jax_files(tdiuc_files, tmp_path):
    _, _, root = tdiuc_files
    members, _ = member_dumps(tmp_path)
    outs = {}
    for name, cli in (("jax", jensemble), ("port", ensemble)):
        res = str(tmp_path / name)
        cli.main(["--inputs", *members, "--dataroot", root, "--split", "val",
                  "--results", res, "--name", "tri", "--teacher_pkl"])
        outs[name] = sorted(os.listdir(res))
        with open(os.path.join(res, "val_tri_3members.json")) as f:
            outs[name + "_json"] = json.load(f)
        with open(os.path.join(res, "tri_val_logits.pkl"), "rb") as f:
            outs[name + "_pkl"] = pickle.load(f)
    assert outs["port"] == outs["jax"] == ["tri_val_logits.pkl",
                                           "val_tri_3members.json"]
    assert outs["port_json"] == outs["jax_json"]
    assert sorted(outs["port_pkl"]) == sorted(outs["jax_pkl"])
    for q, x in outs["jax_pkl"].items():
        assert outs["port_pkl"][q].dtype == np.float16
        np.testing.assert_array_equal(outs["port_pkl"][q], x)


@pytest.mark.parametrize("fault", ["other_questions", "duplicates"])
def test_ensemble_cli_refuses_what_jax_refuses(tdiuc_files, tmp_path, fault):
    _, _, root = tdiuc_files
    members, qids = member_dumps(tmp_path, n_members=1)
    with np.load(members[0]) as z:
        logits, ids = z["logits"], z["question_ids"]
    bad = str(tmp_path / "bad.npz")
    if fault == "other_questions":
        np.savez(bad, logits=logits, question_ids=ids + 1)
        inputs, match = [members[0], bad], "question_ids differ"
    else:
        np.savez(bad, logits=np.concatenate([logits, logits[:1]]),
                 question_ids=np.concatenate([ids, ids[:1]]))
        inputs, match = [bad], "duplicate question_ids"
    for cli in (jensemble, ensemble):
        with pytest.raises(ValueError, match=match):
            cli.main(["--inputs", *inputs, "--dataroot", root,
                      "--results", str(tmp_path / "r")])
