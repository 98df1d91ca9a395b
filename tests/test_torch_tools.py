"""The port's offline preprocessing tools against ``vqatpu.tools``, on the
inputs of ``tests/test_tools.py`` and on a seeded raw VQA fixture
(``vqatpu_torch.data.synthetic.write_raw_vqa``): the same dictionaries,
answer caches, soft targets and converted features, and each CLI's
``main(argv)`` writes the same files (the pickles and ``.npy`` byte for
byte, the ``.hdf5`` dataset by dataset)."""

import filecmp
import json
import os
import pickle
import sys

import numpy as np
import pytest

from vqatpu.data.synthetic import write_bottomup_tsv as jax_write_tsv
from vqatpu.tools import compute_softscore as jsoft
from vqatpu.tools import create_dictionary as jdict
from vqatpu.tools import feature_converter as jconv
from vqatpu_torch.data.synthetic import write_bottomup_tsv, write_raw_vqa
from vqatpu_torch.tools import compute_softscore as psoft
from vqatpu_torch.tools import create_dictionary as pdict
from vqatpu_torch.tools import feature_converter as pconv
from vqatpu_torch.tools.vqa_normalize import get_score

IMAGES = list(range(100, 112))


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("raw"))
    write_raw_vqa(root, IMAGES[:8], IMAGES[8:], n_train=60, n_val=20,
                  emb_dim=50, seed=3)
    return root


def _copy(src, dst):
    import shutil

    shutil.copytree(src, dst)
    return dst


def test_get_score_matches_jax():
    from vqatpu.tools.vqa_normalize import get_score as jax_get_score

    assert [get_score(i) for i in range(12)] == [jax_get_score(i)
                                                for i in range(12)]


def test_softscore_pipeline_matches_jax(tmp_path):
    """tests/test_tools.py::test_softscore_pipeline's entries."""
    def entry(qid, gt, answers):
        return {"question_id": qid, "image_id": qid * 2,
                "multiple_choice_answer": gt,
                "answers": [{"answer": a} for a in answers]}

    dset = [entry(i, "cat", ["cat"] * 7 + ["dog"] * 3) for i in range(9)]
    dset += [entry(100 + i, "dog", ["dog"] * 10) for i in range(9)]
    dset += [entry(200, "rare bird", ["rare bird"] * 10)]
    occ = psoft.filter_answers(dset, min_occurence=9)
    assert occ == jsoft.filter_answers(dset, min_occurence=9)
    a2l = psoft.create_ans2label(occ, "trainval", str(tmp_path / "p"))
    assert a2l == jsoft.create_ans2label(occ, "trainval", str(tmp_path / "j"))
    for pre in (False, True):
        assert (psoft.compute_target(dset, a2l, "train", str(tmp_path / "p"),
                                     preprocessed=pre)
                == jsoft.compute_target(dset, a2l, "train",
                                        str(tmp_path / "j"), preprocessed=pre))
    assert not filecmp.dircmp(tmp_path / "p", tmp_path / "j").diff_files


def test_create_dictionary_matches_jax(raw, tmp_path):
    root = str(tmp_path)
    qs = {"questions": [{"question": "What color is the cat?"},
                        {"question": "Where's the dog."}]}
    with open(os.path.join(root, jdict.VQA_QUESTION_FILES[0]), "w") as f:
        json.dump(qs, f)
    for r in (root, raw):
        got, want = pdict.create_dictionary(r), jdict.create_dictionary(r)
        assert (got.word2idx, got.idx2word) == (want.word2idx, want.idx2word)


@pytest.mark.parametrize("tool", ["create_dictionary", "compute_softscore"])
def test_cli_writes_jax_files(raw, tmp_path, tool):
    """Both CLIs on copies of the raw fixture: the same files, the same
    bytes; compute_softscore run twice (its second run keeps the cached
    ans2label, as JAX's does)."""
    p_root = _copy(raw, str(tmp_path / "p"))
    j_root = _copy(raw, str(tmp_path / "j"))
    argv = {"create_dictionary": ["--emb_dim", "50"],
            "compute_softscore": ["--min_occurence", "3"]}[tool]
    port_mod, jax_mod = {"create_dictionary": (pdict, jdict),
                         "compute_softscore": (psoft, jsoft)}[tool]
    for _ in range(1 + (tool == "compute_softscore")):
        port_mod.main(["--dataroot", p_root] + argv)
        jax_mod.main(["--dataroot", j_root] + argv)
    written = []
    for dirpath, _, files in os.walk(j_root):
        for name in files:
            rel = os.path.relpath(os.path.join(dirpath, name), j_root)
            assert filecmp.cmp(os.path.join(j_root, rel),
                               os.path.join(p_root, rel), shallow=False), rel
            written.append(rel)
    new = {"create_dictionary": {"dictionary.pkl", "glove6b_init_50d.npy"},
           "compute_softscore": {os.path.join("cache", f) for f in (
               "trainval_ans2label.pkl", "trainval_label2ans.pkl",
               "train_target.pkl", "val_target.pkl")}}[tool]
    assert new <= set(written)
    assert sorted(os.listdir(p_root)) == sorted(os.listdir(j_root))
    if tool == "create_dictionary":
        emb = np.load(os.path.join(p_root, "glove6b_init_50d.npy"))
        assert emb.shape[1] == 50 and np.abs(emb).sum() > 0


def test_bottomup_tsv_writer_matches_jax(tmp_path):
    boxes = [(10, 12), (11, 15), (12, 36)]
    write_bottomup_tsv(str(tmp_path / "p.tsv"), boxes, v_dim=8, seed=4)
    jax_write_tsv(str(tmp_path / "j.tsv"), boxes, v_dim=8, seed=4)
    assert filecmp.cmp(tmp_path / "p.tsv", tmp_path / "j.tsv", shallow=False)
    rows = list(pconv.iter_tsv([str(tmp_path / "p.tsv")]))
    for row, jrow in zip(rows, jconv.iter_tsv([str(tmp_path / "j.tsv")])):
        got, want = pconv.decode_row(row, 8), jconv.decode_row(jrow, 8)
        assert got[:4] == want[:4]
        for a, b in zip(got[4:], want[4:]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            pconv.spatial_features(got[4], got[1], got[2]),
            jconv.spatial_features(want[4], want[1], want[2]))


def _h5_arrays(path):
    import h5py

    with h5py.File(path, "r") as hf:
        return {k: hf[k][()] for k in hf}


@pytest.mark.parametrize("layout", ["adaptive", "fixed36"])
def test_feature_converter_writes_jax_files(tmp_path, layout):
    """``main(argv)`` of both converters on one TSV pair: the same
    ``.hdf5`` datasets (names, dtypes, values) and ``imgid2idx`` bytes."""
    n = [36] * 4 if layout == "fixed36" else [10, 27, 14, 100]
    tsvs = []
    for i, half in enumerate((n[:2], n[2:])):
        path = str(tmp_path / f"part{i}.tsv")
        write_bottomup_tsv(path, [(500 + 2 * i + j, b)
                                  for j, b in enumerate(half)],
                           v_dim=2048, seed=i)
        tsvs.append(path)
    extra = ["--fixed", "36"] if layout == "fixed36" else []
    stem = "train36" if layout == "fixed36" else "train"
    for mod, out in ((pconv, "p"), (jconv, "j")):
        mod.main(["--split", "train", "--tsv", *tsvs, "--out",
                  str(tmp_path / out)] + extra)
    got = _h5_arrays(tmp_path / "p" / f"{stem}.hdf5")
    want = _h5_arrays(tmp_path / "j" / f"{stem}.hdf5")
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert filecmp.cmp(tmp_path / "p" / f"{stem}_imgid2idx.pkl",
                       tmp_path / "j" / f"{stem}_imgid2idx.pkl", shallow=False)
    with open(tmp_path / "p" / f"{stem}_imgid2idx.pkl", "rb") as f:
        assert pickle.load(f) == {500 + i: i for i in range(4)}
    if layout == "adaptive":
        assert got["pos_boxes"].tolist() == [[0, 10], [10, 37], [37, 51],
                                             [51, 151]]
    else:
        assert got["image_features"].shape == (4, 36, 2048)


def test_feature_converter_names_missing_h5py(tmp_path, monkeypatch):
    """Without h5py the writers raise a named ImportError before reading
    the TSVs; the array functions need none."""
    write_bottomup_tsv(str(tmp_path / "a.tsv"), [(1, 10)], v_dim=2048)
    monkeypatch.setitem(sys.modules, "h5py", None)
    for fn, args in ((pconv.convert_adaptive, ()),
                     (pconv.convert_fixed, (10,))):
        with pytest.raises(ImportError, match="feature_converter .* h5py"):
            fn("train", [str(tmp_path / "a.tsv")], str(tmp_path / "o"), *args)
    arrays, ids = pconv.adaptive_arrays([str(tmp_path / "a.tsv")])
    assert arrays["image_features"].shape == (10, 2048) and ids == {1: 0}
    assert not (tmp_path / "o").exists()
