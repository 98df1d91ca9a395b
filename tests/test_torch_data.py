"""vqatpu_torch's data layer against vqatpu's on the same files: datasets
(every field of ``sample``, ``sample_fields`` and ``sample_fields_sparse``
bit-equal, for VQA with teacher logits, TDIUC, Visual Genome and their
concat, from ``.hdf5`` and ``.npz``, resident, streaming and quantized),
loaders (every batch of two epochs bit-equal, shuffled and not, with
``drop_last``, ``pad_final``, ``fields_only`` and sparse targets), the
synthetic fixtures (the same files from the same seeds) and tf-idf (the
matrix and the loaded embedding tables to 1e-6).

Fixtures come from ``vqatpu.data.synthetic`` in ``tmp_path``, at the JAX
data tests' small widths (v_dim 16-64).  Each package reads its own copy
of a dataroot, so neither reads a cache the other wrote.
"""

import os
import pickle
import shutil

import numpy as np
import pytest

import jax

from vqatpu.data import batching as jbatching
from vqatpu.data import datasets as jdatasets
from vqatpu.data import tfidf as jtfidf
from vqatpu.data.dictionary import Dictionary as JaxDictionary
from vqatpu.data.features import FeatureStore as JaxFeatureStore
from vqatpu.data.synthetic import (WORDS, add_visualgenome_fixture,
                                   make_tdiuc_fixture, make_vqa_fixture)
from vqatpu.ops.embedding import WordEmbedding as JaxWordEmbedding
from vqatpu_torch.data import batching, datasets, features, synthetic, tfidf
from vqatpu_torch.data.dictionary import Dictionary
from vqatpu_torch.data.features import FeatureStore
from vqatpu_torch.ops.embedding import WordEmbedding
from vqatpu_torch.weights import torch_state_from_jax

MAX_BOXES = 12


def to_npz(root: str) -> None:
    """Rewrite every split's ``.hdf5`` features as ``.npz`` and drop the
    ``.hdf5``: both packages then read the ``.npz``."""
    import h5py

    for name in os.listdir(root):
        if name.endswith(".hdf5"):
            path = os.path.join(root, name)
            with h5py.File(path, "r") as hf:
                arrays = {k: np.asarray(hf[k]) for k in hf}
            np.savez(path[:-len(".hdf5")] + ".npz", **arrays)
            os.remove(path)


def twin_roots(tmp_path_factory, name, make, fmt):
    """The same dataroot twice, (JAX's copy, the port's copy)."""
    root = str(tmp_path_factory.mktemp(f"{name}_{fmt}"))
    make(root)
    if fmt == "npz":
        to_npz(root)
    other = root + "_port"
    shutil.copytree(root, other)
    return root, other


def make_vqa(root):
    make_vqa_fixture(root, n_train=24, n_val=16, n_images=8, v_dim=16,
                     with_teacher_logits=True)
    add_visualgenome_fixture(root, n_questions=16)


def make_tdiuc(root):
    make_tdiuc_fixture(root, n_train=16, n_val=8, n_images=6, v_dim=16)


@pytest.fixture(scope="module", params=["hdf5", "npz"])
def vqa_roots(request, tmp_path_factory):
    return twin_roots(tmp_path_factory, "vqa", make_vqa, request.param)


@pytest.fixture(scope="module", params=["hdf5", "npz"])
def tdiuc_roots(request, tmp_path_factory):
    return twin_roots(tmp_path_factory, "tdiuc", make_tdiuc, request.param)


STORE_MODES = {"resident": dict(),
               "streaming": dict(features_in_memory=False),
               "quantized": dict(quantize_features=True)}


def build(mod, dict_cls, kind, root, mode):
    """The dataset ``kind`` of package ``mod`` over ``root``."""
    d = dict_cls.load_from_file(os.path.join(root, "dictionary.pkl"))
    kw = dict(dataroot=root, max_boxes=MAX_BOXES, **STORE_MODES[mode])
    if kind == "tdiuc":
        return mod.TDIUCFeatureDataset("train", d, **kw)
    # teacher logits for VQA alone: the val split has none, so a concat
    # with them would not stack (in either package)
    train = mod.VQAFeatureDataset("train", d, distillation=kind == "vqa", **kw)
    vg = mod.VisualGenomeFeatureDataset(
        "train", train.store, d, dataroot=root, max_boxes=MAX_BOXES,
        img_id2idx=train.img_id2idx)
    if kind == "vqa":
        return train
    if kind == "vg":
        return vg
    val = mod.VQAFeatureDataset("val", d, **kw)
    return mod.ConcatDataset([train, val, vg])


def assert_samples_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def assert_datasets_equal(mine, theirs):
    assert len(mine) == len(theirs) > 0
    assert mine.num_ans_candidates == theirs.num_ans_candidates
    assert mine.v_dim == theirs.v_dim
    k = jbatching.max_target_labels(theirs)
    assert batching.max_target_labels(mine) == k
    for i in range(len(theirs)):
        assert_samples_equal(mine.sample(i), theirs.sample(i))
        assert_samples_equal(mine.sample_fields(i), theirs.sample_fields(i))
        assert_samples_equal(mine.sample_fields_sparse(i, k),
                             theirs.sample_fields_sparse(i, k))


@pytest.mark.parametrize("mode", sorted(STORE_MODES))
@pytest.mark.parametrize("kind", ["vqa", "vg", "concat"])
def test_vqa_datasets_bit_equal(vqa_roots, kind, mode):
    """VQA (with teacher logits), its Visual Genome augmentation and the
    ``--use_both --use_vg`` concat; every field of every sample."""
    root_j, root_p = vqa_roots
    if mode == "streaming" and root_j.endswith("npz"):
        mode = "resident"  # .npz stores are resident in both packages
    theirs = build(jdatasets, JaxDictionary, kind, root_j, mode)
    mine = build(datasets, Dictionary, kind, root_p, mode)
    assert_datasets_equal(mine, theirs)


@pytest.mark.parametrize("mode", sorted(STORE_MODES))
def test_tdiuc_dataset_bit_equal(tdiuc_roots, mode):
    root_j, root_p = tdiuc_roots
    theirs = build(jdatasets, JaxDictionary, "tdiuc", root_j, mode)
    mine = build(datasets, Dictionary, "tdiuc", root_p, mode)
    assert_datasets_equal(mine, theirs)


def test_streaming_store_reads_as_resident_and_closes(tmp_path, monkeypatch):
    root = str(tmp_path)
    make_tdiuc(root)
    path = os.path.join(root, "train.hdf5")
    stream = FeatureStore.from_hdf5(path, in_memory=False)
    whole = FeatureStore.from_hdf5(path)
    assert not stream.in_memory and whole.in_memory
    for i in range(3):
        for a, b in zip(stream.get(i, MAX_BOXES), whole.get(i, MAX_BOXES)):
            np.testing.assert_array_equal(a, b)
    resident = stream.materialize()
    np.testing.assert_array_equal(resident.features, whole.features)
    with pytest.raises(ValueError, match="resident"):
        FeatureStore.from_hdf5(path, in_memory=False, quantize=True)
    with pytest.raises(ValueError, match="streaming"):
        stream.quantize()
    stream.close()
    assert stream.in_memory  # closed: nothing open any more
    monkeypatch.setattr(features, "QUANTIZE_CHUNK_BYTES", 256)  # many chunks
    small = FeatureStore.from_hdf5(path, quantize=True)
    big = JaxFeatureStore.from_hdf5(path, quantize=True)
    np.testing.assert_array_equal(small.features, big.features)
    np.testing.assert_array_equal(small.feat_scales, big.feat_scales)


LOADERS = {
    "sequential": dict(),
    "shuffled-drop_last": dict(shuffle=True, drop_last=True),
    "shuffled-padded": dict(shuffle=True),
    "shuffled-unpadded": dict(shuffle=True, pad_final=False),
    "fields_only": dict(shuffle=True, fields_only=True),
    "fields_only-sparse": dict(shuffle=True, fields_only=True,
                               sparse_target_k=-1),
}


@pytest.mark.parametrize("case", sorted(LOADERS))
def test_batch_loader_bit_equal_over_two_epochs(vqa_roots, case):
    """The concat dataset at batch 7 (a ragged last batch of each epoch);
    the second epoch reshuffles from the loader's own RandomState."""
    root_j, root_p = vqa_roots
    theirs_ds = build(jdatasets, JaxDictionary, "concat", root_j, "resident")
    mine_ds = build(datasets, Dictionary, "concat", root_p, "resident")
    kw = dict(LOADERS[case], seed=5)
    if kw.get("sparse_target_k") == -1:
        kw["sparse_target_k"] = jbatching.max_target_labels(theirs_ds)
    theirs = jbatching.BatchLoader(theirs_ds, 7, **kw)
    mine = batching.PrefetchLoader(batching.BatchLoader(mine_ds, 7, **kw))
    assert len(mine) == len(theirs)
    for _ in range(2):
        got, want = list(mine), list(theirs)
        assert len(got) == len(want) == len(theirs)
        for g, w in zip(got, want):
            assert_samples_equal(g, w)


def test_eval_loader_and_target_helpers_bit_equal(vqa_roots, rng):
    root_j, root_p = vqa_roots
    theirs_ds = build(jdatasets, JaxDictionary, "vqa", root_j, "resident")
    mine_ds = build(datasets, Dictionary, "vqa", root_p, "resident")
    want = list(jbatching.make_eval_loader(theirs_ds, 10, use_native=False))
    got = list(batching.make_eval_loader(mine_ds, 10))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert_samples_equal(g, w)
    assert not got[-1]["valid"][4:].any()  # 24 rows: the last batch padded
    target = np.where(rng.rand(17) < 0.3, rng.rand(17), 0.0).astype(np.float32)
    k = int((target > 0).sum()) + 2
    assert_samples_equal(batching.sparsify_target({"target": target.copy()}, k),
                         jbatching.sparsify_target({"target": target.copy()}, k))
    samples = [mine_ds.sample(i) for i in range(3)]
    assert_samples_equal(batching.stack_samples(samples),
                         jbatching.stack_samples(samples))


def test_prefetch_loader_raises_the_inner_error():
    class Broken:
        def __len__(self):
            return 2

        def __iter__(self):
            yield {"x": np.zeros(1)}
            raise RuntimeError("disk gone")

    got = []
    with pytest.raises(RuntimeError, match="disk gone"):
        for b in batching.PrefetchLoader(Broken()):
            got.append(b)
    assert len(got) == 1


def listing(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.mark.parametrize("fixture", ["vqa", "tdiuc"])
def test_synthetic_fixtures_write_the_same_files(tmp_path, fixture):
    """The port's copy of the fixtures writes JAX's files byte for byte
    (pickles, JSON, the GloVe matrix and the HDF5 features' arrays)."""
    import h5py

    roots = [str(tmp_path / side) for side in ("jax", "port")]
    if fixture == "vqa":
        make_vqa_fixture(roots[0], n_train=12, n_val=6, n_images=5, v_dim=8,
                         with_teacher_logits=True)
        synthetic.make_vqa_fixture(roots[1], n_train=12, n_val=6, n_images=5,
                                   v_dim=8, with_teacher_logits=True)
        add_visualgenome_fixture(roots[0], n_questions=10)
        synthetic.add_visualgenome_fixture(roots[1], n_questions=10)
    else:
        make_tdiuc_fixture(roots[0], n_train=8, n_val=4, n_images=4, v_dim=8)
        synthetic.make_tdiuc_fixture(roots[1], n_train=8, n_val=4, n_images=4,
                                     v_dim=8)
    want, got = listing(roots[0]), listing(roots[1])
    assert sorted(got) == sorted(want)
    for name in want:
        if name.endswith(".hdf5"):
            with h5py.File(os.path.join(roots[0], name), "r") as a, \
                    h5py.File(os.path.join(roots[1], name), "r") as b:
                assert sorted(a) == sorted(b)
                for k in a:
                    np.testing.assert_array_equal(np.asarray(a[k]),
                                                  np.asarray(b[k]))
        else:
            assert got[name] == want[name], name


def glove_root(tmp_path):
    """A dataroot whose dictionary lacks half of the question words, with a
    GloVe text file for some of them: tf-idf extends the vocabulary and
    mixes GloVe rows into the new words' embeddings."""
    root = str(tmp_path)
    make_vqa_fixture(root, n_train=24, n_val=16, n_images=8, v_dim=16)
    d = JaxDictionary()
    for w in WORDS[:14]:
        d.add_word(w)
    d.dump_to_file(os.path.join(root, "dictionary.pkl"))
    rs = np.random.RandomState(3)
    np.save(os.path.join(root, "glove6b_init_300d.npy"),
            (rs.randn(d.ntoken, 300) * 0.1).astype(np.float32))
    os.makedirs(os.path.join(root, "glove"))
    with open(os.path.join(root, "glove", "glove.6B.300d.txt"), "w") as f:
        for w in WORDS[10:24]:
            f.write(w + " " + " ".join(f"{x:.5f}" for x in rs.randn(300)) + "\n")
    return root


def test_tfidf_matrix_and_embeddings_match_jax(tmp_path):
    roots = [glove_root(tmp_path / "jax"), str(tmp_path / "port")]
    shutil.copytree(roots[0], roots[1])
    dj = JaxDictionary.load_from_file(os.path.join(roots[0], "dictionary.pkl"))
    dp = Dictionary.load_from_file(os.path.join(roots[1], "dictionary.pkl"))
    names = ("train", "val", "test2015")
    mj, wj = jtfidf.tfidf_from_questions(list(names), dj, roots[0])
    mp, wp = tfidf.tfidf_from_questions(list(names), dp, roots[1])
    assert dp.idx2word == dj.idx2word and len(dp) > 14
    for a in ("row", "col"):
        np.testing.assert_array_equal(getattr(mp, a), getattr(mj, a))
    np.testing.assert_allclose(mp.val, mj.val, rtol=1e-6, atol=1e-6)
    assert mp.shape == mj.shape and wp.shape == wj.shape and wp.size
    np.testing.assert_allclose(wp, wj, rtol=1e-6, atol=1e-6)

    # the loaded tables: fresh dictionaries, the same starting weights
    dj = JaxDictionary.load_from_file(os.path.join(roots[0], "dictionary.pkl"))
    dp = Dictionary.load_from_file(os.path.join(roots[1], "dictionary.pkl"))
    jm = JaxWordEmbedding(dj.ntoken, 300, 0.0, "c")
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(4)))
    pm = WordEmbedding(dp.ntoken, 300, 0.0, "c")
    pm.load_state_dict(torch_state_from_jax(params))
    for first in (True, False):  # computed, then read back from the cache
        want = jtfidf.tfidf_loading(jm, params, roots[0], dj, names=names)
        tfidf.tfidf_loading(pm, roots[1], dp, names=names)
        for name in ("emb", "emb_"):
            np.testing.assert_allclose(getattr(pm, name).detach().numpy(),
                                       np.asarray(want[name]), rtol=1e-6,
                                       atol=1e-6, err_msg=name)
        assert os.path.exists(os.path.join(roots[1], "embed_tfidf_weights.pkl"))
    with open(os.path.join(roots[1], "embed_tfidf_weights.pkl"), "rb") as f:
        cached = pickle.load(f)
    np.testing.assert_array_equal(cached["emb_"], pm.emb_.detach().numpy())


def test_vqa_normalize_is_a_copy():
    from vqatpu.tools import vqa_normalize as jnorm
    from vqatpu_torch.tools import vqa_normalize as pnorm

    assert pnorm.CONTRACTIONS == jnorm.CONTRACTIONS
    for ans in ("Two dogs!", "isnt it", "a red-car, 1,000", "the 3.5 cats",
                "Yes.", "ten o'clock"):
        assert pnorm.preprocess_answer(ans) == jnorm.preprocess_answer(ans)
