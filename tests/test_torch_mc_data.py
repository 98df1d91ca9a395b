"""vqatpu_torch's Visual7W data path against vqatpu's on the CPU, on the
same synthetic dataroot: the fixture's files, ``V7WDataset`` (bottom-up
and grid features) field for field, ``expand_mc_batch``, ``ZeroArray``,
the card-resident store's gather of repeated ``ds_idx`` bit-equal to the
expanded wire batch on every ``transfer_dtype``, the C++ loader's MC
batches, and ``evaluate_mc`` (host wire and store) exactly equal to JAX's.
"""

import filecmp
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vqatpu.config import ModelConfig as JaxModelConfig
from vqatpu.data import BatchLoader as JaxBatchLoader
from vqatpu.data import V7WDataset as JaxV7W
from vqatpu.data import mc_dataset as jmc
from vqatpu.data.dictionary import Dictionary as JaxDictionary
from vqatpu.data.features import ZeroArray as JaxZeroArray
from vqatpu.data.synthetic import make_v7w_fixture as jax_make_v7w_fixture
from vqatpu.eval import mc as jax_eval_mc
from vqatpu.models import build_model as jax_build_model
from vqatpu_torch.config import ModelConfig
from vqatpu_torch.data import (BatchLoader, Dictionary, V7WDataset, ZeroArray,
                               expand_mc_batch)
from vqatpu_torch.data.device_store import DeviceFeatureStore
from vqatpu_torch.data.native import NativeBatchLoader
from vqatpu_torch.data.synthetic import (add_v7w_grid_fixture,
                                         make_v7w_fixture)
from vqatpu_torch.eval.mc import evaluate_mc
from vqatpu_torch.models import build_model
from vqatpu_torch.train.steps import wire_cast
from vqatpu_torch.weights import load_jax_params, numpy_params

WIRES = ("float32", "float16", "bfloat16", "int8")
FEATURES = ("bottom-up", "grid")
V_DIM, N_IMAGES = 16, 6


def max_boxes(feature):
    return 196 if feature == "grid" else 20


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The fixture written by each package from the same seed, and the grid
    path's files beside the port's: (JAX's root, the port's root)."""
    base = tmp_path_factory.mktemp("v7w")
    jroot, proot = str(base / "jax"), str(base / "port")
    jax_make_v7w_fixture(jroot, n_train=20, n_val=10, n_images=N_IMAGES,
                         v_dim=V_DIM)
    make_v7w_fixture(proot, n_train=20, n_val=10, n_images=N_IMAGES,
                     v_dim=V_DIM)
    add_v7w_grid_fixture(proot, n_images=N_IMAGES, v_dim=V_DIM)
    return jroot, proot


def load(root, split, port, feature="bottom-up", **kw):
    dict_cls, ds_cls = ((Dictionary, V7WDataset) if port
                        else (JaxDictionary, JaxV7W))
    d = dict_cls.load_from_file(os.path.join(root, "dictionary.pkl"))
    return ds_cls(split, d, dataroot=root, max_boxes=max_boxes(feature),
                  use_feature=feature, **kw)


def test_fixture_writes_jax_files(roots):
    """Every file of JAX's fixture, byte for byte (pickles by content, the
    feature file by its arrays)."""
    jroot, proot = roots
    names = []
    for dirpath, _, files in os.walk(jroot):
        for f in files:
            names.append(os.path.relpath(os.path.join(dirpath, f), jroot))
    assert len(names) >= 15
    for name in sorted(names):
        a, b = os.path.join(jroot, name), os.path.join(proot, name)
        if name.endswith((".json", ".npy")):
            assert filecmp.cmp(a, b, shallow=False), name
        elif name.endswith(".pkl"):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert pickle.load(fa) == pickle.load(fb), name
        else:
            import h5py
            with h5py.File(a) as ha, h5py.File(b) as hb:
                assert set(ha) == set(hb)
                for k in ha:
                    np.testing.assert_array_equal(ha[k][()], hb[k][()])


@pytest.mark.parametrize("feature", FEATURES)
def test_v7w_dataset_matches_jax(roots, feature):
    """Entries, tokens (the MC tokenizer strips '.') and every field of
    every sample, on the JAX dataset built over the port's dataroot."""
    proot = roots[1]
    for split in ("train", "val"):
        jds, pds = load(proot, split, False, feature), load(proot, split,
                                                            True, feature)
        assert len(jds) == len(pds) and pds.v_dim == jds.v_dim == V_DIM
        assert pds.s_dim == jds.s_dim == (V_DIM if feature == "grid" else 6)
        assert pds.num_ans_candidates == jds.num_ans_candidates
        for i in range(len(pds)):
            want, got = jds.sample(i), pds.sample(i)
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got["ans_mc"].shape == (4, 6) and got["label"].sum() == 1
            if feature == "grid":
                assert got["v_mask"].all() and not got["b"].any()
            for k, v in jds.entries[i].items():
                np.testing.assert_array_equal(pds.entries[i][k], v)


def test_streaming_grid_store_takes_the_zero_stand_in(roots):
    pds = load(roots[1], "val", True, "grid", features_in_memory=False)
    assert isinstance(pds.store.spatials, ZeroArray)
    jds = load(roots[1], "val", False, "grid")
    for i in (0, len(pds) - 1):
        for k, x in jds.sample(i).items():
            np.testing.assert_array_equal(pds.sample(i)[k], x)
    pds.store.close()


def test_zero_array_matches_jax():
    z, jz = ZeroArray((4, 3, 5)), JaxZeroArray((4, 3, 5))
    assert z.shape == jz.shape and z.dtype == jz.dtype == np.float32
    for idx in (1, np.int64(2), slice(1, 3), slice(None, None, 2)):
        np.testing.assert_array_equal(z[idx], jz[idx])
    np.testing.assert_array_equal(np.asarray(z), np.asarray(jz))
    with pytest.raises(TypeError):
        z[[0, 1]]


def test_expand_mc_batch_matches_jax(roots):
    """A wire batch (its last rows padding) and a fields-only one with
    ``ds_idx`` and an int8 ``v_scale``: every key equal to JAX's."""
    pds = load(roots[1], "val", True)
    batch = next(iter(BatchLoader(pds, 16)))
    batch["v_scale"] = np.random.RandomState(0).rand(16, 20).astype(np.float32)
    fields = next(iter(BatchLoader(pds, 16, fields_only=True)))
    for b in (batch, fields):
        got, want = expand_mc_batch(dict(b)), jmc.expand_mc_batch(dict(b))
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["q"].shape == (64, 12) and got["a"].shape == (64, 6)
    assert (got["ds_idx"][-8:] == -1).all()  # the padded questions


def as_numpy(x):
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    return np.asarray(x)


@pytest.mark.parametrize("feature", FEATURES)
@pytest.mark.parametrize("wire", WIRES)
def test_tiled_gather_equals_the_wire(roots, wire, feature):
    """The store's gather of a fields-only batch's repeated ``ds_idx``, bit
    for bit and dtype for dtype, the wire-cast expanded batch (20 train
    questions in batches of 8: the last has 4 padded questions)."""
    pds = load(roots[1], "train", True, feature)
    store = DeviceFeatureStore.build(pds, transfer_dtype=wire, device="cpu")
    pairs = zip(BatchLoader(pds, 8, fields_only=True), BatchLoader(pds, 8))
    for n, (fields, full) in enumerate(pairs, 1):
        ex = expand_mc_batch(fields)
        got = store.gather(ex["ds_idx"])
        want = wire_cast({k: v for k, v in expand_mc_batch(full).items()
                          if k in ("v", "b", "v_mask")}, wire)
        for k in want:
            g, w = as_numpy(got[k]), as_numpy(want[k])
            assert g.dtype == w.dtype and g.shape[0] == 32, (k, g.dtype)
            np.testing.assert_array_equal(g, w, err_msg=k)
    assert n == 3


@pytest.mark.parametrize("quantize", [False, True])
def test_native_loader_gives_the_python_batches(roots, quantize):
    pds = load(roots[1], "train", True)
    native = NativeBatchLoader(pds, 8, shuffle=True, seed=3, quantize=quantize)
    try:
        python = BatchLoader(pds, 8, shuffle=True, seed=3)
        for got, want in zip(native, python):
            if quantize:  # v quantized on assembly; the wire casts b
                got, want = wire_cast(got, "int8"), wire_cast(want, "int8")
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    finally:
        native.close()


@pytest.mark.parametrize("dims", [dict(model="tan", h_mm=8, rank=2),
                                  dict(model="ban", use_counter=True)])
def test_evaluate_mc_matches_jax(roots, dims):
    """Accuracy over the val split in batches of 4 (the last padded):
    exactly JAX's, on the host wire and through the store (which drops
    the gathered mask, as JAX does)."""
    pds = load(roots[1], "val", True)
    jds = load(roots[1], "val", False)
    kw = dict(ntoken=pds.dictionary.ntoken, v_dim=V_DIM,
              num_ans_candidates=pds.num_ans_candidates, num_hid=16, gamma=2,
              task="mc", **dims)
    params = numpy_params(ModelConfig(**kw), seed=5)
    model = load_jax_params(build_model(ModelConfig(**kw)), params).eval()
    want, bound = jax_eval_mc.evaluate_mc(
        jax_build_model(JaxModelConfig(**kw)),
        jax.tree.map(jnp.asarray, params), JaxBatchLoader(jds, 4))
    store = DeviceFeatureStore.build(pds, device="cpu")
    got = (evaluate_mc(model, BatchLoader(pds, 4)),
           evaluate_mc(model, BatchLoader(pds, 4, fields_only=True),
                       dev_store=store))
    assert got[0] == got[1] == (want, bound) and bound == 1.0
    assert 0.0 <= want <= 1.0
