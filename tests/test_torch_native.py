"""vqatpu_torch's C++ host runtime (``vqatpu_torch/native/vqadata.cc``, built
by ``vqatpu_torch.data.native``) against vqatpu's Python data path and its
own native runtime, on the same synthetic fixtures.

- The build: into ``vqatpu_torch/_build`` with ``-ffp-contract=off``, a
  failed build raising with the compiler's output, processes that build at
  once all loading a whole library.
- ``quantize_rows``: bit for bit the numpy plain version
  (``vqatpu_torch.data.quantize``) and JAX's quantizer, all-zero rows,
  exact ties at .5 and a brute-force hunt of FMA-sensitive roundings.
- ``NativeFeatureStore.assemble``: float32 and int8-resident stores,
  equal to ``FeatureStore.get`` row by row.
- ``NativeBatchLoader``: every batch of every epoch equal to JAX's Python
  ``BatchLoader`` (and, on the int8 wire, its ``quantize_v``) and to JAX's
  ``NativeBatchLoader``: sequential with the padded final batch, shuffled
  with the same seed, quantized, over an int8-resident store, over the
  ``--use_both --use_vg`` concat (two stores for four members) and its q8
  wire; batches held as ``torch.from_numpy`` tensors survive the ring's
  recycling.
- ``make_eval_loader`` and the training loop take it where JAX's do.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from vqatpu.data import BatchLoader as JaxBatchLoader
from vqatpu.data import ConcatDataset as JaxConcat
from vqatpu.data import VisualGenomeFeatureDataset as JaxVG
from vqatpu.data import VQAFeatureDataset as JaxVQA
from vqatpu.data import native as jnative
from vqatpu.data.dictionary import Dictionary as JaxDictionary
from vqatpu.data.synthetic import add_visualgenome_fixture, make_vqa_fixture
from vqatpu.train.steps import quantize_v
from vqatpu_torch.data import batching, native
from vqatpu_torch.data.datasets import (ConcatDataset,
                                        VisualGenomeFeatureDataset,
                                        VQAFeatureDataset)
from vqatpu_torch.data.dictionary import Dictionary
from vqatpu_torch.data.quantize import quantize_rows as plain_quantize

ROOT = Path(__file__).resolve().parents[1]
MAX_BOXES = 16


def twin(tmp_path_factory, name, vg=False, **fixture):
    """The same dataroot twice, (JAX's copy, the port's copy)."""
    root = str(tmp_path_factory.mktemp(name))
    make_vqa_fixture(root, **fixture)
    if vg:
        add_visualgenome_fixture(root)
    shutil.copytree(root, root + "_port")
    return root, root + "_port"


def load(root, split, port, max_boxes=MAX_BOXES, **kw):
    dict_cls, ds_cls = ((Dictionary, VQAFeatureDataset) if port
                        else (JaxDictionary, JaxVQA))
    d = dict_cls.load_from_file(os.path.join(root, "dictionary.pkl"))
    return ds_cls(split, d, dataroot=root, max_boxes=max_boxes, **kw)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    return twin(tmp_path_factory, "native_vqa", n_train=40, n_val=8,
                n_images=12, v_dim=32)


@pytest.fixture(scope="module")
def concat_roots(tmp_path_factory):
    return twin(tmp_path_factory, "native_concat", vg=True, n_train=24,
                n_val=16, n_images=8, v_dim=16)


def concat(root, port, members=("train", "val", "vg_train", "vg_val")):
    """train + val + VisualGenome on both splits' stores (VG shares them)."""
    vg_cls, cat_cls = ((VisualGenomeFeatureDataset, ConcatDataset) if port
                       else (JaxVG, JaxConcat))
    splits = {s: load(root, s, port, max_boxes=12) for s in ("train", "val")}
    parts = []
    for m in members:
        if m.startswith("vg_"):
            base = splits[m[3:]]
            parts.append(vg_cls(m[3:], base.store, base.dictionary,
                                dataroot=root, max_boxes=12,
                                img_id2idx=base.img_id2idx))
        else:
            parts.append(splits[m])
    return cat_cls(parts)


def assert_batches_equal(got, want, quantized=False):
    """Port batch ``got`` against a JAX batch ``want``; with ``quantized``,
    against JAX's ``quantize_v`` of its float32 ``v``."""
    if quantized:
        want = dict(want)
        want["v"], want["v_scale"] = quantize_v(want["v"])
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- the build --------------------------------------------------------------

def test_builds_into_the_port_with_its_flags():
    lib = native.load()
    path = native.library_path()
    assert path.parent == ROOT / "vqatpu_torch" / "_build" and path.exists()
    assert "-ffp-contract=off" in native.CXX_FLAGS
    assert native.SOURCE == ROOT / "vqatpu_torch" / "native" / "vqadata.cc"
    assert lib is native.load()
    cmd = native.build_command("out.so")
    assert str(native.SOURCE) in cmd and "-ffp-contract=off" in cmd


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "vqadata.cc"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="vqadata.cc"):
        native.build()
    assert not any((tmp_path / "_build").iterdir())  # nothing half-built


BUILD_ONE = """
import sys
from pathlib import Path
from vqatpu_torch.data import native
native.BUILD_DIR = Path(sys.argv[1])
native.load()
q, s = native.quantize_rows([[0.0, 1.0, -2.0]])
print(q.tolist(), s.tolist())
"""


def test_concurrent_builds_all_load(tmp_path):
    """Processes that build at once (pytest's workers do) write temporary
    files and rename them: each loads a whole library."""
    procs = [subprocess.Popen(
        [sys.executable, "-c", BUILD_ONE, str(tmp_path / "_build")], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(3)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    assert {o for o, _ in outs} == {"[[0, 64, -127]] [0.015748031437397003]\n"}
    built = list((tmp_path / "_build").iterdir())
    assert len(built) == 1 and built[0].suffix == ".so", built


# -- the quantizer ----------------------------------------------------------

def test_quantize_rows_equals_the_plain_version_and_jax(rng):
    v = (rng.randn(7, 5, 64) * rng.rand(7, 5, 1) * 10).astype(np.float32)
    v[2, 1] = 0.0
    q, s = native.quantize_rows(v)
    for want_q, want_s in (plain_quantize(v), jnative.quantize_rows_any(v)):
        np.testing.assert_array_equal(s, want_s)
        np.testing.assert_array_equal(q, want_q)
    assert s[2, 1] == 1.0 and not q[2, 1].any()
    # ties at .5 round half to even: absmax 254 makes the scale exactly 2
    ties = np.array([[1.0, 3.0, 5.0, -1.0, -3.0, -5.0, 254.0, 0.0]],
                    np.float32)
    qt, st = native.quantize_rows(ties)
    assert st[0] == 2.0
    np.testing.assert_array_equal(
        qt[0], np.array([0, 2, 2, 0, -2, -2, 127, 0], np.int8))
    np.testing.assert_array_equal(qt, plain_quantize(ties)[0])
    # idempotent: re-quantizing the dequantized rows gives them back
    np.testing.assert_array_equal(
        native.quantize_rows(q * s[..., None])[0], q)


@pytest.mark.parametrize("num_threads", [1, 8])
def test_quantize_rows_no_fma_divergence(num_threads):
    """4.2M elements whose products land near .5 at ppm rates: a fused
    multiply-add in the rounding would leave np.rint on some of them."""
    rng = np.random.RandomState(123)
    v = (rng.randn(2048, 41, 50).astype(np.float32)
         * rng.rand(2048, 41, 1).astype(np.float32) * 30)
    q, s = native.quantize_rows(v, num_threads=num_threads)
    want_q, want_s = plain_quantize(v)
    np.testing.assert_array_equal(s, want_s)
    np.testing.assert_array_equal(q, want_q)


# -- NativeFeatureStore -------------------------------------------------------

@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "q8store"])
def test_assemble_equals_store_get(roots, quantized):
    ds = load(roots[1], "train", True, quantize_features=quantized)
    store = native.NativeFeatureStore(ds.store)
    assert store.quantized == quantized
    idx = np.asarray([e["image"] for e in ds.entries[:10]], np.int64)
    v, b, mask = store.assemble(idx, MAX_BOXES)
    for i, image in enumerate(idx):
        pv, pb, pm = ds.store.get(int(image), MAX_BOXES)
        np.testing.assert_array_equal(v[i], pv)
        np.testing.assert_array_equal(b[i], pb)
        np.testing.assert_array_equal(mask[i], pm)


# -- NativeBatchLoader --------------------------------------------------------

LOADERS = {
    # name: (loader kwargs, epochs, int8-resident store)
    "sequential": (dict(batch_size=16), 1, False),
    "shuffled": (dict(batch_size=8, shuffle=True, seed=77, drop_last=True),
                 3, False),
    "q8": (dict(batch_size=16, shuffle=True, seed=5, quantize=True), 2,
           False),
    "q8store": (dict(batch_size=16, shuffle=True, seed=9), 2, True),
    "q8store_q8": (dict(batch_size=16, shuffle=True, seed=9, quantize=True),
                   2, True),
}


@pytest.mark.parametrize("case", sorted(LOADERS))
def test_loader_equals_jax_loaders(roots, case):
    """Against JAX's Python loader (and its quantize_v on the int8 wire),
    and JAX's own native loader, over every epoch."""
    kw, epochs, q8store = LOADERS[case]
    quantize = kw.get("quantize", False)
    jds = load(roots[0], "train", False, quantize_features=q8store)
    pds = load(roots[1], "train", True, quantize_features=q8store)
    py_kw = {k: x for k, x in kw.items() if k != "quantize"}
    want_py = JaxBatchLoader(jds, **py_kw)
    want_nat = jnative.NativeBatchLoader(jds, **kw)
    got = native.NativeBatchLoader(pds, **kw)
    try:
        for _ in range(epochs):
            batches = list(zip(got, want_py, want_nat))
            assert len(batches) == len(got)
            for g, wp, wn in batches:
                # an int8-resident store under the int8 wire ships its own
                # bytes, equal to quantizing the dequantized rows
                assert_batches_equal(g, wp, quantized=quantize)
                assert_batches_equal(g, wn)
    finally:
        got.close()
        want_nat.close()
    if kw.get("drop_last") is None:
        assert not batches[-1][0]["valid"].all()  # a padded final batch
        assert not batches[-1][0]["v"][~batches[-1][0]["valid"]].any()


@pytest.mark.parametrize("quantize", [False, True], ids=["f32", "q8"])
def test_concat_loader_equals_jax(concat_roots, quantize):
    """``--use_both --use_vg``: four members on two stores, a (store,
    image) per row; two shuffled epochs."""
    jds, pds = concat(concat_roots[0], False), concat(concat_roots[1], True)
    kw = dict(batch_size=8, shuffle=True, seed=5, drop_last=True)
    want = JaxBatchLoader(jds, **kw)
    got = native.NativeBatchLoader(pds, quantize=quantize, **kw)
    assert len(got.stores) == 2
    try:
        for _ in range(2):
            for g, w in zip(got, want):
                assert_batches_equal(g, w, quantized=quantize)
    finally:
        got.close()


def test_held_batches_survive_slot_recycling(roots):
    """Tensors that alias yielded batches (``torch.from_numpy``) keep their
    values while the ring recycles its slots many times over."""
    pds = load(roots[1], "train", True)
    want = [{k: np.array(x) for k, x in b.items()} for b in
            batching.BatchLoader(pds, 8, shuffle=True, seed=3,
                                 drop_last=True)]
    got = native.NativeBatchLoader(pds, 8, shuffle=True, seed=3,
                                   drop_last=True)
    try:
        held = [(torch.from_numpy(b["v"]), torch.from_numpy(b["b"]))
                for b in got]
        for (v, b), w in zip(held, want):
            np.testing.assert_array_equal(v.numpy(), w["v"])
            np.testing.assert_array_equal(b.numpy(), w["b"])
    finally:
        got.close()
    assert len(held) == len(want) == 5


def test_make_eval_loader_takes_the_native_loader_where_jax_does(roots):
    pds = load(roots[1], "train", True)
    got = batching.make_eval_loader(pds, 16)
    assert type(got) is native.NativeBatchLoader
    try:
        gb = list(got)
        wb = list(batching.BatchLoader(pds, 16))
        assert len(gb) == len(wb) == 3  # 40 rows: 16, 16, 8 and padding
        for g, w in zip(gb, wb):
            assert_batches_equal(g, w)
        assert int(gb[-1]["valid"].sum()) == 8
    finally:
        got.close()
    streaming = load(roots[1], "train", True, features_in_memory=False)
    for ds, kw in ((streaming, {}), (pds, dict(use_native=False)),
                   (pds, dict(fields_only=True))):
        assert type(batching.make_eval_loader(ds, 16, **kw)) is \
            batching.PrefetchLoader


@pytest.mark.parametrize("wire", ["float32", "int8"])
def test_training_loop_native_equals_python(roots, tmp_path, wire):
    """``train()`` through the C++ loader (quantized on assembly on the
    int8 wire) and through the Python loader: the same log lines and
    params; the loop logs the Python loader's reason for a streaming
    store, as JAX's does."""
    from vqatpu_torch.config import ModelConfig, TrainConfig
    from vqatpu_torch.models import build_model
    from vqatpu_torch.train import loop

    pds = load(roots[1], "train", True)
    mcfg = ModelConfig(ntoken=pds.dictionary.ntoken, v_dim=pds.v_dim,
                       num_ans_candidates=pds.num_ans_candidates,
                       model="cti", num_hid=16, h_mm=8, rank=2, gamma=2)
    cfg = TrainConfig(epochs=2, batch_size=8, update_freq=1, saving_epoch=99,
                      transfer_dtype=wire, device_features="off")
    params, lines = [], []
    for use_native in (True, False):
        model = build_model(mcfg)
        out = str(tmp_path / f"native_{use_native}")
        loop.train(model, pds, None, cfg, out, use_native_loader=use_native,
                   device="cpu", print_interval=10 ** 6)
        params.append({k: x.clone() for k, x in model.state_dict().items()})
        text = open(os.path.join(out, "log.txt")).read()
        lines.append([ln for ln in text.splitlines() if "train_loss" in ln])
        assert "native loader OFF" not in text
    assert lines[0] == lines[1] and len(lines[0]) == 2
    for k in params[0]:
        assert torch.equal(params[0][k], params[1][k]), k
    streaming = load(roots[1], "train", True, features_in_memory=False)
    out = str(tmp_path / "streaming")
    loop.train(build_model(mcfg), streaming, None,
               TrainConfig(epochs=1, batch_size=8, saving_epoch=99,
                           device_features="off"), out, device="cpu",
               print_interval=10 ** 6)
    assert ("native loader OFF (dataset has no in-memory FeatureStore "
            "(streaming or MC)); using Python loader") in open(
                os.path.join(out, "log.txt")).read()
