"""vqatpu_torch's ``.orbax`` checkpoints (``vqatpu_torch/train/zstd.py``,
``ocdbt.py``, ``zarr2.py``, ``checkpoints.py``) against vqatpu's, orbax's
and tensorstore's, on the CPU at small width.

- The port reads JAX's ``save_checkpoint_orbax`` (one process, and a state
  sharded on the 4x2 mesh), every leaf bit-equal to
  ``ocp.PyTreeCheckpointer().restore``, and restores it into a port
  state; JAX's train loop with ``ckpt_backend="orbax"`` (BAN, and the MC
  task) read by the port's ``load_params_any``; the MC CLIs train with
  ``--ckpt_backend orbax`` and read it back.
- JAX's ``restore_train_state_orbax`` and ``load_params_any`` read the
  port's ``save_checkpoint_orbax`` and its loop's ``.orbax`` bit for bit,
  and the port's ``_METADATA`` tree equals the one JAX writes.
- A step from either side's restored state matches the uninterrupted one
  within the trajectory contract (1e-4 on loss, grad norm and params).
- The OCDBT reader and the zarr reader and writer against tensorstore's:
  B+tree interior nodes, several versions, indirect values; each dtype,
  chunk grids with edges, missing chunks, both separators, no compressor.
- The goldens of ``tests/torch_orbax_goldens.py`` (chip_smoke phase 15's;
  a two-process save of a weight split over the processes, a chunk grid
  in ``ocdbt.process_0/`` and ``ocdbt.process_1/``).
- Damaged files, unknown codecs, older layouts, an existing target and a
  missing ``libzstd.so.1`` raise.
"""

import json
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import orbax.checkpoint as ocp
import tensorstore as ts

from vqatpu.config import ModelConfig as JaxModelConfig
from vqatpu.config import TrainConfig as JaxTrainConfig
from vqatpu.data import datasets as jdatasets
from vqatpu.data.dictionary import Dictionary as JaxDictionary
from vqatpu.data.synthetic import make_v7w_fixture, make_vqa_fixture
from vqatpu.models import build_model as jax_build_model
from vqatpu.train import checkpoints as jckpt
from vqatpu.train import loop as jloop
from vqatpu.train import steps as jsteps
from vqatpu_torch.config import ModelConfig, TrainConfig
from vqatpu_torch.data import datasets
from vqatpu_torch.data.dictionary import Dictionary
from vqatpu_torch.models import build_model
from vqatpu_torch.serve import InferenceSession
from vqatpu_torch.train import checkpoints as pckpt
from vqatpu_torch.train import loop as ploop
from vqatpu_torch.train import make_train_state, make_train_step
from vqatpu_torch.train import ocdbt, zarr2, zstd
from vqatpu_torch.weights import (jax_params_from_torch, load_jax_params,
                                  numpy_batch, numpy_params)
from tests import torch_orbax_goldens as goldens

TOL = 1e-4
# tests/test_models.py's widths; 16 answers so the 4x2 mesh's model axis
# divides the classifier (tests/test_train.py's sharded orbax test)
SMALL = dict(ntoken=50, v_dim=32, num_ans_candidates=16, model="cti",
             num_hid=32, h_mm=16, rank=4, gamma=2)
DETERMINISTIC = dict(update_freq=1, deterministic=True)


def batch(seed):
    return numpy_batch(ModelConfig(**SMALL), 4, seed=seed, boxes=8,
                       real_boxes=6, target=True)


def jax_batch(b):
    return {k: jnp.asarray(x.astype(np.int32) if x.dtype == np.int64 else x)
            for k, x in b.items()}


def jax_state(tfidf_loaded=False, optim_state_dtype="float32"):
    """JAX's fresh state with ``numpy_params(SMALL, 3)``."""
    model = jax_build_model(JaxModelConfig(**SMALL))
    state = jsteps.make_train_state(model, jax.random.PRNGKey(0),
                                    tfidf_loaded=tfidf_loaded,
                                    optim_state_dtype=optim_state_dtype)
    return state._replace(params=jax.tree.map(
        jnp.asarray, numpy_params(ModelConfig(**SMALL), 3)))


@pytest.fixture(scope="module")
def jax_side():
    """JAX's step (``emb_`` frozen, float32 Adamax), compiled once: the
    state after step 1 (numpy leaves, since the jitted step donates its
    input) and the uninterrupted step 2's state and metrics."""
    model = jax_build_model(JaxModelConfig(**SMALL))
    step = jsteps.make_train_step(model, JaxTrainConfig(**DETERMINISTIC))
    state, _ = step(jax_state(), jax_batch(batch(0)), jnp.float32(1e-3),
                    jax.random.PRNGKey(1), False)
    state1 = jax.tree.map(np.asarray, state)
    state2, metrics2 = step(state, jax_batch(batch(1)), jnp.float32(1e-3),
                            jax.random.PRNGKey(1), False)
    return dict(model=model, step=step, state1=state1,
                state2=jax.tree.map(np.asarray, state2),
                metrics2={k: np.asarray(v) for k, v in metrics2.items()})


def on_device(state):
    return jax.tree.map(jnp.asarray, state)


def port_state(tfidf_loaded=False, optim_state_dtype="float32", steps=1):
    """The port's state from the same params after ``steps`` updates, and
    its step function."""
    model = build_model(ModelConfig(**SMALL))
    load_jax_params(model, numpy_params(ModelConfig(**SMALL), 3))
    state = make_train_state(model, tfidf_loaded=tfidf_loaded,
                             optim_state_dtype=optim_state_dtype,
                             device="cpu")
    step = make_train_step(model, TrainConfig(
        **DETERMINISTIC, optim_state_dtype=optim_state_dtype),
        tfidf_loaded=tfidf_loaded)
    for i in range(steps):
        step(state, batch(i), 1e-3)
    return state, step


def fresh_port_state(tfidf_loaded=False, optim_state_dtype="float32"):
    model = build_model(ModelConfig(**SMALL))
    return make_train_state(model, seed=42, tfidf_loaded=tfidf_loaded,
                            optim_state_dtype=optim_state_dtype,
                            device="cpu")


def assert_same_tree(got, want, path=""):
    """Structure, container types, dtypes and every bit (bfloat16 leaves
    of ``want`` compared as float32, as the port reads them)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f"{path}/{i}")
    elif want is None:
        assert got is None, path
    else:
        w = np.asarray(want)
        if w.dtype.name == "bfloat16":
            w = w.astype(np.float32)
        assert isinstance(got, np.ndarray) and got.dtype == w.dtype, path
        np.testing.assert_array_equal(got, w, err_msg=path)


def adamax_of(opt_state):
    inner = opt_state.inner_state[0]
    return getattr(inner, "inner_state", inner)


def assert_port_state_equals_jax(state, jstate):
    """The port's params, Adamax m, u and count and update count equal to
    a JAX state's, bit for bit."""
    assert_same_tree(jax_params_from_torch(state.model.state_dict()),
                     jax.tree.map(np.asarray, jstate.params))
    ad = adamax_of(jstate.opt_state)
    assert state.optimizer.count == int(ad.count)
    assert state.step == int(jstate.step)
    m, u = pckpt._moment_trees(state, lambda k, i, p: (
        state.optimizer.m, state.optimizer.u)[k][i].float().numpy())
    for mine, theirs in ((m, ad.m), (u, ad.u)):
        flat = pckpt._flatten(mine)
        for path, leaf in pckpt._flatten(jax.tree.map(
                lambda x: x, theirs, is_leaf=lambda x: x is None)).items():
            if flat[path] is None:
                assert not hasattr(leaf, "shape"), path  # MaskedNode
            else:
                np.testing.assert_array_equal(
                    flat[path], np.asarray(leaf, np.float32), err_msg=path)


# -- (a) JAX's save_checkpoint_orbax, read by the port -----------------------

@pytest.mark.parametrize("layout", ["one process", "sharded 4x2"])
def test_port_reads_jax_orbax(tmp_path, jax_side, layout):
    """Every leaf bit-equal to orbax's restore, and the train state (params,
    Adamax, counts, epoch) to JAX's.  Sharded on the 4x2 mesh, JAX's save
    goes through numpy (one chunk an array); orbax's chunk grids of split
    ``jax.Array`` leaves are read in ``test_two_process_golden`` and
    ``test_zarr_arrays_match_tensorstore``."""
    state = on_device(jax_side["state1"])
    if layout == "sharded 4x2":
        from vqatpu.parallel import make_mesh_2d, replicate, shard_params

        mesh = make_mesh_2d(4, 2)
        state = jsteps.TrainState(
            params=shard_params(state.params, mesh),
            opt_state=replicate(state.opt_state, mesh),
            grad_accum=shard_params(state.grad_accum, mesh),
            accum_count=replicate(state.accum_count, mesh),
            step=replicate(state.step, mesh))
    path = str(tmp_path / "jax.orbax")
    jckpt.save_checkpoint_orbax(path, state, epoch=2)
    assert json.load(open(os.path.join(path, "_METADATA")))["use_ocdbt"]
    assert_same_tree(pckpt.restore_orbax(path),
                     ocp.PyTreeCheckpointer().restore(path))
    restored, start = pckpt.restore_train_state_orbax(path,
                                                      fresh_port_state())
    assert start == 3 and restored.grad_accum is None
    assert_port_state_equals_jax(restored, state)
    assert restored.optimizer.lr == float(
        state.opt_state.hyperparams["learning_rate"])


# -- (b) JAX's loop with ckpt_backend="orbax", read by the port ---------------

@pytest.mark.parametrize("task", ["ffoe", "mc"])
def test_port_loads_jax_loop_orbax(tmp_path, task):
    """JAX's ``train`` with ``ckpt_backend="orbax"`` (BAN as in
    ``tests/test_end_to_end.py``; CTI on the Visual7W fixture), then the
    port's ``load_params_any``: JAX's final params, bit for bit."""
    root = str(tmp_path / "data")
    if task == "ffoe":
        make_vqa_fixture(root, n_train=16, n_val=8, n_images=6, v_dim=16)
        d = JaxDictionary.load_from_file(os.path.join(root, "dictionary.pkl"))
        train_ds = jdatasets.VQAFeatureDataset("train", d, dataroot=root,
                                               max_boxes=12)
        kw = dict(model="ban", num_hid=16)
    else:
        from vqatpu.data.mc_dataset import V7WDataset

        make_v7w_fixture(root, n_train=8, n_val=4, n_images=4, v_dim=16)
        d = JaxDictionary.load_from_file(os.path.join(root, "dictionary.pkl"))
        train_ds = V7WDataset("train", d, dataroot=root, max_boxes=12)
        kw = dict(model="san", task="mc", num_hid=16)
    mkw = dict(kw, ntoken=d.ntoken, v_dim=16,
               num_ans_candidates=train_ds.num_ans_candidates)
    model = jax_build_model(JaxModelConfig(**mkw))
    out = str(tmp_path / "out")
    state = jloop.train(model, train_ds, None, JaxTrainConfig(
        epochs=1, batch_size=4, update_freq=1, saving_epoch=0,
        device_features="off", ckpt_backend="orbax"), out,
        task=task, use_mesh=False, use_native_loader=False)
    assert os.path.isdir(os.path.join(out, "model_epoch0.orbax"))
    params = pckpt.load_params_any(out, 0, build_model(ModelConfig(**mkw)))
    assert_same_tree(params, jax.tree.map(np.asarray, state.params))


# -- (c) the port's save and loop, read by JAX --------------------------------

@pytest.mark.parametrize("tfidf_loaded,state_dtype", [
    (False, "float32"), (True, "bfloat16")],
    ids=["emb_-frozen", "tfidf-bf16-moments"])
def test_jax_reads_port_orbax(tmp_path, tfidf_loaded, state_dtype):
    """JAX's ``restore_train_state_orbax`` of the port's save: params,
    Adamax m, u (in their storage dtype) and counts bit-equal, epoch and
    step; orbax's ``_METADATA`` tree equals the one JAX writes for the
    same state; the target may not exist."""
    state, _ = port_state(tfidf_loaded, state_dtype)
    path = str(tmp_path / "port.orbax")
    pckpt.save_checkpoint_orbax(path, state, epoch=4)
    assert sorted(os.listdir(tmp_path)) == ["port.orbax"]  # no tmp left
    jstate = jax_state(tfidf_loaded, state_dtype)
    restored, start = jckpt.restore_train_state_orbax(path, jstate)
    assert start == 5
    assert_port_state_equals_jax(state, restored)
    assert adamax_of(restored.opt_state).m["classifier"]["l1"]["v"].dtype \
        == jnp.dtype(state_dtype)
    ref = str(tmp_path / "jax.orbax")
    jckpt.save_checkpoint_orbax(ref, jstate, epoch=4)
    meta, want = (json.load(open(os.path.join(p, "_METADATA")))
                  for p in (path, ref))
    assert meta["tree_metadata"] == want["tree_metadata"]
    assert list(meta["tree_metadata"]) == list(want["tree_metadata"])
    assert not meta["use_ocdbt"] and not meta["use_zarr3"]
    with pytest.raises(FileExistsError):
        pckpt.save_checkpoint_orbax(path, state, epoch=5)


@pytest.fixture(scope="module")
def vqa_roots(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data_vqa"))
    make_vqa_fixture(root, n_train=16, n_val=8, n_images=6, v_dim=16)
    return root


def test_port_loop_writes_orbax_that_jax_reads(vqa_roots, tmp_path):
    """The port's loop with ``ckpt_backend="orbax"`` writes
    ``model_epoch{N}.orbax`` and ``model_epoch_best.orbax`` (no
    ``.ckpt``), replacing the best slot on a resumed run's new best; JAX's
    ``load_params_any`` gives the final params, bit for bit, and the port
    restores its state.  Other backends raise."""
    d = Dictionary.load_from_file(os.path.join(vqa_roots, "dictionary.pkl"))
    tr, va = (datasets.VQAFeatureDataset(s, d, dataroot=vqa_roots,
                                         max_boxes=12)
              for s in ("train", "val"))
    kw = dict(model="cti", num_hid=16, h_mm=8, rank=2, ntoken=d.ntoken,
              v_dim=16, num_ans_candidates=tr.num_ans_candidates)
    model = build_model(ModelConfig(**kw))
    out = str(tmp_path / "out")
    state = None
    for epochs in (1, 2):  # the second run writes a new best over the first
        state = ploop.train(model, tr, va, TrainConfig(
            epochs=epochs, batch_size=4, saving_epoch=0,
            ckpt_backend="orbax", deterministic=True), out, state=state,
            start_epoch=epochs - 1, use_native_loader=False, device="cpu",
            best_eval=-1.0)
    assert sorted(f for f in os.listdir(out) if f != "log.txt") == [
        "model_epoch0.orbax", "model_epoch1.orbax", "model_epoch_best.orbax"]
    jm = jax_build_model(JaxModelConfig(**kw))
    for name in ("1", "_best"):
        params = jckpt.load_params_any(out, name, jm)
        assert_same_tree(jax_params_from_torch(state.model.state_dict()),
                         jax.tree.map(np.asarray, params))
    fresh = make_train_state(build_model(ModelConfig(**kw)), device="cpu")
    fresh, start = pckpt.restore_train_state_orbax(
        os.path.join(out, "model_epoch1.orbax"), fresh)
    assert start == 2 and fresh.step == state.step
    with pytest.raises(ValueError, match="ckpt_backend"):
        ploop.train(model, tr, va, TrainConfig(ckpt_backend="msgpack"), out,
                    device="cpu")


def test_clis_train_and_read_orbax(tmp_path):
    """``mc_train --ckpt_backend orbax`` writes ``model_epoch0.orbax`` (the
    run's params, bit for bit) and no ``.ckpt``; ``mc_test`` and the serve
    CLI's session read it, to the accuracy and the logits they give from
    the same params saved as ``.ckpt``."""
    from vqatpu_torch.cli import mc_test, mc_train
    from vqatpu_torch.cli import serve as cli
    from vqatpu_torch.data.synthetic import make_v7w_fixture as make_v7w

    root = str(tmp_path / "data_v7w")
    make_v7w(root, n_train=8, n_val=4, n_images=4, v_dim=16)
    flags = ["--model", "cti", "--dataroot", root, "--num_hid", "16",
             "--h_mm", "8", "--rank", "2", "--max_boxes", "12",
             "--device", "cpu"]
    out = str(tmp_path / "orbax")
    state = mc_train.main(flags + [
        "--batch_size", "4", "--epochs", "1", "--device_features", "off",
        "--no_native_loader", "--output", out, "--ckpt_backend", "orbax"])
    assert {os.path.splitext(f)[1] for f in os.listdir(out)} == {".txt",
                                                                 ".orbax"}
    params = jax_params_from_torch(state.model.state_dict())
    assert_same_tree(pckpt.load_params_any(out, 0, None), params)
    pickled = str(tmp_path / "pickle")
    pckpt.save_params(os.path.join(pickled, "model_epoch0.ckpt"), params)
    runs = []
    for path in (out, pickled):
        session, _ = cli.build_session(cli.build_parser().parse_args(
            flags + ["--input", path, "--epoch", "0", "--task", "mc",
                     "--v_dim", "16"]))
        b = goldens.batch(dict(ntoken=session.model.cfg.ntoken, v_dim=16,
                               num_ans_candidates=2, task="mc"))
        runs.append((mc_test.main(flags + ["--batch_size", "4", "--split",
                                           "val", "--input", path, "--epoch",
                                           "0"]),
                     session.logits(b["v"], b["b"], b["q"], b["a"])))
    assert runs[0][0] == runs[1][0]
    np.testing.assert_array_equal(runs[0][1], runs[1][1])


# -- (d) a step from a restored state -----------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_step_from_restored_state_matches_uninterrupted(tmp_path, jax_side,
                                                        writer):
    """One side saves after step 1, the other restores and takes step 2:
    loss, grad norm and params within 1e-4 of the writer's uninterrupted
    step 2."""
    path = str(tmp_path / "ck.orbax")
    b = batch(1)
    if writer == "jax":
        jckpt.save_checkpoint_orbax(path, on_device(jax_side["state1"]),
                                    epoch=0)
        want, want_params = jax_side["metrics2"], jax_side["state2"].params
        state, start = pckpt.restore_train_state_orbax(path,
                                                       fresh_port_state())
        got = make_train_step(state.model, TrainConfig(**DETERMINISTIC))(
            state, b, 1e-3)
        got_params = jax_params_from_torch(state.model.state_dict())
    else:
        state, step = port_state(steps=1)
        pckpt.save_checkpoint_orbax(path, state, epoch=0)
        want = step(state, b, 1e-3)
        want_params = jax_params_from_torch(state.model.state_dict())
        jstate, start = jckpt.restore_train_state_orbax(path, jax_state())
        jstate, got = jax_side["step"](jstate, jax_batch(b),
                                       jnp.float32(1e-3),
                                       jax.random.PRNGKey(1), False)
        got_params = jax.tree.map(np.asarray, jstate.params)
    assert start == 1
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)
    flat_got = pckpt._flatten(got_params)
    for path_, w in pckpt._flatten(want_params).items():
        np.testing.assert_allclose(flat_got[path_], w, rtol=TOL, atol=TOL,
                                   err_msg=path_)


# -- the stores against tensorstore -------------------------------------------

@pytest.mark.parametrize("config", [
    {}, {"max_decoded_node_bytes": 400, "version_tree_arity_log2": 1,
         "max_inline_value_bytes": 20},
    {"max_decoded_node_bytes": 300, "compression": None}],
    ids=["default", "interior-nodes-zstd", "interior-nodes-raw"])
def test_ocdbt_reader_matches_tensorstore(tmp_path, config):
    """Every key and value of tensorstore's newest version, over several
    committed versions (older ones in out-of-line version-tree nodes),
    B+tree interior nodes, inline and indirect values, a deleted range."""
    root = str(tmp_path / "kv")
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}",
                          "config": config}).result()
    rs = np.random.RandomState(0)
    for g in range(5):
        with ts.Transaction() as txn:
            for i in range(120):
                kv.with_transaction(txn)[b"a/k%04d/%d" % (i * 7 % 120, g)] = \
                    rs.bytes(i % 40)
        kv.delete_range(ts.KvStore.KeyRange(b"a/k0030", b"a/k0040")).result()
    want = {k.decode(): kv.read(k).result().value for k in kv.list().result()}
    store = ocdbt.OcdbtStore(root)
    assert list(store.keys()) == sorted(want)
    assert {k: store.get(k) for k in store.keys()} == want
    assert store.get("a/missing") is None


ZARR_DTYPES = ["<f4", "<f8", "<i4", "<i8", "|b1", "<u4", "bfloat16"]


def _values(dtype, shape, rs):
    x = np.asarray(rs.randn(*shape))
    if dtype == "bfloat16":  # values that bfloat16 holds exactly
        return (x.astype(np.float32).view(np.uint32) >> 16 << 16).view(
            np.float32)
    if dtype == "|b1":
        return x < 0
    return (x * 100).astype(dtype)


@pytest.mark.parametrize("dtype", ZARR_DTYPES)
def test_zarr_arrays_match_tensorstore(tmp_path, dtype):
    """tensorstore's zarr v2 arrays read by the port (chunk grids with
    edge chunks, a missing chunk as the fill value, ``.`` and ``/``
    separators, zstd and no compressor, zero dimensions), and the port's
    arrays read by tensorstore."""
    import ml_dtypes

    rs = np.random.RandomState(1)
    ts_dtype = "bfloat16" if dtype == "bfloat16" else np.dtype(dtype).name
    cases = [((5, 7), (2, 3), ".", {"id": "zstd", "level": 1}),
             ((4, 6), (4, 6), "/", None), ((), (), ".",
                                             {"id": "zstd", "level": 3})]
    for n, (shape, chunks, sep, compressor) in enumerate(cases):
        want = _values(dtype, shape, rs)
        path = str(tmp_path / f"a{n}")
        arr = ts.open({"driver": "zarr", "kvstore": f"file://{path}",
                       "metadata": {"shape": list(shape),
                                    "chunks": list(chunks),
                                    "dtype": "bfloat16" if dtype == "bfloat16"
                                    else dtype,
                                    "compressor": compressor,
                                    "dimension_separator": sep}},
                      create=True, dtype=ts_dtype).result()
        data = want.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else want
        arr.write(data).result()
        if shape == (5, 7):  # drop a chunk: it reads as zero
            os.remove(os.path.join(path, "1.1"))
            want = want.copy()
            want[2:4, 3:6] = 0
        got = zarr2.read_array(zarr2.DirStore(str(tmp_path)), f"a{n}")
        assert got.dtype == (np.float32 if dtype == "bfloat16" else dtype)
        np.testing.assert_array_equal(got, want)
        # the port's writer, read back by tensorstore
        bits = (want.view(np.uint32) >> 16).astype(np.uint16) \
            if dtype == "bfloat16" else want
        zarr2.write_array(zarr2.DirStore(str(tmp_path)), f"p{n}", bits,
                          dtype="bfloat16" if dtype == "bfloat16" else None)
        back = ts.open({"driver": "zarr", "kvstore":
                        f"file://{tmp_path}/p{n}"}).result().read().result()
        np.testing.assert_array_equal(np.asarray(back, np.float32 if dtype
                                                 == "bfloat16" else None),
                                      want)


def test_zstd_frames():
    """Frames with and without a recorded size (orbax's chunks record
    none: streamed, or the caller's size), and the refusals."""
    import zstandard

    data = np.random.RandomState(2).randn(5000).astype(np.float32).tobytes()
    assert zstd.decompress(zstd.compress(data)).tobytes() == data
    bare = zstandard.ZstdCompressor(write_content_size=False).compress(data)
    assert zstd.decompress(bare).tobytes() == data
    assert zstd.decompress(bare, len(data)).tobytes() == data
    for bad, size in ((bare, len(data) - 4), (b"not a frame", None),
                      (zstd.compress(data)[:-9], None)):
        with pytest.raises(ValueError, match="zstd"):
            zstd.decompress(bad, size)


# -- the goldens chip_smoke serves --------------------------------------------

@pytest.mark.parametrize("name", ["cti", "tan"])
def test_goldens_serve_on_the_port(name):
    """JAX's golden ``.orbax`` through ``load_params_any`` and
    ``InferenceSession`` (the CPU path of phase 15's serving): JAX's
    logits within 1e-4, the restored state's epoch, and orbax's restore of
    it equal to the port's."""
    z = np.load(goldens.DATA / f"torch_orbax_{name}.npz")
    assert int(z["param_seed"]) == goldens.PARAM_SEED
    cfg = ModelConfig(**goldens.MODELS[name])
    model = build_model(cfg)
    path = goldens.golden_dir(name)
    load_jax_params(model, pckpt.load_params_any(str(path.parent),
                                                 goldens.EPOCH, model))
    b = goldens.batch(goldens.MODELS[name])
    labels = (["match", "nonmatch"] if cfg.task == "mc"
              else [f"a{i}" for i in range(cfg.num_ans_candidates)])
    got = InferenceSession(model, labels, device="cpu").logits(
        b["v"], b["b"], b["q"], b["a"])
    np.testing.assert_allclose(got, z["logits"], rtol=0, atol=TOL)
    tree = pckpt.restore_orbax(str(path))
    assert int(tree["epoch"]) == goldens.EPOCH
    assert_same_tree(tree, ocp.PyTreeCheckpointer().restore(str(path)))


def test_two_process_golden():
    """A save by two processes: the root's B+tree names values in both
    ``ocdbt.process_<i>/d/``; the split weight reads bit for bit."""
    path = goldens.golden_dir("2proc")
    assert {"ocdbt.process_0", "ocdbt.process_1"} <= set(os.listdir(path))
    z = np.load(goldens.DATA / "torch_orbax_2proc.npz")
    tree = pckpt.restore_orbax(str(path))
    np.testing.assert_array_equal(tree["params"]["classifier"]["l1"]["v"],
                                  z["v"])
    assert int(tree["step"]) == int(z["step"]) and tree["opt_state"] == [
        None, {}]
    store = ocdbt.OcdbtStore(str(path))
    assert json.loads(store.get("params.classifier.l1.v/.zarray"))[
        "chunks"] == [goldens.SPLIT_ROWS // 2, goldens.SPLIT_COLS]
    files = {ref[0] for ref in store._values.values() if ref[0] != "inline"}
    assert {f.split("/")[0] for f in files} == {"ocdbt.process_0",
                                               "ocdbt.process_1"}


# -- (e) what raises ---------------------------------------------------------

def _copy_golden(tmp_path):
    dst = tmp_path / "ck.orbax"
    shutil.copytree(goldens.golden_dir("cti"), dst)
    return dst


def _node_file(root: Path) -> Path:
    """The root's B+tree leaf, a data file of the root's ``d/``."""
    return next((root / "d").iterdir())


def _flip(path: Path, at: int) -> None:
    data = bytearray(path.read_bytes())
    data[at] ^= 0x10
    path.write_bytes(bytes(data))


def _plain(tmp_path) -> Path:
    state, _ = port_state(steps=0)
    path = tmp_path / "plain.orbax"
    pckpt.save_checkpoint_orbax(str(path), state, epoch=0)
    return path


@pytest.mark.parametrize("damage,match", [
    ("truncated manifest", "truncated|bytes, the header says"),
    ("manifest bit flip", "CRC-32C"),
    ("node bit flip", "CRC-32C"),
    ("bad magic", "magic"),
    ("unknown compression", "compression 2"),
    ("truncated data file", "truncated"),
    ("unknown compressor", "compressor 'blosc'"),
    ("use_zarr3", "zarr3"),
    ("aggregate checkpoint", "aggregate"),
])
def test_damaged_orbax_raises(tmp_path, damage, match):
    root = _plain(tmp_path) if damage == "unknown compressor" \
        else _copy_golden(tmp_path)
    manifest = root / "manifest.ocdbt"
    if damage == "truncated manifest":
        manifest.write_bytes(manifest.read_bytes()[:-7])
    elif damage == "manifest bit flip":
        _flip(manifest, 30)
    elif damage == "node bit flip":
        _flip(_node_file(root), 40)
    elif damage == "bad magic":
        _flip(manifest, 1)
    elif damage == "unknown compression":
        data = bytearray(manifest.read_bytes())
        data[13] = 2
        data[-4:] = ocdbt.crc32c(bytes(data[:-4])).to_bytes(4, "little")
        manifest.write_bytes(bytes(data))
    elif damage == "truncated data file":
        big = max((root / "ocdbt.process_0" / "d").iterdir(),
                  key=lambda p: p.stat().st_size)
        big.write_bytes(big.read_bytes()[:100])
    elif damage == "unknown compressor":
        zarray = root / "params.classifier.l1.v" / ".zarray"
        meta = json.loads(zarray.read_text())
        meta["compressor"] = {"id": "blosc"}
        zarray.write_text(json.dumps(meta))
    elif damage == "use_zarr3":
        meta = json.loads((root / "_METADATA").read_text())
        meta["use_zarr3"] = True
        (root / "_METADATA").write_text(json.dumps(meta))
    elif damage == "aggregate checkpoint":
        (root / "_METADATA").unlink()
        (root / "checkpoint").write_bytes(b"\x80")
    with pytest.raises(ValueError, match=match):
        pckpt.restore_orbax(str(root))


def test_missing_libzstd_raises(monkeypatch):
    """No library, no stand-in: an OSError naming libzstd.so.1."""
    monkeypatch.setattr(zstd, "LIBRARY", "libzstd-absent.so.1")
    zstd._lib.cache_clear()
    try:
        with pytest.raises(OSError, match="libzstd"):
            zstd.compress(b"x")
    finally:
        monkeypatch.undo()
        zstd._lib.cache_clear()
