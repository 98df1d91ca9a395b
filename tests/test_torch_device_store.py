"""vqatpu_torch's card-resident feature store (``data/device_store.py``)
against vqatpu's, on the CPU device, on the same synthetic fixtures.

- ``gather`` bit-equal to JAX's host wire (``BatchLoader`` then
  ``wire_cast``) and to JAX's ``DeviceFeatureStore.gather`` for float32,
  float16, bfloat16 and int8, the sentinel padding of a final batch
  included; an int8-resident store under the int8 and float32 wires; a
  ``ConcatDataset`` whose VisualGenome member shares its split's store.
- ``estimate_hbm_bytes`` equal to JAX's and to the built store's bytes but
  the sentinel row; the capability gate, the tri-state decision and its
  budget override (``VQATPU_DEVSTORE_BUDGET_MB``); sparse targets.
- ``train()`` with the store (dense and sparse targets), with the native
  loader and with the Python loader: the same per-step losses, and within
  1e-4 of vqatpu's loop from the same params (``deterministic=True``:
  dropout streams never align); the decisions logged as JAX logs them.
- Eval logits and scores through the store equal to the wire path's, in
  the sweep and through ``ffoe_test --device_features on``/``off``.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vqatpu.config import ModelConfig as JaxModelConfig
from vqatpu.config import TrainConfig as JaxTrainConfig
from vqatpu.data import BatchLoader as JaxBatchLoader
from vqatpu.data import ConcatDataset as JaxConcat
from vqatpu.data import VisualGenomeFeatureDataset as JaxVG
from vqatpu.data import VQAFeatureDataset as JaxVQA
from vqatpu.data import batching as jbatching
from vqatpu.data import device_store as jstore
from vqatpu.data.dictionary import Dictionary as JaxDictionary
from vqatpu.data.synthetic import add_visualgenome_fixture, make_vqa_fixture
from vqatpu.models import build_model as jax_build_model
from vqatpu.train import loop as jloop
from vqatpu.train import steps as jsteps
from vqatpu_torch.cli import ffoe_test
from vqatpu_torch.config import ModelConfig, TrainConfig
from vqatpu_torch.data import batching, device_store
from vqatpu_torch.data.datasets import (ConcatDataset,
                                        VisualGenomeFeatureDataset,
                                        VQAFeatureDataset)
from vqatpu_torch.data.device_store import DeviceFeatureStore
from vqatpu_torch.data.dictionary import Dictionary
from vqatpu_torch.eval import ffoe as peval
from vqatpu_torch.models import build_model
from vqatpu_torch.train import loop as ploop
from vqatpu_torch.train import make_train_state
from vqatpu_torch.train.checkpoints import save_checkpoint
from vqatpu_torch.train.steps import densify_target
from vqatpu_torch.weights import numpy_params, torch_state_from_jax

MAX_BOXES = 16
WIRES = ("float32", "float16", "bfloat16", "int8")
DIMS = dict(model="cti", num_hid=16, h_mm=8, rank=2, gamma=2)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """The same dataroot (with VisualGenome questions) twice, (JAX's copy,
    the port's copy)."""
    root = str(tmp_path_factory.mktemp("devstore_vqa"))
    make_vqa_fixture(root, n_train=40, n_val=10, n_images=12, v_dim=32)
    add_visualgenome_fixture(root, n_questions=12)
    shutil.copytree(root, root + "_port")
    return root, root + "_port"


def load(root, split, port, **kw):
    dict_cls, ds_cls = ((Dictionary, VQAFeatureDataset) if port
                        else (JaxDictionary, JaxVQA))
    d = dict_cls.load_from_file(os.path.join(root, "dictionary.pkl"))
    return ds_cls(split, d, dataroot=root, max_boxes=MAX_BOXES, **kw)


def with_vg(ds, root, port):
    vg_cls, cat_cls = ((VisualGenomeFeatureDataset, ConcatDataset) if port
                       else (JaxVG, JaxConcat))
    vg = vg_cls("train", ds.store, ds.dictionary, dataroot=root,
                max_boxes=MAX_BOXES, img_id2idx=ds.img_id2idx)
    return cat_cls([ds, vg])


def as_numpy(x):
    """A torch tensor or numpy array as numpy; bfloat16 as its bits."""
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == jnp.bfloat16 else x


def assert_slabs_equal(got: dict, want: dict, dequantize=False):
    """The port's gathered slabs against JAX's wire-cast batch, bit for bit
    and dtype for dtype; with ``dequantize``, the gathered int8 ``v``
    dequantized (the step's upcast) against the wire's float32 ``v``."""
    keys = ("v", "b", "v_mask") + (("v_scale",) if "v_scale" in want else ())
    if dequantize:
        v = got["v"].float() * got["v_scale"][..., None]
        np.testing.assert_array_equal(v.numpy(), want["v"])
        keys = ("b", "v_mask")
    for k in keys:
        g, w = as_numpy(got[k]), as_numpy(want[k])
        assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=k)


def wire_and_gathered(jds, pds, store, bs=16, **kw):
    """Pairs (port gather of a fields-only batch, JAX wire-cast batch)."""
    wire = JaxBatchLoader(jds, bs, **kw)
    fields = batching.BatchLoader(pds, bs, fields_only=True, **kw)
    return [(store.gather(f["ds_idx"]), w) for f, w in zip(fields, wire)]


@pytest.mark.parametrize("wire", WIRES)
def test_gather_equals_the_wire(roots, wire):
    """40 rows in batches of 16: the last has 8 padded rows, which gather
    the sentinel (zero boxes, all-False mask)."""
    jds, pds = load(roots[0], "train", False), load(roots[1], "train", True)
    store = DeviceFeatureStore.build(pds, transfer_dtype=wire, device="cpu")
    theirs = jstore.DeviceFeatureStore.build(jds, transfer_dtype=wire)
    pairs = wire_and_gathered(jds, pds, store)
    assert len(pairs) == 3
    for got, w in pairs:
        assert_slabs_equal(got, jsteps.wire_cast(w, wire))
    last = pairs[-1][0]
    assert not last["v_mask"][8:].any() and not last["v"][8:].any()
    np.testing.assert_array_equal(store.rows_table, theirs.rows_table)
    np.testing.assert_array_equal(store.sample_img, theirs.sample_img)
    for f in batching.BatchLoader(pds, 16, fields_only=True):
        mine = store.gather(f["ds_idx"])
        for k, x in theirs.gather(f["ds_idx"]).items():
            np.testing.assert_array_equal(as_numpy(mine[k]), as_numpy(x))


@pytest.mark.parametrize("wire", ["int8", "float32"])
def test_int8_resident_store(roots, wire):
    """``--quantize_store``: under the int8 wire the rows go up as they
    are, equal to quantizing the float32 wire's batch (quantization is
    idempotent); under the float32 wire they stay int8 on the device and
    dequantize to the wire's float32 ``v``."""
    jds = load(roots[0], "train", False)
    qds = load(roots[1], "train", True, quantize_features=True)
    store = DeviceFeatureStore.build(qds, transfer_dtype=wire, device="cpu")
    assert store.feats.dtype == torch.int8
    jq = load(roots[0], "train", False, quantize_features=True)
    for got, w in wire_and_gathered(jq if wire == "float32" else jds, qds,
                                    store, drop_last=True):
        assert_slabs_equal(got, jsteps.wire_cast(w, wire),
                           dequantize=wire == "float32")


def test_concat_shares_the_store(roots):
    jds = with_vg(load(roots[0], "train", False), roots[0], False)
    pds = with_vg(load(roots[1], "train", True), roots[1], True)
    store = DeviceFeatureStore.build(pds, transfer_dtype="int8",
                                     device="cpu")
    # one table for both members: the store's box rows and the sentinel
    assert store.feats.shape[0] == pds.datasets[0].store.features.shape[0] + 1
    for got, w in wire_and_gathered(jds, pds, store, bs=8, drop_last=True,
                                    shuffle=True, seed=4):
        assert_slabs_equal(got, jsteps.wire_cast(w, "int8"))
    table = device_store.store_rows_table(pds.datasets[0].store, 7, 5,
                                          sentinel=-1)
    np.testing.assert_array_equal(table, jstore.store_rows_table(
        jds.datasets[0].store, 7, 5, -1))


@pytest.mark.parametrize("wire", WIRES + ("q8store",))
def test_estimate_equals_the_built_store(roots, wire):
    q8 = wire == "q8store"
    transfer = "float32" if q8 else wire
    pds = load(roots[1], "train", True, quantize_features=q8)
    jds = load(roots[0], "train", False, quantize_features=q8)
    est = device_store.estimate_hbm_bytes(pds, transfer)
    assert est == jstore.estimate_hbm_bytes(jds, transfer)
    store = DeviceFeatureStore.build(pds, transfer_dtype=transfer,
                                     device="cpu")
    one_row = sum(t[0].numel() * t.element_size() for t in
                  (store.feats, store.scales, store.spats) if t is not None)
    assert store.hbm_bytes == est + one_row
    assert f"{store.feats.shape[0]} box rows" in store.describe()


def test_capability_and_tristate(roots, monkeypatch):
    pds = load(roots[1], "train", True)
    streaming = load(roots[1], "train", True, features_in_memory=False)
    norm = device_store.normalize_device_features
    assert norm("auto") == norm("AUTO") == "auto"
    assert norm("on") == norm(True) == "on"
    assert norm("off") == norm(False) == norm(None) == "off"
    with pytest.raises(ValueError):
        norm("maybe")
    assert device_store.devstore_capable(pds) == (True, "")
    assert device_store.devstore_capable(pds, task="mc") == (True, "")
    ok, why = device_store.devstore_capable(pds, task="nope")
    assert not ok and "nope" in why
    assert not device_store.devstore_capable(object())[0]

    decide = device_store.devstore_decision
    assert decide(pds, "off", "float32") == (False, "")
    assert decide(pds, "auto", "float32", device="cpu") == (True, "")
    assert device_store.hbm_budget_bytes("cpu") == (
        4 * 2**30, "4 GiB default (no device memory stats)")
    monkeypatch.setenv("VQATPU_DEVSTORE_BUDGET_MB", "0")
    build, why = decide(pds, "auto", "float32", device="cpu")
    assert not build and "budget" in why and "--device_features on" in why
    assert decide(pds, "on", "float32") == (True, "")
    monkeypatch.delenv("VQATPU_DEVSTORE_BUDGET_MB")
    for mode in ("on", "auto"):
        build, why = decide(streaming, mode, "float32", device="cpu")
        assert not build and "streaming" in why
    jds = load(roots[0], "train", False)
    for mode in ("on", "auto", "off"):
        assert (decide(pds, mode, "int8", device="cpu")
                == jstore.devstore_decision(jds, mode, "int8"))


def test_sharded_store_is_refused(roots):
    """No longer refused: without a mesh ``shard=True`` builds the row-sharded
    store over one rank (all the rows), whose float32 gathers equal the
    replicated store's after the step's upcast, bit for bit, on every wire
    (tests/test_torch_parallel.py shards over two processes)."""
    from vqatpu_torch.train.steps import upcast_wire

    ds = load(roots[1], "train", True)
    idx = np.array([0, 3, -1, len(ds) - 1])
    for wire in WIRES:
        rep = DeviceFeatureStore.build(ds, transfer_dtype=wire, device="cpu")
        sh = DeviceFeatureStore.build(ds, transfer_dtype=wire, shard=True,
                                      device="cpu")
        assert sh.sharded and not rep.sharded
        assert "sharded, rank 0 of 1" in sh.describe()
        got, want = sh.gather(idx), upcast_wire(rep.gather(idx))
        assert set(got) == {"v", "b", "v_mask"}
        for k in got:
            assert torch.equal(got[k], want[k]), (wire, k)


def test_sparse_targets(roots):
    """The fields-only loader's sparse targets equal JAX's and densify to
    the dense target bit for bit, zero-score labels and empty rows too."""
    jds, pds = load(roots[0], "train", False), load(roots[1], "train", True)
    k = batching.max_target_labels(pds)
    assert k == jbatching.max_target_labels(jds)
    dense = batching.BatchLoader(pds, 8, fields_only=True)
    sparse = batching.BatchLoader(pds, 8, fields_only=True, sparse_target_k=k)
    theirs = JaxBatchLoader(jds, 8, fields_only=True, sparse_target_k=k)
    for d, s, t in zip(dense, sparse, theirs):
        for key in ("t_label", "t_score", "ds_idx"):
            np.testing.assert_array_equal(s[key], t[key])
        got = densify_target({"t_label": s["t_label"],
                              "t_score": s["t_score"]},
                             pds.num_ans_candidates)["target"]
        np.testing.assert_array_equal(got.numpy(), d["target"])


def recording(make_step, record):
    """``make_train_step`` whose steps append their loss to ``record``."""
    def make(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def recorded(*a, **kw):
            out = step(*a, **kw)
            metrics = out[1] if isinstance(out, tuple) else out
            record.append(float(np.asarray(metrics["loss"])))
            return out
        return recorded
    return make


def test_loop_through_store_native_and_python_matches_jax(roots, tmp_path,
                                                          monkeypatch):
    """Two epochs of five steps from the same numpy params: the store
    (dense and sparse targets), the C++ loader and the Python loader give
    the same losses step by step (to float32 rounding); JAX's loop within
    1e-4."""
    jds, pds = load(roots[0], "train", False), load(roots[1], "train", True)
    kw = dict(DIMS, ntoken=pds.dictionary.ntoken, v_dim=pds.v_dim,
              num_ans_candidates=pds.num_ans_candidates)
    params = numpy_params(ModelConfig(**kw), seed=5)
    cfg = dict(epochs=2, batch_size=8, update_freq=1, saving_epoch=99,
               deterministic=True, seed=7)
    runs = {"store": (dict(device_features="on"), False),
            "store_sparse": (dict(device_features="on", sparse_targets=True),
                             False),
            "native": (dict(device_features="off"), True),
            "python": (dict(device_features="off"), False)}
    losses, logs = {}, {}
    for name, (tcfg, use_native) in runs.items():
        record = []
        monkeypatch.setattr(ploop, "make_train_step",
                            recording(ploop.make_train_step, record))
        model = build_model(ModelConfig(**kw))
        model.load_state_dict(torch_state_from_jax(params))
        out = str(tmp_path / name)
        ploop.train(model, pds, None, TrainConfig(**cfg, **tcfg), out,
                    state=make_train_state(model, device="cpu"),
                    use_native_loader=use_native, device="cpu",
                    print_interval=10 ** 6)
        monkeypatch.undo()
        losses[name] = record
        logs[name] = open(os.path.join(out, "log.txt")).read()
    rows = pds.store.features.shape[0] + 1
    assert f"device feature store: {rows} box rows" in logs["store"]
    for name in ("native", "python"):
        assert "device feature store" not in logs[name]
    assert len(losses["python"]) == 10
    # the batches are bit-equal (above); the CPU's GEMMs may still round a
    # last bit apart on buffers of another alignment
    for name in runs:
        np.testing.assert_allclose(losses[name], losses["python"], rtol=1e-6,
                                   err_msg=name)

    record = []
    monkeypatch.setattr(jloop, "make_train_step",
                        recording(jloop.make_train_step, record))
    jm = jax_build_model(JaxModelConfig(**kw))
    js = jsteps.make_train_state(jm, jax.random.PRNGKey(0))
    js = js._replace(params=jax.tree.map(jnp.asarray, params))
    jloop.train(jm, jds, None, JaxTrainConfig(**cfg, device_features="on"),
                str(tmp_path / "jax"), state=js, use_mesh=False,
                use_native_loader=False, print_interval=10 ** 6)
    np.testing.assert_allclose(losses["store"], record, rtol=1e-4)


@pytest.mark.parametrize("case", ["auto", "budget", "streaming"])
def test_loop_logs_each_decision_as_jax(roots, tmp_path, monkeypatch, case):
    """The default ``auto`` builds the train and eval stores; a budget of 0
    declines with ``auto-OFF`` and the reason; ``on`` over a streaming
    store declines with ``OFF``.  The lines are JAX's."""
    kwargs = {"auto": {}, "budget": {},
              "streaming": dict(features_in_memory=False)}[case]
    pds = load(roots[1], "train", True, **kwargs)
    val = load(roots[1], "val", True, **kwargs)
    if case == "budget":
        monkeypatch.setenv("VQATPU_DEVSTORE_BUDGET_MB", "0")
    model = build_model(ModelConfig(**dict(
        DIMS, ntoken=pds.dictionary.ntoken, v_dim=pds.v_dim,
        num_ans_candidates=pds.num_ans_candidates)))
    out = str(tmp_path / case)
    cfg = TrainConfig(epochs=1, batch_size=8, saving_epoch=99,
                      device_features="on" if case == "streaming" else "auto")
    ploop.train(model, pds, val, cfg, out, device="cpu",
                print_interval=10 ** 6)
    log = open(os.path.join(out, "log.txt")).read()
    assert "eval score:" in log
    if case == "auto":
        rows = pds.store.features.shape[0] + 1
        assert f"\ndevice feature store: {rows} box rows x 32d float32" in log
        assert "\neval device feature store: " in log
    elif case == "budget":
        assert ("device feature store auto-OFF (auto: estimated tables 0 MiB "
                "exceed the budget 0 MiB (VQATPU_DEVSTORE_BUDGET_MB)") in log
        assert "native loader OFF" not in log
    else:
        assert ("device feature store OFF (streaming store "
                "(--stream_features) can't be uploaded to HBM") in log
        assert "native loader OFF (dataset has no in-memory" in log


@pytest.mark.parametrize("wire", ["float32", "int8"])
def test_eval_through_the_store_equals_the_wire(roots, wire):
    """``get_logits``/``evaluate`` with the store (fields-only loader) and
    with the wire path (Python and native loaders), the padded final batch
    included (10 rows in batches of 4)."""
    pds = load(roots[1], "val", True)
    model = build_model(ModelConfig(**dict(
        DIMS, ntoken=pds.dictionary.ntoken, v_dim=pds.v_dim,
        num_ans_candidates=pds.num_ans_candidates)))
    model.load_state_dict(torch_state_from_jax(numpy_params(model.cfg, 3)))
    model.eval()
    store = DeviceFeatureStore.build(pds, transfer_dtype=wire, device="cpu")
    loaders = {
        "store": lambda: batching.make_eval_loader(pds, 4, fields_only=True),
        "python": lambda: batching.make_eval_loader(pds, 4, use_native=False),
        "native": lambda: batching.make_eval_loader(
            pds, 4, quantize=wire == "int8")}
    out = {}
    for name, make in loaders.items():
        st = store if name == "store" else None
        out[name] = (peval.get_logits(model, make(), transfer_dtype=wire,
                                      dev_store=st),
                     peval.evaluate(model, make(), transfer_dtype=wire,
                                    dev_store=st))
    (lw, qw), sw = out["python"]
    assert lw.shape[0] == 10
    for name in ("store", "native"):
        (lg, qg), sg = out[name]
        np.testing.assert_array_equal(qg, qw)
        np.testing.assert_array_equal(lg, lw)
        assert sg == sw


def test_ffoe_test_device_features_on_and_off(roots, tmp_path, capsys):
    root = roots[1]
    pds = load(root, "val", True)
    model = build_model(ModelConfig(**dict(
        DIMS, ntoken=pds.dictionary.ntoken, v_dim=pds.v_dim,
        num_ans_candidates=pds.num_ans_candidates)))
    ckpt_dir = str(tmp_path / "ckpt")
    save_checkpoint(os.path.join(ckpt_dir, "model_epoch0.ckpt"),
                    make_train_state(model, seed=2, device="cpu"), 0)
    logits = {}
    for mode in ("on", "off"):
        paths = ffoe_test.main([
            "--model", "cti", "--dataroot", root, "--num_hid", "16",
            "--h_mm", "8", "--rank", "2", "--batch_size", "4",
            "--max_boxes", str(MAX_BOXES), "--device", "cpu", "--split",
            "val", "--input", ckpt_dir, "--epoch", "0", "--results",
            str(tmp_path / mode), "--logits", "1", "--device_features",
            mode])
        printed = capsys.readouterr().out
        assert ("device feature store: " in printed) == (mode == "on")
        with np.load(paths["raw_logits"]) as z:
            logits[mode] = (z["logits"], z["question_ids"])
    np.testing.assert_array_equal(logits["on"][0], logits["off"][0])
    np.testing.assert_array_equal(logits["on"][1], logits["off"][1])
    assert logits["on"][0].shape[0] == 10
