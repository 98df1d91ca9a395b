"""vqatpu_torch's epoch loop, checkpoints, eval and export and its training
and test CLIs against vqatpu's, on the CPU at small width (``num_hid 32,
h_mm 16, rank 4``; fixtures from ``vqatpu.data.synthetic`` with v_dim 16).

- ``train()`` in both packages, 3 epochs of ``TrainConfig(deterministic=
  True, saving_epoch=1)`` from the same numpy params (Torch and JAX
  dropout streams never align: the ROADMAP parity contract): the epoch
  means of the per-update loss, grad norm and score to 1e-4 relative, the
  ``log.txt`` lines to their printed digits, the eval score to within one
  question of the val split, the final params to 1e-4.
- Checkpoints load across the packages both ways, with Adamax m and u to
  1e-6; a resumed run starts at epoch + 1 and keeps ``best_eval``; an
  out-of-memory error of the card skips its batch and is counted.
- ``get_logits``/``evaluate`` to 1e-4, the EvalAI answers identical, the
  teacher-logit pickle's keys equal and its float16 values within 1e-3.
- The CLIs with ``--device cpu`` write the artifacts of JAX's
  ``tests/test_cli.py``, and JAX reads the port's checkpoint to the same
  answers.
"""

import json
import os
import pickle
import re
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vqatpu.config import ModelConfig as JaxModelConfig
from vqatpu.config import TrainConfig as JaxTrainConfig
from vqatpu.data import batching as jbatching
from vqatpu.data import datasets as jdatasets
from vqatpu.data.dictionary import Dictionary as JaxDictionary
from vqatpu.data.synthetic import make_tdiuc_fixture, make_vqa_fixture
from vqatpu.eval import ffoe as jeval
from vqatpu.models import build_model as jax_build_model
from vqatpu.train import checkpoints as jckpt
from vqatpu.train import loop as jloop
from vqatpu.train import steps as jsteps
from vqatpu_torch.cli import ffoe_test, ffoe_train
from vqatpu_torch.config import ModelConfig, TrainConfig
from vqatpu_torch.data import batching, datasets
from vqatpu_torch.data.dictionary import Dictionary
from vqatpu_torch.eval import ffoe as peval
from vqatpu_torch.models import build_model
from vqatpu_torch.train import checkpoints as pckpt
from vqatpu_torch.train import loop as ploop
from vqatpu_torch.train import make_train_state, make_train_step
from vqatpu_torch.weights import (jax_params_from_torch, numpy_batch,
                                  numpy_params, torch_state_from_jax)

TOL = 1e-4
DIMS = dict(num_hid=32, h_mm=16, rank=4, gamma=2, model="cti")
N_TRAIN, N_VAL, BATCH, MAX_BOXES = 24, 16, 8, 12
SMALL_ARGS = ["--num_hid", "32", "--h_mm", "16", "--rank", "4",
              "--batch_size", str(BATCH), "--max_boxes", str(MAX_BOXES),
              "--print_interval", "1000", "--no_mesh", "--device", "cpu"]


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """A VQA dataroot, twice: (JAX's copy, the port's copy)."""
    root = str(tmp_path_factory.mktemp("data_vqa"))
    make_vqa_fixture(root, n_train=N_TRAIN, n_val=N_VAL, n_images=8, v_dim=16)
    shutil.copytree(root, root + "_port")
    return root, root + "_port"


def load_split(mod, dict_cls, root, name):
    d = dict_cls.load_from_file(os.path.join(root, "dictionary.pkl"))
    return mod.VQAFeatureDataset(name, d, dataroot=root, max_boxes=MAX_BOXES)


def model_kw(ds):
    return dict(DIMS, ntoken=ds.dictionary.ntoken, v_dim=ds.v_dim,
                num_ans_candidates=ds.num_ans_candidates)


def recording(make_step, record):
    """``make_train_step`` whose steps append their metrics to ``record``."""
    def make(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def recorded(*a, **kw):
            out = step(*a, **kw)
            metrics = out[1] if isinstance(out, tuple) else out
            record.append({k: float(np.asarray(metrics[k])) for k in
                           ("loss", "grad_norm", "batch_score", "updated")})
            return out
        return recorded
    return make


def epoch_means(record, n_epochs, batch_size):
    """Per epoch: the loss and norm per update, the score in percent."""
    per_epoch = np.array_split(np.array(
        [[m["loss"], m["grad_norm"], m["batch_score"], m["updated"]]
         for m in record]), n_epochs)
    out = []
    for rows in per_epoch:
        upd = rows[rows[:, 3] == 1]
        n = len(upd)
        out.append((upd[:, 0].sum() / n, upd[:, 1].sum() / n,
                    100 * upd[:, 2].sum() / (n * batch_size)))
    return np.array(out)


def log_numbers(path):
    text = open(path).read()
    train = [tuple(map(float, m)) for m in re.findall(
        r"train_loss: ([\d.]+), norm: ([\d.]+), score: ([\d.]+)", text)]
    evals = [float(m) for m in re.findall(r"eval score: ([\d.]+)", text)]
    return np.array(train), np.array(evals), text


def test_train_loop_matches_jax(roots, tmp_path, monkeypatch):
    """Three deterministic epochs of both loops from the same params; with
    update_freq 2 over 3 batches an epoch, each epoch's last update is the
    forced flush of one microbatch."""
    root_j, root_p = roots
    tr_j, va_j = (load_split(jdatasets, JaxDictionary, root_j, n)
                  for n in ("train", "val"))
    tr_p, va_p = (load_split(datasets, Dictionary, root_p, n)
                  for n in ("train", "val"))
    kw = model_kw(tr_p)
    params = numpy_params(ModelConfig(**kw), seed=5)
    cfg = dict(epochs=3, batch_size=BATCH, update_freq=2, saving_epoch=1,
               deterministic=True, device_features="off", seed=7)

    rec_j, rec_p = [], []
    monkeypatch.setattr(jloop, "make_train_step",
                        recording(jloop.make_train_step, rec_j))
    monkeypatch.setattr(ploop, "make_train_step",
                        recording(ploop.make_train_step, rec_p))
    jm = jax_build_model(JaxModelConfig(**kw))
    js = jsteps.make_train_state(jm, jax.random.PRNGKey(0))
    js = js._replace(params=jax.tree.map(jnp.asarray, params))
    out_j, out_p = str(tmp_path / "jax"), str(tmp_path / "port")
    js = jloop.train(jm, tr_j, va_j, JaxTrainConfig(**cfg), out_j, state=js,
                     use_mesh=False, use_native_loader=False)
    pm = build_model(ModelConfig(**kw))
    pm.load_state_dict(torch_state_from_jax(params))
    ps = make_train_state(pm, device="cpu")
    ps = ploop.train(pm, tr_p, va_p, TrainConfig(**cfg), out_p, state=ps,
                     use_mesh=False, use_native_loader=False)

    assert len(rec_p) == len(rec_j) == 3 * (N_TRAIN // BATCH)
    want, got = epoch_means(rec_j, 3, BATCH), epoch_means(rec_p, 3, BATCH)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    tr_log_j, ev_log_j, text_j = log_numbers(os.path.join(out_j, "log.txt"))
    tr_log_p, ev_log_p, text_p = log_numbers(os.path.join(out_p, "log.txt"))
    assert tr_log_p.shape == tr_log_j.shape == (3, 3)
    # printed with 2 or 4 digits: equal but for a rounding at the last one
    np.testing.assert_allclose(tr_log_p, tr_log_j, atol=0.0101)
    # an argmax may flip on a near tie: one question of the val split
    np.testing.assert_allclose(ev_log_p, ev_log_j, atol=100 / N_VAL + 0.01)
    for line in ("gradual warmup lr: 0.00050000", "nParams=\t",
                 "optim: adamax lr=0.0010, decay_step=2"):
        assert line in text_p and line in text_j
    got_params = jax_params_from_torch(ps.model.state_dict())
    flat_j = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, js.params))[0]
    flat_p = dict(jax.tree_util.tree_flatten_with_path(got_params)[0])
    assert len(flat_p) == len(flat_j)
    for path, leaf in flat_j:
        np.testing.assert_allclose(flat_p[path], leaf, rtol=TOL, atol=TOL,
                                   err_msg=jax.tree_util.keystr(path))
    for name in ("model_epoch1.ckpt", "model_epoch2.ckpt"):
        assert os.path.exists(os.path.join(out_p, name))
        assert os.path.exists(os.path.join(out_j, name))


def trained_states(kw, tfidf_loaded, n_steps=2):
    """The port's state after ``n_steps`` updates, and a fresh JAX state of
    the same model."""
    model = build_model(ModelConfig(**kw))
    model.load_state_dict(torch_state_from_jax(numpy_params(ModelConfig(**kw), 3)))
    state = make_train_state(model, device="cpu", tfidf_loaded=tfidf_loaded)
    step = make_train_step(model, TrainConfig(update_freq=1, deterministic=True),
                           tfidf_loaded=tfidf_loaded)
    for i in range(n_steps):
        step(state, numpy_batch(ModelConfig(**kw), 4, seed=i, boxes=8,
                                real_boxes=6, target=True), 1e-3 * (i + 1))
    jm = jax_build_model(JaxModelConfig(**kw))
    return state, jm, jsteps.make_train_state(jm, jax.random.PRNGKey(0),
                                              tfidf_loaded=tfidf_loaded)


def assert_trees_equal(mine, theirs):
    flat = dict(jax.tree_util.tree_flatten_with_path(mine)[0])
    want = jax.tree_util.tree_flatten_with_path(theirs)[0]
    assert len(flat) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(flat[path], np.asarray(leaf),
                                      err_msg=jax.tree_util.keystr(path))


def jax_adamax(opt_state):
    inner = opt_state.inner_state[0]
    return getattr(inner, "inner_state", inner)


def assert_moments_equal(port_state, jax_opt_state, atol=1e-6):
    ad = jax_adamax(jax_opt_state)
    assert int(ad.count) == port_state.optimizer.count
    m, u = pckpt._state_trees(port_state)
    for mine, theirs in ((m, ad.m), (u, ad.u)):
        flat = pckpt._flatten(mine)
        for path, leaf in pckpt._flatten(jax.tree.map(
                lambda x: x, theirs, is_leaf=lambda x: x is None)).items():
            if flat[path] is None:
                assert not hasattr(leaf, "shape"), path  # MaskedNode
            else:
                np.testing.assert_allclose(flat[path], np.asarray(leaf),
                                           rtol=0, atol=atol, err_msg=path)


@pytest.mark.parametrize("tfidf_loaded", [False, True],
                         ids=["emb_-frozen", "tfidf"])
def test_checkpoints_load_across_packages(tmp_path, tfidf_loaded):
    """The port's checkpoint restores in JAX's restore_train_state, and
    JAX's in the port's, with the params, Adamax m, u and count and the
    update count; the frozen GloVe copy has no optimizer state."""
    kw = dict(DIMS, ntoken=50, v_dim=32, num_ans_candidates=17)
    state, jm, jstate = trained_states(kw, tfidf_loaded)
    path = str(tmp_path / "port.ckpt")
    pckpt.save_checkpoint(path, state, 4, extra={"best_eval": 0.25,
                                                 "model": "cti"})
    got, start, extra = jckpt.restore_train_state(path, jstate)
    assert start == 5 and extra == {"best_eval": 0.25, "model": "cti"}
    assert int(got.step) == state.step == 2
    assert_moments_equal(state, got.opt_state)
    assert_trees_equal(jax_params_from_torch(state.model.state_dict()),
                       got.params)
    # JAX takes a step from the restored state, as a resumed run would
    step = jsteps.make_train_step(jm, JaxTrainConfig(update_freq=1,
                                                     deterministic=True),
                                  tfidf_loaded=tfidf_loaded)
    batch = numpy_batch(ModelConfig(**kw), 4, seed=9, boxes=8, real_boxes=6,
                        target=True)
    jb = {k: jnp.asarray(x.astype(np.int32) if x.dtype == np.int64 else x)
          for k, x in batch.items()}
    got, _ = step(got, jb, jnp.float32(1e-3), jax.random.PRNGKey(1), False)

    path = str(tmp_path / "jax.ckpt")
    jckpt.save_checkpoint(path, got, 7, extra={"best_eval": 0.5})
    model = build_model(ModelConfig(**kw))
    fresh = make_train_state(model, device="cpu", tfidf_loaded=tfidf_loaded)
    fresh, start, extra = pckpt.restore_train_state(path, fresh)
    assert start == 8 and extra == {"best_eval": 0.5} and fresh.step == 3
    assert_moments_equal(fresh, got.opt_state)
    assert_trees_equal(jax_params_from_torch(fresh.model.state_dict()),
                       got.params)
    # and the port resumes: one more step matches JAX's
    step_p = make_train_step(model, TrainConfig(update_freq=1,
                                                deterministic=True),
                             tfidf_loaded=tfidf_loaded)
    m_p = step_p(fresh, batch, 1e-3)
    _, m_j = step(got, jb, jnp.float32(1e-3), jax.random.PRNGKey(1), False)
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m_p[k]), float(m_j[k]), rtol=TOL)


def test_restore_refuses_another_model(tmp_path):
    kw = dict(DIMS, ntoken=50, v_dim=32, num_ans_candidates=17)
    state, _, _ = trained_states(kw, False, n_steps=1)
    path = str(tmp_path / "m.ckpt")
    pckpt.save_checkpoint(path, state, 0, extra={"model": "cti"})
    other = build_model(ModelConfig(**dict(kw, num_hid=16, h_mm=8)))
    with pytest.raises(ValueError, match="incompatible checkpoint"):
        pckpt.restore_train_state(path, make_train_state(other, device="cpu"))


def port_loop(roots, out, epochs, **kw):
    tr, va = (load_split(datasets, Dictionary, roots[1], n)
              for n in ("train", "val"))
    model = build_model(ModelConfig(**model_kw(tr)))
    cfg = TrainConfig(epochs=epochs, batch_size=BATCH, saving_epoch=0,
                      **kw.pop("cfg", {}))
    return ploop.train(model, tr, va, cfg, out, use_native_loader=False,
                       device="cpu", **kw), model, tr, va


def test_resume_starts_after_the_checkpoint_and_keeps_best_eval(roots,
                                                                tmp_path):
    out = str(tmp_path / "run")
    port_loop(roots, out, 2)
    _, evals, _ = log_numbers(os.path.join(out, "log.txt"))
    best = pckpt.load_checkpoint(os.path.join(out, "model_epoch_best.ckpt"))
    assert best["extra"]["best_eval"] == pytest.approx(evals.max() / 100,
                                                       abs=1e-4)
    tr = load_split(datasets, Dictionary, roots[1], "train")
    model = build_model(ModelConfig(**model_kw(tr)))
    state = make_train_state(model, device="cpu")
    state, start, extra = pckpt.restore_train_state(
        os.path.join(out, "model_epoch1.ckpt"), state)
    assert start == 2 and extra["best_eval"] == best["extra"]["best_eval"]
    # a better best_eval than any epoch reaches: no new best checkpoint
    before = os.path.getmtime(os.path.join(out, "model_epoch_best.ckpt"))
    va = load_split(datasets, Dictionary, roots[1], "val")
    ploop.train(model, tr, va, TrainConfig(epochs=3, batch_size=BATCH,
                                           saving_epoch=0), out, state=state,
                start_epoch=start, best_eval=1.01, use_native_loader=False)
    text = open(os.path.join(out, "log.txt")).read()
    assert "epoch 2, time" in text and text.count("epoch 0, time") == 1
    after = pckpt.load_checkpoint(os.path.join(out, "model_epoch2.ckpt"))
    assert after["extra"]["best_eval"] == 1.01 and after["epoch"] == 2
    assert os.path.getmtime(os.path.join(out, "model_epoch_best.ckpt")) == before


def test_out_of_memory_step_is_skipped_and_counted(roots, tmp_path,
                                                   monkeypatch):
    """An injected torch.cuda.OutOfMemoryError at the second microbatch of
    the first epoch: the batch is skipped, the accumulation window dropped
    (the next update takes only the third microbatch) and the skip logged."""
    calls = []

    def make(*args, **kwargs):
        step = make_train_step(*args, **kwargs)

        def flaky(state, batch, lr, gen, force=False):
            calls.append(state.accum_count)
            if len(calls) == 2:
                raise torch.cuda.OutOfMemoryError("injected")
            return step(state, batch, lr, gen, force)
        return flaky

    monkeypatch.setattr(ploop, "make_train_step", make)
    out = str(tmp_path / "oom")
    state, *_ = port_loop(roots, out, 2, cfg=dict(update_freq=2))
    text = open(os.path.join(out, "log.txt")).read()
    assert "| WARNING: out of memory, skipping batch 1" in text
    assert text.count("skipped 1 batches (OOM)") == 1
    # epoch 0: batch 0 buffered, batch 1 failed (window dropped), batch 2
    # forced alone; epoch 1: 2 + 1 (forced)
    assert calls[:3] == [0, 1, 0] and state.step == 1 + 2


@pytest.mark.parametrize("option", ["tp", "num_devices", "shard"])
def test_unported_loop_options_raise(roots, tmp_path, option):
    """The several-device options run where they can
    (tests/test_torch_parallel.py runs them over several processes): in
    this one process ``tp=2`` and ``num_devices=2`` raise, naming the
    one-process-a-device rule, and the row-sharded store trains over this
    process's one-rank data axis to the replicated store's params, bit for
    bit.  (``ckpt_backend="orbax"`` trains: tests/test_torch_orbax.py.)"""
    if option in ("tp", "num_devices"):
        with pytest.raises(ValueError, match="process"):
            port_loop(roots, str(tmp_path / "x"), 1, **{option: 2})
    else:
        runs = {}
        for shard in (False, True):
            out = str(tmp_path / f"shard{shard}")
            state, *_ = port_loop(roots, out, 1, cfg=dict(
                device_features="on", shard_feature_store=shard))
            runs[shard] = state.model.state_dict()
            line = [ln for ln in open(os.path.join(out, "log.txt"))
                    if ln.startswith("device feature store: ")]
            assert line and (("sharded, rank 0 of 1" in line[0]) == shard)
        for k, v in runs[False].items():
            assert torch.equal(runs[True][k], v), k


def test_eval_and_export_match_jax(roots, tmp_path):
    root_j, root_p = roots
    va_j = load_split(jdatasets, JaxDictionary, root_j, "val")
    va_p = load_split(datasets, Dictionary, root_p, "val")
    kw = model_kw(va_p)
    params = numpy_params(ModelConfig(**kw), seed=8)
    jm = jax_build_model(JaxModelConfig(**kw))
    jp = jax.tree.map(jnp.asarray, params)
    model = build_model(ModelConfig(**kw))
    model.load_state_dict(torch_state_from_jax(params))
    model.eval()
    want, qids_j = jeval.get_logits(jm, jp, jbatching.BatchLoader(va_j, 6))
    got, qids_p = peval.get_logits(model, batching.make_eval_loader(va_p, 6))
    np.testing.assert_array_equal(qids_p, qids_j)
    np.testing.assert_allclose(got, want, atol=TOL)
    score_j = jeval.evaluate(jm, jp, jbatching.BatchLoader(va_j, 6))
    score_p = peval.evaluate(model, batching.make_eval_loader(va_p, 6))
    np.testing.assert_allclose(score_p, score_j, atol=TOL)
    out_j, out_p = str(tmp_path / "j"), str(tmp_path / "p")
    for fn, out, logits, qids, labels in (
            (jeval.export_results, out_j, want, qids_j, va_j.label2ans),
            (peval.export_results, out_p, got, qids_p, va_p.label2ans)):
        paths = fn(out, "val", "cti", "c", 32, 3, logits, qids, labels,
                   dump_teacher_logits=True)
        assert sorted(os.path.basename(p) for p in paths.values()) == [
            "cti_val_logits.pkl", "val_ctic32_epoch3.json"]
    with open(os.path.join(out_j, "val_ctic32_epoch3.json")) as f, \
            open(os.path.join(out_p, "val_ctic32_epoch3.json")) as g:
        assert json.load(g) == json.load(f)
    with open(os.path.join(out_j, "cti_val_logits.pkl"), "rb") as f, \
            open(os.path.join(out_p, "cti_val_logits.pkl"), "rb") as g:
        tj, tp = pickle.load(f), pickle.load(g)
    assert sorted(tp) == sorted(tj) and len(tp) == N_VAL
    for q in tj:
        assert tp[q].dtype == np.float16
        np.testing.assert_allclose(tp[q].astype(np.float32),
                                   tj[q].astype(np.float32), atol=1e-3)


def test_cli_train_and_test_write_the_jax_artifacts(roots, tmp_path):
    """``ffoe_train`` for 10 epochs (so that saving_epoch 9 writes
    ``model_epoch9.ckpt``), a resume for an 11th, and ``ffoe_test`` on it:
    log.txt, the checkpoints, the EvalAI JSON of the val split and the
    teacher logits; JAX's eval on the port's checkpoint gives the same
    answers."""
    root = roots[1]
    out = str(tmp_path / "saved_models")
    results = str(tmp_path / "results")
    ffoe_train.main(["--model", "cti", "--dataroot", root, "--output", out,
                     "--epochs", "10", *SMALL_ARGS])
    assert {"log.txt", "model_epoch9.ckpt", "model_epoch_best.ckpt"} <= set(
        os.listdir(out))
    text = open(os.path.join(out, "log.txt")).read()
    assert text.count("train_loss:") == 10
    # the defaults: the features on the card (auto), no host loader message
    assert "\ndevice feature store: " in text
    assert "native loader OFF" not in text
    ffoe_train.main(["--model", "cti", "--dataroot", root, "--output", out,
                     "--epochs", "11", "--input",
                     os.path.join(out, "model_epoch9.ckpt"), *SMALL_ARGS])
    text = open(os.path.join(out, "log.txt")).read()
    assert text.count("train_loss:") == 11 and "epoch 10, time" in text
    paths = ffoe_test.main(["--model", "cti", "--dataroot", root, *SMALL_ARGS,
                            "--split", "val", "--input", out, "--epoch", "9",
                            "--results", results, "--logits", "1"])
    with open(os.path.join(results, "val_ctic32_epoch9.json")) as f:
        answers = json.load(f)
    assert len(answers) == N_VAL
    assert os.path.exists(os.path.join(results, "cti_val_logits.pkl"))
    with np.load(paths["raw_logits"]) as z:
        assert z["logits"].shape[0] == N_VAL
    # JAX reads the port's checkpoint (tf-idf-loaded tables included)
    va_j = load_split(jdatasets, JaxDictionary, roots[0], "val")
    ds_dict = Dictionary.load_from_file(os.path.join(root, "dictionary.pkl"))
    jm = jax_build_model(JaxModelConfig(**dict(
        model_kw(va_j), ntoken=ds_dict.ntoken)))
    jp = jax.tree.map(jnp.asarray, jckpt.load_params_any(out, 9, jm))
    logits, qids = jeval.get_logits(jm, jp, jbatching.BatchLoader(va_j, 8))
    assert jeval.make_json(logits, qids, va_j.label2ans) == answers


def test_tdiuc_train_cli(tmp_path):
    root = str(tmp_path / "data_TDIUC")
    make_tdiuc_fixture(root, n_train=16, n_val=8, n_images=6, v_dim=16)
    out = str(tmp_path / "out")
    ffoe_train.main(["--model", "cti", "--use_TDIUC", "--TDIUC_dir", root,
                     "--output", out, "--epochs", "1", *SMALL_ARGS])
    text = open(os.path.join(out, "log.txt")).read()
    assert "train_loss:" in text and "eval score:" in text
