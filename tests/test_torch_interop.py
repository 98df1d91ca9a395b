"""Reference ``.pth`` interop against ``vqatpu.tools`` on the CPU: the
PARALIND core's scramble, the importer on reference-named state dicts of
the four models JAX imports (torch reference skeletons of
``tests/test_import_torch.py``, and JAX's exporter for BAN and BAN-MC with
the counter), the SAN refusals, the exporter for all six models, a
``.pth`` written by the port read by JAX's importer and back, and
``ffoe_test`` and ``serve`` reading a ``.pth``.  Everything here is a file
conversion: equal means equal to the bit."""

import json
import os

import numpy as np
import pytest
import torch

import jax

from vqatpu.config import ModelConfig as JaxModelConfig
from vqatpu.data.synthetic import make_vqa_fixture
from vqatpu.models import build_model as jax_build_model
from vqatpu.ops import tensor as jtensor
from vqatpu.tools import export_torch as jexport
from vqatpu.tools import import_torch as jimport
from vqatpu_torch.cli import ffoe_test
from vqatpu_torch.cli import serve as cli
from vqatpu_torch.config import ModelConfig
from vqatpu_torch.models import build_model
from vqatpu_torch.ops import tensor
from vqatpu_torch.tools import export_torch, import_torch
from vqatpu_torch.train import make_train_state
from vqatpu_torch.train.checkpoints import (load_params_any,
                                            restore_train_state, save_params)
from vqatpu_torch.weights import (jax_params_from_torch, load_jax_params,
                                  numpy_batch, numpy_params)

from tests.test_import_torch import NUM_ANS, TorchCTI, _tri_cfg

SMALL = dict(ntoken=30, v_dim=16, num_ans_candidates=11, num_hid=8, h_mm=4,
             rank=2, gamma=2)
MODELS = {"ban": dict(model="ban", use_counter=True), "san": dict(model="san"),
          "cti": dict(model="cti"), "tan": dict(model="tan", task="mc"),
          "ban_mc": dict(model="ban", task="mc", use_counter=True),
          "san_mc": dict(model="san", task="mc")}


def assert_trees_equal(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", [(3, 4, 5, 2, 1), (2, 3, 3, 3, 2),
                                   (4, 2, 3, 5, 3)])
def test_paralind_scramble_is_jaxs(rng, shape):
    core = rng.randn(*shape).astype(np.float32)
    for ours, theirs in ((tensor.paralind_core_scramble,
                          jtensor.paralind_core_scramble),
                         (tensor.paralind_core_unscramble,
                          jtensor.paralind_core_unscramble)):
        want = theirs(core)
        np.testing.assert_array_equal(ours(core), want)
        np.testing.assert_array_equal(ours(torch.from_numpy(core)).numpy(),
                                      want)
    np.testing.assert_array_equal(tensor.paralind_core_unscramble(
        tensor.paralind_core_scramble(core)), core)


def configs(name):
    kw = dict(SMALL, **MODELS[name])
    return ModelConfig(**kw), JaxModelConfig(**kw)


def reference_state_dict(name):
    """A reference-named state dict of each imported model: torch
    skeletons of the reference's modules for CTI and TanModel, JAX's
    exporter of seeded weights for BAN and BAN-MC (with the counter)."""
    if name in ("cti", "tan"):
        torch.manual_seed(5)
        tm = TorchCTI(NUM_ANS if name == "cti" else 2,
                      att_attr="t_att" if name == "cti" else "v_att")
        sd = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
        cfg = _tri_cfg("ffoe" if name == "cti" else "mc", model=name)
        kw = {f: getattr(cfg, f) for f in (
            "ntoken", "v_dim", "num_ans_candidates", "task", "num_hid",
            "h_mm", "rank", "gamma", "op", "model")}
        return sd, ModelConfig(**kw), cfg
    cfg, jcfg = configs(name)
    jm = jax_build_model(jcfg)
    return jexport.export_state_dict(jm, numpy_params(cfg, 4)), cfg, jcfg


def jax_import(sd, cfg):
    """JAX's mapping (``convert_state_dict`` without its shape check
    against a JAX init, which the port's makes against its module), its
    leaves float32 as ``convert_state_dict`` returns them."""
    if cfg.model in ("cti", "tan"):
        fn = jimport.convert_cti_ffoe if cfg.task == "ffoe" else \
            jimport.convert_tan_mc
        params = fn(sd, cfg.gamma, cfg.rank)
    else:
        fn = jimport.convert_ban_ffoe if cfg.task == "ffoe" else \
            jimport.convert_ban_mc
        params = fn(sd, cfg.gamma, cfg.use_counter)
    return jax.tree.map(lambda x: np.asarray(x, np.float32), params)


@pytest.mark.parametrize("name", ["cti", "tan", "ban", "ban_mc"])
def test_import_is_jaxs(name):
    sd, cfg, _ = reference_state_dict(name)
    got = import_torch.convert_state_dict(sd, build_model(cfg))
    assert_trees_equal(got, jax_import(sd, cfg))


@pytest.mark.parametrize("name", ["san", "san_mc"])
def test_san_import_raises_as_jaxs(name):
    cfg, jcfg = configs(name)
    sd = jexport.export_state_dict(jax_build_model(jcfg), numpy_params(cfg, 1))
    with pytest.raises(NotImplementedError, match="torch import"):
        jimport.convert_state_dict(sd, jax_build_model(jcfg))
    with pytest.raises(NotImplementedError, match="torch import"):
        import_torch.convert_state_dict(sd, build_model(cfg))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_export_is_jaxs(name):
    cfg, jcfg = configs(name)
    params = numpy_params(cfg, 2)
    want = jexport.export_state_dict(jax_build_model(jcfg), params)
    got = export_torch.export_state_dict(load_jax_params(build_model(cfg),
                                                         params))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", ["cti", "ban_mc"])
def test_pth_round_trip_through_jax(name, tmp_path):
    """The port's ``.pth`` is the reference payload; JAX's importer reads
    it to the exported params, the port's too, and the model built from it
    gives the same logits (within float32 rounding: the CPU's GEMMs may
    round two copies of the same weights differently, by their alignment)."""
    cfg, jcfg = configs(name)
    params = numpy_params(cfg, 3)
    model = load_jax_params(build_model(cfg), params)
    path = str(tmp_path / "model_epoch7.pth")
    export_torch.export_checkpoint(path, model, epoch=7)
    payload = torch.load(path, weights_only=True)
    assert payload["epoch"] == 7 and payload["optimizer_state"] is None
    assert_trees_equal(jax_import(jimport.load_torch_state_dict(path), cfg),
                       params)
    ours = load_params_any(str(tmp_path), 7, build_model(cfg))
    assert_trees_equal(ours, params)
    b = numpy_batch(ModelConfig(**dict(SMALL, model="cti")), 2, seed=1,
                    boxes=6, real_boxes=4, a_len=6 if cfg.task == "mc" else 3)
    x = {k: torch.from_numpy(b[k]) for k in ("v", "q", "a", "b")}
    with torch.inference_mode():
        want, _ = model.eval()(x["v"], x["q"], x["a"], b=x["b"])
        got, _ = load_jax_params(build_model(cfg), ours).eval()(
            x["v"], x["q"], x["a"], b=x["b"])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_resume_from_a_pth(tmp_path):
    """``restore_train_state`` on a reference ``.pth``: the params it holds,
    the epoch after its own, a fresh optimizer."""
    cfg, _ = configs("cti")
    params = numpy_params(cfg, 5)
    path = str(tmp_path / "model_epoch4.pth")
    export_torch.export_checkpoint(
        path, load_jax_params(build_model(cfg), params), epoch=4)
    state = make_train_state(build_model(cfg), seed=0, device="cpu")
    state, start, extra = restore_train_state(path, state)
    assert start == 5 and extra == {} and state.optimizer.count == 0
    assert_trees_equal(jax_params_from_torch(state.model.state_dict()), params)


def test_cli_reads_a_pth(tmp_path):
    """``ffoe_test`` and ``serve`` (no ``--model``: JAX's default, BAN)
    read ``model_epoch0.pth`` when there is no ``.ckpt``, and answer as
    from a ``.ckpt`` of the same weights."""
    root = str(tmp_path / "data_vqa")
    d = make_vqa_fixture(root, n_train=4, n_val=6, n_images=3, v_dim=16)
    with open(os.path.join(root, "cache", "trainval_label2ans.pkl"),
              "rb") as f:
        n_ans = len(__import__("pickle").load(f))
    flags = ["--dataroot", root, "--num_hid", "8", "--max_boxes", "12",
             "--device", "cpu", "--epoch", "0"]
    cfg = ModelConfig(ntoken=d.ntoken, v_dim=16, num_ans_candidates=n_ans,
                      num_hid=8, model="ban")
    params = numpy_params(cfg, 6)
    model = load_jax_params(build_model(cfg), params)
    for kind in ("pth", "ckpt"):
        out = tmp_path / kind
        out.mkdir()
        if kind == "pth":
            export_torch.export_checkpoint(str(out / "model_epoch0.pth"),
                                           model)
        else:
            save_params(str(out / "model_epoch0.ckpt"), params)
        ffoe_test.main(flags + ["--model", "ban", "--split", "val", "--input",
                                str(out), "--results", str(out / "res"),
                                "--batch_size", "4"])
        sess, _ = cli.build_session(cli.build_parser().parse_args(
            flags + ["--input", str(out), "--v_dim", "16"]))
        assert sess.model.cfg == cfg
    with open(tmp_path / "pth" / "res" / "val_banc8_epoch0.json") as f:
        answers = json.load(f)
    with open(tmp_path / "ckpt" / "res" / "val_banc8_epoch0.json") as f:
        assert answers == json.load(f) and len(answers) == 6
    params_pth = load_params_any(str(tmp_path / "pth"), 0, build_model(cfg))
    assert_trees_equal(params_pth, jax_params_from_torch(model.state_dict()))
