"""The serve CLI's parser against JAX's (``vqatpu/cli/serve.py:262-306``):
the same argv through both packages' serve parsers gives equal
``ModelConfig``s (``--model`` defaults to ``ban`` on both), every flag of
JAX's serve parses in the port's with JAX's default, and CTI's
``--v_block_size``, ``--remat`` and ``--fused_v_tucker`` reach the served
model."""

import argparse
import dataclasses
import types

import pytest

from vqatpu.cli import common as jcommon
from vqatpu.cli import serve as jserve
from vqatpu_torch.cli import common
from vqatpu_torch.cli import serve as cli
from vqatpu_torch.data import Dictionary


class _Parsed(Exception):
    pass


def jax_serve_parse(argv, monkeypatch):
    """JAX's serve ``main`` up to its parse: -> (its parser, its args)."""
    seen = {}
    parse = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        seen["parser"], seen["args"] = self, parse(self, args, namespace)
        return seen["args"]

    def stop(args):
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    monkeypatch.setattr(jserve, "build_session", stop)
    with pytest.raises(_Parsed):
        jserve.main(argv)
    monkeypatch.undo()
    return seen["parser"], seen["args"]


def dataset(ntoken=40, v_dim=2048, n_ans=9):
    d = Dictionary()
    for i in range(ntoken):
        d.add_word(f"w{i}")
    return types.SimpleNamespace(dictionary=d, v_dim=v_dim,
                                 num_ans_candidates=n_ans)


ARGVS = {
    "no_model": [],
    "cti_knobs": ["--model", "cti", "--v_block_size", "16", "--remat",
                  "--fused_v_tucker", "--h_mm", "256", "--rank", "16",
                  "--gamma", "3", "--num_hid", "512", "--task", "ffoe"],
    "ban_counter": ["--model", "ban", "--use_counter", "--num_layers", "2",
                    "--activation", "swish", "--dropout", "0.3", "--op", ""],
    "san_mc": ["--model", "stacked_attention", "--num_stacks", "3",
               "--task", "mc", "--question_len", "14", "--seed", "7",
               "--tfidf", "", "--kernel_backend", "pallas"],
}


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_serve_parsers_give_jaxs_model_config(name, monkeypatch):
    argv = ARGVS[name] + ["--epoch", "3", "--port", "0"]
    _, jargs = jax_serve_parse(argv, monkeypatch)
    args = cli.build_parser().parse_args(argv)
    ds = dataset()
    want = jcommon.model_config_from_args(jargs, ds, task=jargs.task)
    got = common.model_config_from_args(args, ds, task=args.task)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if name == "no_model":
        assert got.model == "ban"


def test_every_jax_serve_flag_parses_with_jaxs_default(monkeypatch):
    jparser, jargs = jax_serve_parse([], monkeypatch)
    parser = cli.build_parser()
    ours = {s for a in parser._actions for s in a.option_strings}
    theirs = {s for a in jparser._actions for s in a.option_strings}
    assert theirs <= ours, sorted(theirs - ours)
    args = vars(parser.parse_args([]))
    assert {k: args[k] for k in vars(jargs)} == vars(jargs)
    assert set(args) - set(vars(jargs)) == {"device"}


@pytest.mark.parametrize("flag,field,value", [
    ("--v_block_size=8", "v_block_size", 8), ("--remat", "remat_glimpse", True),
    ("--fused_v_tucker", "fused_v_tucker", True)])
def test_cti_knobs_reach_the_served_model(flag, field, value, tmp_path):
    """The session's model is built with the flag (it was refused before
    the blockwise path and the fused tuckers were ported)."""
    import pickle

    from vqatpu_torch.models import build_model
    from vqatpu_torch.train.checkpoints import save_params
    from vqatpu_torch.weights import numpy_params

    ds = dataset(n_ans=3)
    ds.dictionary.dump_to_file(str(tmp_path / "dictionary.pkl"))
    (tmp_path / "cache").mkdir()
    with open(tmp_path / "cache" / "trainval_label2ans.pkl", "wb") as f:
        pickle.dump(["a", "b", "c"], f)
    argv = ["--model", "cti", "--num_hid", "16", "--h_mm", "8", "--rank",
            "2", "--v_dim", "8", "--dataroot", str(tmp_path), "--input",
            str(tmp_path), "--epoch", "0", "--device", "cpu", flag]
    args = cli.build_parser().parse_args(argv)
    cfg = common.model_config_from_args(
        args, dataset(n_ans=3, v_dim=8), task="ffoe")
    save_params(str(tmp_path / "model_epoch0.ckpt"),
                numpy_params(cfg, seed=0))
    sess, _ = cli.build_session(args)
    assert getattr(sess.model.cfg, field) == value
    assert type(sess.model) is type(build_model(cfg))
