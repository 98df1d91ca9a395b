"""Export to the reference's PyTorch checkpoint layout
(``vqatpu/tools/export_torch.py:34-263``), the inverse of
:mod:`vqatpu_torch.tools.import_torch`.

A port model's weights (a ``vqatpu`` param tree, by default the module's
own ``state_dict``) are saved as ``model_epoch{N}.pth`` in the reference's
``utils.save_model`` payload ``{epoch, model_state, optimizer_state}``,
which the reference's ``test.py`` loads.  The reference's names:

- an FCNet's ``nn.Sequential`` ``main`` holds, per layer, ``[Dropout (if
  p > 0), weight_norm(Linear), Act (if any)]`` (``fc.py:14-31``), so a
  Linear's index follows the FCNet's dropout and activation, read from the
  port's modules;
- SimpleClassifier is ``[Linear, Act, Dropout, Linear]``: ``main.0`` and
  ``main.3``;
- ``weight_norm(..., dim=None)``: a scalar ``weight_g`` and ``weight_v``;
- TCNet's core is stored scrambled with a leading axis, ``T_g [1, rank, x,
  y, z, g, 1]`` (:func:`~vqatpu_torch.ops.tensor.paralind_core_scramble`).

Every model exports: BAN, SAN and CTI, and the multiple-choice TanModel,
BAN-MC and SAN-MC.  A host-only file conversion, as JAX's:

    python -m vqatpu_torch.tools.export_torch saved/model_epoch9.ckpt \\
        out.pth --model cti --ntoken 20573 [--v_dim 2048 --num_ans 3129 ...]
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np
import torch

from vqatpu_torch.ops.tensor import paralind_core_scramble
from vqatpu_torch.weights import jax_params_from_torch


def _np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


def _linear_index(dropout: float, act: str, layer: int) -> int:
    """Index of the ``layer``-th Linear inside the reference Sequential."""
    idx = 0
    for _ in range(layer + 1):
        if dropout > 0:
            idx += 1
        lin = idx
        idx += 1
        if act:
            idx += 1
    return lin


def _put_wn(sd, prefix, p):
    sd[prefix + ".weight_v"] = _np(p["v"])
    sd[prefix + ".weight_g"] = _np(p["g"]).reshape(())
    if "b" in p:
        sd[prefix + ".bias"] = _np(p["b"])


def _put_fcnet(sd, prefix, fcnet, p):
    for j in range(len(fcnet.dims) - 1):
        i = _linear_index(fcnet.dropout, fcnet.act, j)
        _put_wn(sd, f"{prefix}.main.{i}", p[f"l{j}"])


def _put_rnn(sd, prefix, p):
    nlayers = 1 + sum(1 for k in p if k.startswith("fwd_l"))
    for layer in range(nlayers):
        suffix = "" if layer == 0 else f"_l{layer}"
        pairs = [("", p[f"fwd{suffix}"])]
        if f"bwd{suffix}" in p:
            pairs.append(("_reverse", p[f"bwd{suffix}"]))
        for name, sub in pairs:
            sd[f"{prefix}.rnn.weight_ih_l{layer}{name}"] = _np(sub["w_ih"])
            sd[f"{prefix}.rnn.weight_hh_l{layer}{name}"] = _np(sub["w_hh"])
            sd[f"{prefix}.rnn.bias_ih_l{layer}{name}"] = _np(sub["b_ih"])
            sd[f"{prefix}.rnn.bias_hh_l{layer}{name}"] = _np(sub["b_hh"])


def _put_word_emb(sd, prefix, p):
    sd[prefix + ".emb.weight"] = _np(p["emb"])
    if "emb_" in p:
        sd[prefix + ".emb_.weight"] = _np(p["emb_"])


def _put_bcnet(sd, prefix, bc, p, attention: bool):
    _put_fcnet(sd, prefix + ".v_net", bc.v_net, p["v_net"])
    _put_fcnet(sd, prefix + ".q_net", bc.q_net, p["q_net"])
    if attention:
        sd[prefix + ".h_mat_v"] = _np(p["h_mat"])
        sd[prefix + ".h_bias"] = _np(p["h_bias"])
    if "h_net" in p:
        _put_wn(sd, prefix + ".h_net", p["h_net"])


def _put_biattention(sd, prefix, att, p):
    _put_bcnet(sd, prefix + ".logits", att.bc, p["bc"], attention=True)
    sd[prefix + ".logits.h_mat_g"] = _np(p["h_mat_g"]).reshape(())


def _put_linear(sd, prefix, p):
    sd[prefix + ".weight"] = _np(p["w"])
    if "b" in p:
        sd[prefix + ".bias"] = _np(p["b"])


def _put_san_att(sd, prefix, p):
    """StackedAttention (``attention.py:78-88``): fc11-fc15 and a flat
    ``layers`` ModuleList of 3 Linears per further stack."""
    for nm in ("fc11", "fc12", "fc13", "fc14", "fc15"):
        _put_linear(sd, f"{prefix}.{nm}", p[nm])
    s = 0
    while f"w{s}_q" in p:
        for j, nm in enumerate(("q", "i", "h")):
            _put_linear(sd, f"{prefix}.layers.{3 * s + j}", p[f"w{s}_{nm}"])
        s += 1


def _put_classifier(sd, prefix, p):
    _put_wn(sd, f"{prefix}.main.0", p["l1"])
    _put_wn(sd, f"{prefix}.main.3", p["l2"])


def _put_counter(sd, prefix, p):
    for i in range(8):
        sd[f"{prefix}.f.{i}.weight"] = _np(p[f"f{i}"]["weight"])


def _put_tcnet(sd, prefix, tc, p):
    for name in ("v_tucker", "q_tucker", "a_tucker"):
        _put_fcnet(sd, f"{prefix}.{name}", getattr(tc, name), p[name])
    if "T_g" in p:
        t_g = _np(p["T_g"])
        if t_g.shape[-1] != 1:
            raise ValueError("the reference's ModeProduct runs with h_out 1 "
                             f"only; T_g has {t_g.shape[-1]}")
        core = paralind_core_scramble(t_g[..., 0])
        sd[prefix + ".T_g"] = core[None, ..., None]
        for stream in ("v_net", "q_net", "a_net"):
            net = getattr(tc, stream)  # RankNets: one Linear per rank
            idx = _linear_index(net.drop, net.act, 0)
            stacked = p[stream]["l0"]
            for r in range(tc.rank):
                _put_wn(sd, f"{prefix}.{stream}.{r}.main.{idx}",
                        {k: np.asarray(v)[r] for k, v in stacked.items()})


def export_state_dict(model, params: Optional[dict] = None
                      ) -> Dict[str, np.ndarray]:
    """Port ``model`` (its structure) and ``params`` (a ``vqatpu`` param
    tree; by default the module's own weights) -> the reference's flat
    state dict, numpy float32 values."""
    if params is None:
        params = jax_params_from_torch(model.state_dict())
    name = type(model).__name__
    cfg = model.cfg
    sd: Dict[str, np.ndarray] = {}
    _put_word_emb(sd, "w_emb", params["w_emb"])
    _put_rnn(sd, "q_emb", params["q_emb"])
    _put_classifier(sd, "classifier", params["classifier"])
    if name == "StackedAttentionModel":
        _put_san_att(sd, "v_att", params["v_att"])
    elif name == "StackedAttentionModelMC":
        _put_word_emb(sd, "wa_emb", params["wa_emb"])
        _put_rnn(sd, "a_emb", params["a_emb"])
        _put_san_att(sd, "v_att", params["v_att"])
        _put_san_att(sd, "va_att", params["va_att"])
    elif name in ("BanModel", "BanModelMC"):
        mc = name == "BanModelMC"
        if mc:
            _put_word_emb(sd, "wa_emb", params["wa_emb"])
            _put_rnn(sd, "ans_emb", params["ans_emb"])
        _put_biattention(sd, "v_att", model.v_att, params["v_att"])
        if mc:
            _put_biattention(sd, "va_att", model.va_att, params["va_att"])
        for g in range(cfg.gamma):
            _put_bcnet(sd, f"b_net.{g}", getattr(model, f"b_net{g}"),
                       params[f"b_net{g}"], attention=False)
            if mc:
                _put_bcnet(sd, f"tva_net.{g}", getattr(model, f"tva_net{g}"),
                           params[f"tva_net{g}"], attention=False)
            for prj in ("q_prj", "a_prj", "c_prj"):
                if hasattr(model, f"{prj}{g}"):
                    _put_fcnet(sd, f"{prj}.{g}", getattr(model, f"{prj}{g}"),
                               params[f"{prj}{g}"])
        if cfg.use_counter:
            _put_counter(sd, "counter", params["counter"])
    elif name in ("CTIModel", "TanModel"):
        att = model.att_name
        _put_word_emb(sd, "wa_emb", params["wa_emb"])
        _put_rnn(sd, "ans_emb", params["ans_emb"])
        _put_tcnet(sd, f"{att}.TriAtt", getattr(model, att).tc,
                   params[att]["tc"])
        for g in range(cfg.gamma):
            _put_tcnet(sd, f"t_net.{g}", getattr(model, f"t_net{g}"),
                       params[f"t_net{g}"])
            _put_fcnet(sd, f"q_prj.{g}", getattr(model, f"q_prj{g}"),
                       params[f"q_prj{g}"])
            _put_fcnet(sd, f"a_prj.{g}", getattr(model, f"a_prj{g}"),
                       params[f"a_prj{g}"])
    else:
        raise NotImplementedError(f"torch export for {name}")
    return sd


def export_checkpoint(path: str, model, params: Optional[dict] = None,
                      epoch: int = 0) -> None:
    """Write the reference's ``utils.save_model`` payload."""
    sd = {k: torch.from_numpy(np.array(v, np.float32, copy=True))
          for k, v in export_state_dict(model, params).items()}
    torch.save({"epoch": epoch, "model_state": sd, "optimizer_state": None},
               path)


def main(argv=None):
    """Convert a checkpoint of either package (``.ckpt``) to a
    reference-format ``.pth``."""
    from vqatpu_torch.config import ModelConfig
    from vqatpu_torch.models import build_model
    from vqatpu_torch.train.checkpoints import load_checkpoint

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("ckpt")
    ap.add_argument("out")
    ap.add_argument("--model", default="cti")
    ap.add_argument("--task", default="ffoe", choices=["ffoe", "mc"])
    ap.add_argument("--ntoken", type=int, required=True)
    ap.add_argument("--v_dim", type=int, default=2048)
    ap.add_argument("--num_ans", type=int, default=3129)
    ap.add_argument("--num_hid", type=int, default=1024)
    ap.add_argument("--h_mm", type=int, default=512)
    ap.add_argument("--rank", type=int, default=32)
    ap.add_argument("--gamma", type=int, default=2)
    ap.add_argument("--use_counter", action="store_true")
    args = ap.parse_args(argv)

    cfg = ModelConfig(ntoken=args.ntoken, v_dim=args.v_dim,
                      num_ans_candidates=args.num_ans, model=args.model,
                      num_hid=args.num_hid, h_mm=args.h_mm, rank=args.rank,
                      gamma=args.gamma, task=args.task,
                      use_counter=args.use_counter)
    payload = load_checkpoint(args.ckpt)
    export_checkpoint(args.out, build_model(cfg), payload["params"],
                      epoch=payload.get("epoch", 0))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
