"""Import the reference's PyTorch checkpoints (``vqatpu/tools/
import_torch.py:31-257``).

A ``model_epoch{N}.pth`` of the reference (``utils.save_model``: ``{epoch,
model_state, optimizer_state}``) becomes a ``vqatpu`` param tree with
numpy leaves, the tree :func:`vqatpu_torch.weights.load_jax_params` loads
into the port's module: ``import_checkpoint(path, model)``.

How the reference's names map (its module tree):
- an FCNet is an ``nn.Sequential`` ``main`` with weight-normed Linears at
  indices that its dropout and activation shift: the ``{prefix}.main.{i}.
  weight_v`` are taken in index order as ``l0``, ``l1``, ...;
- ``weight_norm(..., dim=None)`` stores a scalar ``weight_g`` and the whole
  ``weight_v``: the tree's ``g`` and ``v``;
- BiAttention's ``weight_norm(name='h_mat')``: ``h_mat_g`` / ``h_mat_v``;
- the GRUs and LSTMs: ``rnn.weight_ih_l{n}[_reverse]`` (...) ->
  ``fwd`` / ``bwd`` for layer 0, ``fwd_l{n}`` / ``bwd_l{n}`` beyond;
- ModuleList entries ``b_net.0`` -> ``b_net0``;
- the PARALIND core ``T_g`` [1, rank, x, y, z, g, 1] is unscrambled into
  the clean layout (:func:`~vqatpu_torch.ops.tensor.
  paralind_core_unscramble`) and its per-rank nets stacked.

The models JAX imports: ``BanModel``, ``CTIModel``, ``TanModel`` and
``BanModelMC``; the SAN models raise, as JAX's do.  The shapes are checked
against the port module's own ``state_dict``.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

from vqatpu_torch.ops.tensor import paralind_core_unscramble
from vqatpu_torch.weights import _flatten, jax_params_from_torch


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def load_torch_checkpoint(path: str):
    """-> (the ``model_state`` of a reference ``.pth``, or the file's bare
    state dict, as float32 numpy arrays; its ``epoch``, None if absent)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    sd = payload.get("model_state", payload)
    return {k: _np(v) for k, v in sd.items()}, payload.get("epoch")


def _wn_linear(sd, prefix):
    out = {"v": sd[prefix + ".weight_v"],
           "g": np.float32(sd[prefix + ".weight_g"].reshape(()))}
    if prefix + ".bias" in sd:
        out["b"] = sd[prefix + ".bias"]
    return out


def _fcnet(sd, prefix):
    """The weight-normed Linears under ``{prefix}.main.{i}``, in order."""
    pat = re.compile(re.escape(prefix) + r"\.main\.(\d+)\.weight_v$")
    idxs = sorted(int(m.group(1)) for k in sd if (m := pat.match(k)))
    if not idxs:
        raise KeyError(f"no FCNet linears under {prefix}")
    return {f"l{j}": _wn_linear(sd, f"{prefix}.main.{i}")
            for j, i in enumerate(idxs)}


def _rnn_dir(sd, prefix, layer, rev):
    name = f"l{layer}{'_reverse' if rev else ''}"
    return {leaf: sd[f"{prefix}.rnn.{torch_name}_{name}"]
            for leaf, torch_name in (("w_ih", "weight_ih"),
                                     ("w_hh", "weight_hh"),
                                     ("b_ih", "bias_ih"),
                                     ("b_hh", "bias_hh"))}


def _rnn(sd, prefix):
    out = {}
    layer = 0
    while f"{prefix}.rnn.weight_ih_l{layer}" in sd:
        suffix = "" if layer == 0 else f"_l{layer}"
        out[f"fwd{suffix}"] = _rnn_dir(sd, prefix, layer, rev=False)
        if f"{prefix}.rnn.weight_ih_l{layer}_reverse" in sd:
            out[f"bwd{suffix}"] = _rnn_dir(sd, prefix, layer, rev=True)
        layer += 1
    return out


def _word_emb(sd, prefix):
    out = {"emb": sd[prefix + ".emb.weight"]}
    if prefix + ".emb_.weight" in sd:
        out["emb_"] = sd[prefix + ".emb_.weight"]
    return out


def _bcnet(sd, prefix, attention: bool):
    out = {"v_net": _fcnet(sd, prefix + ".v_net"),
           "q_net": _fcnet(sd, prefix + ".q_net")}
    if attention:
        key = (prefix + ".h_mat_v" if prefix + ".h_mat_v" in sd
               else prefix + ".h_mat")
        out["h_mat"] = sd[key]
        out["h_bias"] = sd[prefix + ".h_bias"]
    if prefix + ".h_net.weight_v" in sd:
        out["h_net"] = _wn_linear(sd, prefix + ".h_net")
    return out


def _biattention(sd, prefix):
    return {"bc": _bcnet(sd, prefix + ".logits", attention=True),
            "h_mat_g": np.float32(sd[prefix + ".logits.h_mat_g"].reshape(()))}


def _counter(sd, prefix):
    return {f"f{i}": {"weight": sd[f"{prefix}.f.{i}.weight"]}
            for i in range(8)}


def _classifier(sd, prefix):
    pat = re.compile(re.escape(prefix) + r"\.main\.(\d+)\.weight_v$")
    idxs = sorted(int(m.group(1)) for k in sd if (m := pat.match(k)))
    return {"l1": _wn_linear(sd, f"{prefix}.main.{idxs[0]}"),
            "l2": _wn_linear(sd, f"{prefix}.main.{idxs[1]}")}


def _tcnet(sd, prefix, rank: int):
    out = {"v_tucker": _fcnet(sd, prefix + ".v_tucker"),
           "q_tucker": _fcnet(sd, prefix + ".q_tucker"),
           "a_tucker": _fcnet(sd, prefix + ".a_tucker")}
    if prefix + ".T_g" in sd:
        t_g = sd[prefix + ".T_g"][0]  # [rank, x, y, z, g, h_out]
        if t_g.shape[-1] != 1:
            raise ValueError("the reference's ModeProduct runs with h_out 1 "
                             f"only; {prefix}.T_g has {t_g.shape[-1]}")
        out["T_g"] = paralind_core_unscramble(t_g[..., 0])[..., None]
        for stream in ("v_net", "q_net", "a_net"):
            per_rank = [_fcnet(sd, f"{prefix}.{stream}.{r}")
                        for r in range(rank)]
            out[stream] = {"l0": {k: np.stack([p["l0"][k] for p in per_rank])
                                  for k in per_rank[0]["l0"]}}
    return out


def convert_ban_ffoe(sd: Dict[str, np.ndarray], gamma: int,
                     use_counter: bool) -> dict:
    p = {"w_emb": _word_emb(sd, "w_emb"), "q_emb": _rnn(sd, "q_emb"),
         "v_att": _biattention(sd, "v_att"),
         "classifier": _classifier(sd, "classifier")}
    for g in range(gamma):
        p[f"b_net{g}"] = _bcnet(sd, f"b_net.{g}", attention=False)
        p[f"q_prj{g}"] = _fcnet(sd, f"q_prj.{g}")
        if use_counter:
            p[f"c_prj{g}"] = _fcnet(sd, f"c_prj.{g}")
    if use_counter:
        p["counter"] = _counter(sd, "counter")
    return p


def _convert_trilinear(sd, gamma: int, rank: int, att: str) -> dict:
    p = {"w_emb": _word_emb(sd, "w_emb"), "q_emb": _rnn(sd, "q_emb"),
         "wa_emb": _word_emb(sd, "wa_emb"), "ans_emb": _rnn(sd, "ans_emb"),
         att: {"tc": _tcnet(sd, f"{att}.TriAtt", rank)},
         "classifier": _classifier(sd, "classifier")}
    for g in range(gamma):
        p[f"t_net{g}"] = _tcnet(sd, f"t_net.{g}", rank)
        p[f"q_prj{g}"] = _fcnet(sd, f"q_prj.{g}")
        p[f"a_prj{g}"] = _fcnet(sd, f"a_prj.{g}")
    return p


def convert_cti_ffoe(sd: Dict[str, np.ndarray], gamma: int,
                     rank: int) -> dict:
    return _convert_trilinear(sd, gamma, rank, "t_att")


def convert_tan_mc(sd: Dict[str, np.ndarray], gamma: int, rank: int) -> dict:
    """MC TanModel (``MC/base_model.py:112-152``): CTI's layout with the
    trilinear attention under ``v_att``."""
    return _convert_trilinear(sd, gamma, rank, "v_att")


def convert_ban_mc(sd: Dict[str, np.ndarray], gamma: int,
                   use_counter: bool) -> dict:
    """MC BanModel (``MC/base_model.py:19-77``): a second BiAttention, the
    answer stream and the ``tva_net`` BCNets."""
    p = {"w_emb": _word_emb(sd, "w_emb"), "q_emb": _rnn(sd, "q_emb"),
         "wa_emb": _word_emb(sd, "wa_emb"), "ans_emb": _rnn(sd, "ans_emb"),
         "v_att": _biattention(sd, "v_att"),
         "va_att": _biattention(sd, "va_att"),
         "classifier": _classifier(sd, "classifier")}
    for g in range(gamma):
        p[f"b_net{g}"] = _bcnet(sd, f"b_net.{g}", attention=False)
        p[f"tva_net{g}"] = _bcnet(sd, f"tva_net.{g}", attention=False)
        p[f"q_prj{g}"] = _fcnet(sd, f"q_prj.{g}")
        p[f"a_prj{g}"] = _fcnet(sd, f"a_prj.{g}")
        if use_counter:
            p[f"c_prj{g}"] = _fcnet(sd, f"c_prj.{g}")
    if use_counter:
        p["counter"] = _counter(sd, "counter")
    return p


def convert_state_dict(sd: Dict[str, np.ndarray], model) -> dict:
    """A reference state dict -> the param tree of the port's ``model``
    (dispatch on its class), every leaf's shape checked against the
    module's ``state_dict``."""
    cfg = model.cfg
    name = type(model).__name__
    if name == "BanModel":
        params = convert_ban_ffoe(sd, cfg.gamma, cfg.use_counter)
    elif name == "CTIModel":
        params = convert_cti_ffoe(sd, cfg.gamma, cfg.rank)
    elif name == "TanModel":
        params = convert_tan_mc(sd, cfg.gamma, cfg.rank)
    elif name == "BanModelMC":
        params = convert_ban_mc(sd, cfg.gamma, cfg.use_counter)
    else:
        raise NotImplementedError(f"torch import for {name}")
    want = {k: tuple(v.shape) for k, v in
            _flatten(jax_params_from_torch(model.state_dict())).items()}
    got = {k: np.shape(v) for k, v in _flatten(params).items()}
    if set(got) != set(want):
        raise ValueError(f"{name}: the checkpoint lacks "
                         f"{sorted(set(want) - set(got))} and has "
                         f"{sorted(set(got) - set(want))} beyond the model")
    bad = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
    if bad:
        raise ValueError(f"{name}: shapes (checkpoint, model) differ: {bad}")
    return _as_float32(params)


def _as_float32(tree: dict) -> dict:
    return {k: _as_float32(v) if isinstance(v, dict)
            else np.asarray(v, np.float32) for k, v in tree.items()}


def import_checkpoint(path: str, model) -> dict:
    return convert_state_dict(load_torch_checkpoint(path)[0], model)
