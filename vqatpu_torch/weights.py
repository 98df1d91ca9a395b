"""Weights across the two packages, and seeded weights and inputs.

- :func:`torch_state_from_jax` turns a ``vqatpu`` param tree (nested dicts
  with numpy leaves, the format of ``vqatpu/train/checkpoints.py``) into the
  port's ``state_dict``.  Port keys are the tree paths joined with ``.``
  (``t_att.tc.v_net.l0.v``, ``t_net0.v_tucker.l0.g``), except the GRUs
  and LSTMs, whose ``fwd.w_ih`` / ``fwd_l{n}.w_ih`` / ``bwd.w_ih`` /
  ``bwd_l{n}.w_ih`` (and ``w_hh``, ``b_ih``, ``b_hh``) leaves become
  ``nn.GRU``'s ``weight_ih_l{n}`` / ``weight_ih_l{n}_reverse`` (...)
  parameters (``q_emb.fwd.w_ih`` -> ``q_emb.weight_ih_l0``,
  ``q_emb.bwd_l1.b_hh`` -> ``q_emb.bias_hh_l1_reverse``).
- :func:`jax_params_from_torch` is its inverse: a ``state_dict`` back to
  a ``vqatpu`` param tree with numpy leaves.
- :func:`load_jax_params` loads such a tree strictly: a leaf left unused, a
  parameter left unset or a shape that differs raises.
- :func:`shard_state` and :func:`gather_state`: a rank's slice of a full
  state under tensor parallelism, and back.
- :func:`load_params_file` reads a ``model_epoch{N}.ckpt`` or a
  ``save_params`` file without importing JAX; :func:`load_pickle` reads a
  whole checkpoint, its optimizer state's NamedTuples as stand-ins.
- :func:`numpy_params` and :func:`numpy_batch` make seeded weights of the
  free-form and multiple-choice models (BAN, SAN, CTI and TanModel; in the
  JAX tree layout) and inputs with numpy, so both packages can be fed the
  same numbers.
- :func:`param_stats` fingerprints a param tree (per-leaf norms and sums)
  for trajectories compared across devices and packages.
"""

from __future__ import annotations

import collections
import pickle
import re
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from vqatpu_torch.config import ModelConfig

_GRU_LEAVES = {"w_ih": "weight_ih", "w_hh": "weight_hh",
               "b_ih": "bias_ih", "b_hh": "bias_hh"}


def _flatten(tree: dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _torch_key(path: str) -> str:
    *module, direction, leaf = [""] + path.split(".")
    m = re.fullmatch(r"(fwd|bwd)(?:_l(\d+))?", direction)
    if leaf not in _GRU_LEAVES or m is None:
        return path
    suffix = f"_l{m.group(2) or 0}" + ("_reverse" if m.group(1) == "bwd"
                                      else "")
    return ".".join([*module[1:], _GRU_LEAVES[leaf] + suffix])


def torch_state_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """``vqatpu`` param tree -> the port's ``state_dict`` (float32)."""
    return {_torch_key(path): torch.from_numpy(np.array(leaf, np.float32))
            for path, leaf in _flatten(params).items()}


_GRU_NAMES = {v: k for k, v in _GRU_LEAVES.items()}


def _jax_path(key: str) -> str:
    *module, leaf = key.split(".")
    m = re.fullmatch(r"(\w+)_l(\d+)(_reverse)?", leaf)
    if m is None or m.group(1) not in _GRU_NAMES:
        return key
    direction = "bwd" if m.group(3) else "fwd"
    if m.group(2) != "0":
        direction += f"_l{m.group(2)}"
    return ".".join([*module, direction, _GRU_NAMES[m.group(1)]])


def jax_params_from_torch(state_dict: Dict[str, torch.Tensor]) -> dict:
    """The port's ``state_dict`` -> a ``vqatpu`` param tree with numpy
    float32 leaves: the inverse of :func:`torch_state_from_jax`."""
    tree: dict = {}
    for key, value in state_dict.items():
        *parents, leaf = _jax_path(key).split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value.detach().cpu().numpy().astype(np.float32)
    return tree


def shard_state(full_state: Dict[str, torch.Tensor], mesh
                ) -> Dict[str, torch.Tensor]:
    """This rank's slice of a full port state under the mesh's
    tensor-parallel layout (:func:`vqatpu_torch.parallel.sharding.
    param_shardings` of the full state)."""
    from vqatpu_torch.parallel.sharding import shard_params

    return shard_params(full_state, mesh)


def gather_state(local_state: Dict[str, torch.Tensor], mesh,
                 specs: Dict[str, Optional[int]]
                 ) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`shard_state`: every model rank's slices of the
    split keys (``specs``, the full state's layout) concatenated; a
    collective over the model group, which every rank of it calls."""
    return {k: v if specs.get(k) is None else mesh.model.all_gather(v, specs[k])
            for k, v in local_state.items()}


def load_jax_params(model: nn.Module, params: dict) -> nn.Module:
    """Load a ``vqatpu`` param tree into ``model``; strict."""
    model.load_state_dict(torch_state_from_jax(params), strict=True)
    return model


class _Inert:
    """Stands in for every class a checkpoint names outside numpy's arrays,
    plain containers and the optimizer state's NamedTuples
    (:data:`STATE_TUPLES`), which would otherwise import JAX."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


# the NamedTuples of a ``vqatpu`` checkpoint's ``opt_state`` (optax's and
# ``vqatpu.train.optim.AdamaxState``), by class name, with their fields in
# order; the unpickler builds stand-ins with the same fields, so the tree
# reads without optax or JAX
STATE_TUPLES = {
    "InjectHyperparamsState": ("count", "hyperparams", "inner_state"),
    "InjectStatefulHyperparamsState": ("count", "hyperparams",
                                       "hyperparams_states", "inner_state"),
    "MaskedState": ("inner_state",),
    "MaskedNode": (),
    "EmptyState": (),
    "AdamaxState": ("count", "m", "u"),
}
_STAND_INS = {name: collections.namedtuple(name, fields)
              for name, fields in STATE_TUPLES.items()}

_NUMPY_NAMES = {"_reconstruct", "_frombuffer", "ndarray", "dtype", "scalar"}
_BUILTIN_NAMES = {"dict", "list", "tuple", "set", "frozenset", "int",
                  "float", "complex", "bool", "str", "bytes", "bytearray",
                  "slice", "range"}


class _ParamsUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        root = module.split(".")[0]
        if ((root == "numpy" and name in _NUMPY_NAMES)
                or (module == "builtins" and name in _BUILTIN_NAMES)
                or module == "collections"):
            return super().find_class(module, name)
        if root in ("optax", "vqatpu") and name in _STAND_INS:
            return _STAND_INS[name]
        if (module, name) == ("ml_dtypes", "bfloat16"):
            try:  # a bfloat16 optimizer state; numpy has no bf16 of its own
                return super().find_class(module, name)
            except ImportError:
                raise ValueError("the checkpoint holds bfloat16 arrays, which "
                                 "need the ml_dtypes package") from None
        return _Inert


def load_pickle(path: str):
    """A ``vqatpu`` or port pickle (checkpoint, params file), read without
    JAX or optax: numpy arrays, builtins, the optimizer state's NamedTuples
    as stand-ins (:data:`STATE_TUPLES`) and inert objects for anything
    else."""
    with open(path, "rb") as f:
        return _ParamsUnpickler(f).load()


def load_params_file(path: str) -> dict:
    """The param tree of a ``vqatpu`` checkpoint (``{"params": ...,
    "opt_state": ...}``) or ``save_params`` file (``{"params": ...}``)."""
    payload = load_pickle(path)
    return payload["params"] if "params" in payload else payload


def numpy_params(cfg: ModelConfig, seed: int = 0) -> dict:
    """Seeded weights of a model as a ``vqatpu`` param tree with numpy
    leaves, of the structure and shapes of the JAX model's ``init``: the
    free-form ``ban``, ``san`` or ``stacked_attention`` and ``cti``, and
    for ``task="mc"`` TanModel (``cti`` or ``tan``; CTI's tree with the
    attention under ``v_att`` and a 2-class classifier), BanModelMC
    (``ban``: ``va_att``, ``tva_net{g}`` and ``a_prj{g}`` besides BAN's)
    and SAN-MC (``san``: ``wa_emb``, ``a_emb`` and ``va_att``).

    Linears and GRUs draw torch-style U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    with weight-norm ``g = ||v||_F``; embeddings, the PARALIND core and
    BAN's ``h_mat`` and ``h_bias`` draw N(0, 1), with the embedding pad row
    zero and ``h_mat_g = ||h_mat||_F`` (``vqatpu/ops/attention.py:60-64``);
    the counter's ``PiecewiseLin`` weights are ones with ``weight[0] = 0``."""
    models = ("ban", "san", "stacked_attention", "cti")
    if cfg.task == "mc":
        models += ("tan",)
    if cfg.task not in ("ffoe", "mc") or cfg.model not in models:
        raise NotImplementedError(f"numpy_params makes no weights of "
                                  f"{cfg.task}/{cfg.model}")
    mc = cfg.task == "mc"
    rs = np.random.RandomState(seed)
    H, R = cfg.num_hid, cfg.rank

    def uni(shape, fan_in):
        bound = 1.0 / np.sqrt(fan_in)
        return rs.uniform(-bound, bound, shape).astype(np.float32)

    def fcnet(i, o):
        v = uni((o, i), i)
        g = np.asarray(np.linalg.norm(v), np.float32)
        return {"l0": {"v": v, "g": g, "b": uni((o,), i)}}

    def linear(i, o, bias=True):
        p = {"w": uni((o, i), i)}
        if bias:
            p["b"] = uni((o,), i)
        return p

    def rank_net(d, h_sub):
        v = uni((R, h_sub, d), d)
        g = np.linalg.norm(v.reshape(R, -1), axis=1).astype(np.float32)
        return {"l0": {"v": v, "g": g, "b": uni((R, h_sub), d)}}

    def embedding():
        p = {}
        for name in ("emb", "emb_") if "c" in cfg.op else ("emb",):
            t = rs.randn(cfg.ntoken + 1, 300).astype(np.float32)
            t[-1] = 0.0
            p[name] = t
        return p

    def gru():
        p = {}
        for layer in range(cfg.num_layers):
            d = cfg.word_dim if layer == 0 else H
            p["fwd" if layer == 0 else f"fwd_l{layer}"] = {
                "w_ih": uni((3 * H, d), H), "w_hh": uni((3 * H, H), H),
                "b_ih": uni((3 * H,), H), "b_hh": uni((3 * H,), H)}
        return p

    def classifier():
        l1, l2 = fcnet(H, 2 * H)["l0"], fcnet(2 * H, cfg.num_classes)["l0"]
        return {"l1": l1, "l2": l2}

    def biattention():
        h_mat = rs.randn(1, cfg.gamma, 1, 3 * H).astype(np.float32)
        bc = {"v_net": fcnet(cfg.v_dim, 3 * H), "q_net": fcnet(H, 3 * H),
              "h_mat": h_mat,
              "h_bias": rs.randn(1, cfg.gamma, 1, 1).astype(np.float32)}
        return {"bc": bc, "h_mat_g": np.asarray(np.linalg.norm(h_mat),
                                                np.float32)}

    if cfg.model == "ban":
        v_att = biattention()  # drawn before the embeddings, as ever
        p = {"w_emb": embedding(), "q_emb": gru(), "v_att": v_att,
             "classifier": classifier()}
        if mc:
            p.update(wa_emb=embedding(), ans_emb=gru(), va_att=biattention())
        for g in range(cfg.gamma):
            p[f"b_net{g}"] = {"v_net": fcnet(cfg.v_dim, H),
                              "q_net": fcnet(H, H)}
            p[f"q_prj{g}"] = fcnet(H, H)
            if mc:
                p[f"tva_net{g}"] = {"v_net": fcnet(cfg.v_dim, H),
                                    "q_net": fcnet(H, H)}
                p[f"a_prj{g}"] = fcnet(H, H)
            if cfg.use_counter:
                p[f"c_prj{g}"] = fcnet(cfg.objects + 1, H)
        if cfg.use_counter:
            w = np.ones(17, np.float32)
            w[0] = 0.0
            p["counter"] = {f"f{i}": {"weight": w.copy()} for i in range(8)}
        return p
    def stacked_attention():
        att = {"fc11": linear(H, H), "fc12": linear(cfg.v_dim, H, False),
               "fc13": linear(H, 1), "fc14": linear(H, H),
               "fc15": linear(cfg.v_dim, H, False)}
        for s in range(cfg.num_stacks - 1):
            att[f"w{s}_q"] = linear(H, H)
            att[f"w{s}_i"] = linear(cfg.v_dim, H, False)
            att[f"w{s}_h"] = linear(H, 1)
        return att

    if cfg.model in ("san", "stacked_attention"):
        v_att = stacked_attention()  # drawn before the embeddings, as ever
        p = {"w_emb": embedding(), "q_emb": gru(), "v_att": v_att,
             "classifier": classifier()}
        if mc:
            p.update(wa_emb=embedding(), a_emb=gru(),
                     va_att=stacked_attention())
        return p

    def tucker(d):
        return {"v_tucker": fcnet(cfg.v_dim, d), "q_tucker": fcnet(H, d),
                "a_tucker": fcnet(H, d)}

    d_att, h_sub = cfg.h_mm * cfg.k, cfg.h_mm // R
    tc = tucker(d_att)
    if d_att < 1024:
        tc.update(v_net=rank_net(d_att, h_sub), q_net=rank_net(d_att, h_sub),
                  a_net=rank_net(d_att, h_sub),
                  T_g=rs.randn(R, h_sub, h_sub, h_sub, cfg.gamma, 1)
                  .astype(np.float32))
    cls = classifier()  # drawn before the embeddings, as ever
    p = {"w_emb": embedding(), "q_emb": gru(), "wa_emb": embedding(),
         "ans_emb": gru(), "v_att" if mc else "t_att": {"tc": tc},
         "classifier": cls}
    for g in range(cfg.gamma):
        p[f"t_net{g}"] = tucker(2 * cfg.h_mm)
        p[f"q_prj{g}"] = fcnet(H, H)
        p[f"a_prj{g}"] = fcnet(H, H)
    return p


def numpy_batch(cfg: ModelConfig, n: int, seed: int = 0, boxes: int = 50,
                real_boxes: int = 44, q_len: int = 12,
                a_len: Optional[int] = None, target: bool = False,
                teacher: bool = False) -> Dict[str, np.ndarray]:
    """Seeded inputs: ``v`` [n, boxes, v_dim] float32 with the boxes from
    ``real_boxes`` on zero (padding), ``q`` [n, q_len] int64 tokens in [0,
    ntoken] (ntoken is the pad token), and the spatials ``b`` [n, boxes,
    6] float32, ``(x1, y1, x2, y2, w, h)`` with ``x1 < x2`` and ``y1 < y2``
    in [0, 1], zero on the padded boxes.

    Free-form (``task="ffoe"``): ``a`` [n, a_len] tokens (``a_len`` 3 by
    default), with ``target`` a soft ``target`` [n, num_classes] float32
    in [0, 1), with ``teacher`` teacher logits ``t_logits`` [n,
    num_classes] float32, N(0, 3^2), for the distillation loss.

    Multiple choice (``task="mc"``): ``n`` questions, as a loader gives
    them before :func:`~vqatpu_torch.data.mc_dataset.expand_mc_batch`:
    ``ans_mc`` [n, 4, a_len] candidate tokens (``a_len`` 6 by default),
    ``label`` [n, 4] float32 one-hot of the true candidate, and ``qid``
    [n] int64; ``target`` and ``teacher`` do not apply.

    ``b`` and then ``t_logits`` are drawn last, so the other arrays do not
    depend on them."""
    mc = cfg.task == "mc"
    if a_len is None:
        a_len = 6 if mc else 3
    rs = np.random.RandomState(seed)
    v = rs.randn(n, boxes, cfg.v_dim).astype(np.float32)
    v[:, real_boxes:] = 0.0
    q = rs.randint(0, cfg.ntoken + 1, (n, q_len)).astype(np.int64)
    if mc:
        if target or teacher:
            raise ValueError("an MC batch's targets come from its labels")
        ans_mc = rs.randint(0, cfg.ntoken + 1, (n, 4, a_len)).astype(np.int64)
        label = np.eye(4, dtype=np.float32)[rs.randint(0, 4, n)]
        batch = {"v": v, "q": q, "ans_mc": ans_mc, "label": label,
                 "qid": np.arange(n, dtype=np.int64)}
    else:
        a = rs.randint(0, cfg.ntoken + 1, (n, a_len)).astype(np.int64)
        batch = {"v": v, "q": q, "a": a}
    if target:
        batch["target"] = rs.rand(n, cfg.num_classes).astype(np.float32)
    corners = np.sort(rs.rand(n, boxes, 2, 2), axis=-1)  # [.., (x, y), lo/hi]
    lo, hi = corners[..., 0], corners[..., 1]
    b = np.concatenate([lo, hi, hi - lo], -1).astype(np.float32)
    b[:, real_boxes:] = 0.0
    batch["b"] = b
    if teacher:
        batch["t_logits"] = (3.0 * rs.randn(n, cfg.num_classes)).astype(
            np.float32)
    return batch


def param_stats(params: dict) -> Dict[str, np.ndarray]:
    """Per-leaf ``l2`` norm, ``sum`` and ``l1`` norm (float64) of a
    ``vqatpu`` param tree, with the leaves' dotted ``names`` in sorted
    order: a compact fingerprint of the weights, for trajectories compared
    across devices and packages."""
    flat = _flatten(params)
    names = sorted(flat)
    leaves = [np.asarray(flat[n], np.float64) for n in names]
    return {"names": np.array(names),
            "l2": np.array([np.sqrt((x * x).sum()) for x in leaves]),
            "sum": np.array([x.sum() for x in leaves]),
            "l1": np.array([np.abs(x).sum() for x in leaves])}
