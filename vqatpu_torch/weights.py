"""Weights across the two packages, and seeded weights and inputs.

- :func:`torch_state_from_jax` turns a ``vqatpu`` param tree (nested dicts
  with numpy leaves, the format of ``vqatpu/train/checkpoints.py``) into the
  port's ``state_dict``.  Port keys are the tree paths joined with ``.``
  (``t_att.tc.v_net.l0.v``, ``t_net0.v_tucker.l0.g``), except the GRUs,
  whose ``fwd.w_ih`` / ``fwd_l{n}.w_ih`` (and ``w_hh``, ``b_ih``, ``b_hh``)
  leaves become ``nn.GRU``'s ``weight_ih_l{n}`` (...) parameters
  (``q_emb.fwd.w_ih`` -> ``q_emb.weight_ih_l0``).
- :func:`jax_params_from_torch` is its inverse: a ``state_dict`` back to
  a ``vqatpu`` param tree with numpy leaves.
- :func:`load_jax_params` loads such a tree strictly: a leaf left unused, a
  parameter left unset or a shape that differs raises.
- :func:`load_params_file` reads a ``model_epoch{N}.ckpt`` or a
  ``save_params`` file without importing JAX.
- :func:`numpy_params` and :func:`numpy_batch` make seeded CTI weights (in
  the JAX tree layout) and inputs with numpy, so both packages can be fed
  the same numbers.
- :func:`param_stats` fingerprints a param tree (per-leaf norms and sums)
  for trajectories compared across devices and packages.
"""

from __future__ import annotations

import pickle
from typing import Dict

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
    if leaf not in _GRU_LEAVES:
        return path
    if direction == "fwd":
        layer = 0
    elif direction.startswith("fwd_l"):
        layer = int(direction[len("fwd_l"):])
    else:
        raise NotImplementedError(
            f"{path}: bidirectional GRU weights are not ported yet")
    return ".".join([*module[1:], f"{_GRU_LEAVES[leaf]}_l{layer}"])


def torch_state_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """``vqatpu`` param tree -> the port's ``state_dict`` (float32)."""
    return {_torch_key(path): torch.from_numpy(np.array(leaf, np.float32))
            for path, leaf in _flatten(params).items()}


_GRU_NAMES = {v: k for k, v in _GRU_LEAVES.items()}


def _jax_path(key: str) -> str:
    *module, leaf = key.split(".")
    name, _, layer = leaf.rpartition("_l")
    if name not in _GRU_NAMES:
        return key
    direction = "fwd" if layer == "0" else f"fwd_l{layer}"
    return ".".join([*module, direction, _GRU_NAMES[name]])


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


def load_jax_params(model: nn.Module, params: dict) -> nn.Module:
    """Load a ``vqatpu`` param tree into ``model``; strict."""
    model.load_state_dict(torch_state_from_jax(params), strict=True)
    return model


class _Inert:
    """Stands in for every class a checkpoint names outside numpy's arrays
    and plain containers: the optimizer state's optax and
    ``vqatpu.train.optim`` NamedTuples, which would otherwise import JAX."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


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
        return _Inert


def load_params_file(path: str) -> dict:
    """The param tree of a ``vqatpu`` checkpoint (``{"params": ...,
    "opt_state": ...}``) or ``save_params`` file (``{"params": ...}``)."""
    with open(path, "rb") as f:
        payload = _ParamsUnpickler(f).load()
    return payload["params"] if "params" in payload else payload


def numpy_params(cfg: ModelConfig, seed: int = 0) -> dict:
    """Seeded CTI weights as a ``vqatpu`` param tree with numpy leaves.

    Linears and GRUs draw torch-style U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    with weight-norm ``g = ||v||_F``; embeddings and the PARALIND core draw
    N(0, 1), with the embedding pad row zero.  The tree has the structure
    and shapes of ``vqatpu.models.CTIModel.init``."""
    if (cfg.task, cfg.model) != ("ffoe", "cti"):
        raise NotImplementedError("numpy_params makes CTI weights only")
    rs = np.random.RandomState(seed)
    H, R = cfg.num_hid, cfg.rank

    def uni(shape, fan_in):
        bound = 1.0 / np.sqrt(fan_in)
        return rs.uniform(-bound, bound, shape).astype(np.float32)

    def fcnet(i, o):
        v = uni((o, i), i)
        g = np.asarray(np.linalg.norm(v), np.float32)
        return {"l0": {"v": v, "g": g, "b": uni((o,), i)}}

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
    cls = fcnet(H, 2 * H)["l0"], fcnet(2 * H, cfg.num_classes)["l0"]
    p = {"w_emb": embedding(), "q_emb": gru(), "wa_emb": embedding(),
         "ans_emb": gru(), "t_att": {"tc": tc},
         "classifier": {"l1": cls[0], "l2": cls[1]}}
    for g in range(cfg.gamma):
        p[f"t_net{g}"] = tucker(2 * cfg.h_mm)
        p[f"q_prj{g}"] = fcnet(H, H)
        p[f"a_prj{g}"] = fcnet(H, H)
    return p


def numpy_batch(cfg: ModelConfig, n: int, seed: int = 0, boxes: int = 50,
                real_boxes: int = 44, q_len: int = 12, a_len: int = 3,
                target: bool = False) -> Dict[str, np.ndarray]:
    """Seeded CTI inputs: ``v`` [n, boxes, v_dim] float32 with the boxes
    from ``real_boxes`` on zero (padding), ``q`` [n, q_len] and ``a``
    [n, a_len] int64 tokens in [0, ntoken] (ntoken is the pad token); with
    ``target``, a soft ``target`` [n, num_classes] float32 in [0, 1)."""
    rs = np.random.RandomState(seed)
    v = rs.randn(n, boxes, cfg.v_dim).astype(np.float32)
    v[:, real_boxes:] = 0.0
    q = rs.randint(0, cfg.ntoken + 1, (n, q_len)).astype(np.int64)
    a = rs.randint(0, cfg.ntoken + 1, (n, a_len)).astype(np.int64)
    batch = {"v": v, "q": q, "a": a}
    if target:
        batch["target"] = rs.rand(n, cfg.num_classes).astype(np.float32)
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
