"""Checkpoint save and restore, in the format of ``vqatpu.train.checkpoints``
(``vqatpu/train/checkpoints.py:24-72, 118-163, 209-219``), so that either
package resumes the other's runs.

The policy is the reference's (``utils.py:98-106``, ``FFOE/train.py:108-116``):
``{output}/model_epoch{E}.ckpt`` every epoch from ``saving_epoch`` on, plus
``model_epoch_best.ckpt``; a resumed run restores params and optimizer state
and continues at ``epoch + 1``.

The file is a pickle of ``{"epoch", "params", "opt_state", "step",
"extra"}``: the params as a ``vqatpu`` param tree with numpy leaves
(:func:`vqatpu_torch.weights.jax_params_from_torch`) and ``opt_state`` as
JAX's optimizer state, which is optax's
``InjectStatefulHyperparamsState(count, hyperparams, hyperparams_states,
inner_state)`` around ``(MaskedState(AdamaxState(count, m, u)),
EmptyState())``, the ``MaskedState`` only where the GloVe copy ``emb_`` is
frozen (``MaskedNode`` leaves there).

- Reading: :func:`vqatpu_torch.weights.load_pickle` builds stand-ins with
  those NamedTuples' fields, so a JAX checkpoint reads without optax or
  JAX; m and u map onto the port's :class:`~vqatpu_torch.train.optim.
  Adamax` leaf by leaf through the param paths, and the Adamax count (its
  bias correction) with them.  Frozen leaves have no state.
- Writing: builtins and numpy only.  ``opt_state`` has that layout with
  each NamedTuple written as a dict keyed by field index, ``{0: count, 1:
  {"learning_rate": lr}, 2: {}, 3: ({0: count, 1: m, 2: u}, ())}``, and
  ``None`` at frozen leaves.  JAX's ``restore_train_state`` cannot map it
  onto its template directly and rebuilds it with ``_merge_opt_state``
  (``:74-110``), which takes a payload that is not a ``MaskedState`` as
  the inner state of one and reads a NamedTuple field by name where the
  payload has an attribute of that name, else by index: a tuple or list
  would hand it their ``count`` method, a dict its item.  m and u are
  written float32 whatever the Adamax storage.

:func:`load_params_any` also reads the reference's ``model_epoch{N}.pth``
(:mod:`vqatpu_torch.tools.import_torch`); JAX's ``.orbax`` checkpoints
are not read (orbax is JAX's; the port's processes write ``.ckpt``).
Under tensor parallelism :func:`save_checkpoint` gathers the whole state
first (``mesh``).
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Optional, Tuple

import numpy as np
import torch

from vqatpu_torch.train.steps import TrainState
from vqatpu_torch.weights import (_flatten, _jax_path, _torch_key,
                                  jax_params_from_torch, load_jax_params,
                                  load_pickle)
# the params of a checkpoint or save_params file, either package's
from vqatpu_torch.weights import load_params_file as load_params


def _full(mesh):
    """``(parameter, tensor) -> the whole tensor``: under tensor parallelism
    a split parameter's slices (and its Adamax moments') are gathered over
    the model group."""
    def full(p, t):
        dim = getattr(p, "_tp_dim", None)
        if mesh is None or dim is None:
            return t
        return mesh.model.all_gather(t, dim)
    return full


def _state_trees(state: TrainState, mesh=None):
    """The Adamax m and u as ``vqatpu`` param trees (float32 numpy; None
    at the frozen leaves)."""
    opt = state.optimizer
    slot = {id(p): i for i, p in enumerate(opt.params)}
    full = _full(mesh)
    trees = []
    for moments in (opt.m, opt.u):
        sd = {}
        for name, p in state.model.named_parameters():
            i = slot.get(id(p))
            sd[name] = None if i is None else full(p, moments[i].float())
        tree = jax_params_from_torch({k: v for k, v in sd.items()
                                      if v is not None})
        for name in (k for k, v in sd.items() if v is None):
            *parents, leaf = _jax_path(name).split(".")
            node = tree
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = None
        trees.append(tree)
    return trees


def save_checkpoint(path: str, state: TrainState, epoch: int,
                    extra: Optional[dict] = None, mesh=None,
                    write: bool = True) -> None:
    """Write ``state`` at the end of ``epoch`` (atomically: a temporary
    file, then a rename).  Under tensor parallelism (``mesh`` with ``tp >
    1``) the whole state is gathered first, a collective of the model
    group that each of its ranks calls, and the ranks with ``write``
    False stop there: the file is always the whole, JAX-readable state."""
    opt = state.optimizer
    m, u = _state_trees(state, mesh)
    full = _full(mesh)
    params = jax_params_from_torch({n: full(p, p.detach()) for n, p in
                                    state.model.named_parameters()})
    if not write:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    count = np.asarray(opt.count, np.int32)
    lr = np.asarray(float(opt.lr), np.float32)
    payload = {
        "epoch": epoch,
        "params": params,
        "opt_state": {0: count, 1: {"learning_rate": lr}, 2: {},
                      3: ({0: count, 1: m, 2: u}, ())},
        "step": int(state.step),
        "extra": extra or {},
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> dict:
    """A checkpoint's payload, written by either package."""
    return load_pickle(path)


def _fields_of(node) -> Optional[list]:
    """The items of a NamedTuple (a stand-in), a tuple or an index-keyed
    dict (the port's NamedTuples), in order; None for anything else."""
    if isinstance(node, tuple):
        return list(node)
    if isinstance(node, dict) and node and all(
            isinstance(k, int) for k in node):
        return [node[k] for k in sorted(node)]
    return None


def _find_adamax(node) -> Optional[list]:
    """``[count, m, u]`` of an ``opt_state``: an ``AdamaxState`` stand-in,
    or the port's index-keyed triple whose last two items are param trees;
    the optax wrappers around it are walked through."""
    if getattr(node, "_fields", None) == ("count", "m", "u"):
        return list(node)
    items = _fields_of(node)
    if items is None:
        return None
    if (isinstance(node, dict) and len(items) == 3
            and isinstance(items[1], dict) and isinstance(items[2], dict)):
        return items
    for child in items:
        found = _find_adamax(child)
        if found is not None:
            return found
    return None


def _is_state(x) -> bool:
    """False at a frozen leaf: ``None`` (port) or a ``MaskedNode``."""
    return x is not None and not isinstance(x, tuple)


def restore_train_state(path: str, state: TrainState
                        ) -> Tuple[TrainState, int, dict]:
    """Load a checkpoint of either package into ``state`` (made by
    ``make_train_state`` for the same model and ``tfidf_loaded``), in
    place: params, Adamax m, u and count, the update count; the
    accumulation window starts empty.  Returns ``(state, start_epoch,
    extra)``, ``extra`` carrying e.g. ``best_eval``.  A checkpoint of
    another model or width raises ``ValueError``.  A reference ``.pth``
    gives the params (imported for ``state.model``) and its epoch; the
    optimizer starts afresh, as after :func:`make_train_state` (the
    port's exporter writes no optimizer state)."""
    if path.endswith(".pth"):
        from vqatpu_torch.tools.import_torch import (convert_state_dict,
                                                     load_torch_checkpoint)

        sd, epoch = load_torch_checkpoint(path)
        load_jax_params(state.model, convert_state_dict(sd, state.model))
        state.grad_accum, state.accum_count = None, 0
        return state, (-1 if epoch is None else int(epoch)) + 1, {}
    payload = load_checkpoint(path)
    saved_model = (payload.get("extra") or {}).get("model")
    try:
        load_jax_params(state.model, payload["params"])
    except (RuntimeError, KeyError, NotImplementedError) as e:
        raise ValueError(
            f"incompatible checkpoint {path}: saved from model "
            f"{saved_model or '<unknown>'!r}, which the current model does "
            f"not match: {e}") from e
    adamax = _find_adamax(payload["opt_state"])
    if adamax is None:
        raise ValueError(f"incompatible checkpoint {path}: no Adamax state "
                         "in its opt_state")
    count, m_tree, u_tree = adamax
    opt = state.optimizer
    slot = {id(p): i for i, p in enumerate(opt.params)}
    params = dict(state.model.named_parameters())
    flat_m, flat_u = _flatten(m_tree), _flatten(u_tree)
    for path_, m in flat_m.items():
        p = params.get(_torch_key(path_))
        if p is None:
            raise ValueError(f"incompatible checkpoint {path}: optimizer "
                             f"state for {path_}, which the model lacks")
        i = slot.get(id(p))
        if i is None or not _is_state(m):
            # a frozen leaf: no state (old checkpoints carry some: dropped,
            # as JAX's _merge_opt_state drops it)
            if i is not None:
                raise ValueError(f"incompatible checkpoint {path}: no "
                                 f"optimizer state for trainable {path_}")
            continue
        for dst, src in ((opt.m[i], m), (opt.u[i], flat_u[path_])):
            src = torch.from_numpy(np.array(src, np.float32))
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"incompatible checkpoint {path}: {path_} "
                                 f"state of shape {tuple(src.shape)}, "
                                 f"expected {tuple(dst.shape)}")
            with torch.no_grad():
                dst.copy_(src)
    opt.count = int(np.asarray(count))
    hyper = (_fields_of(payload["opt_state"]) or [None, None])[1]
    if isinstance(hyper, dict) and "learning_rate" in hyper:
        opt.lr = float(np.asarray(hyper["learning_rate"]))
    state.grad_accum, state.accum_count = None, 0
    state.step = int(payload.get("step", 0))
    return state, payload["epoch"] + 1, (payload.get("extra") or {})


def save_params(path: str, params: Any) -> None:
    """``{"params": tree}``, the ``save_params`` file of both packages;
    ``params`` is a ``vqatpu`` param tree or a module's ``state_dict``."""
    if params and all(isinstance(v, torch.Tensor) for v in params.values()):
        params = jax_params_from_torch(params)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"params": params}, f, protocol=pickle.HIGHEST_PROTOCOL)


def load_params_any(input_dir: str, epoch, model) -> Any:
    """Eval params of ``model`` (a port module, for the ``.pth`` mapping)
    as a ``vqatpu`` param tree, from ``{input_dir}/model_epoch{epoch}.ckpt``
    or the reference's ``.pth`` (``FFOE/test.py:157-166``; ``vqatpu/train/
    checkpoints.py:49-69``).  JAX's ``.orbax`` directories are not read."""
    ckpt = os.path.join(input_dir, f"model_epoch{epoch}.ckpt")
    if os.path.exists(ckpt):
        return load_params(ckpt)
    if os.path.isdir(os.path.join(input_dir, f"model_epoch{epoch}.orbax")):
        raise NotImplementedError(
            "orbax checkpoints are not read by the port: they are JAX's, "
            "written by orbax, which the port does not use (ROADMAP: not "
            "ported, on purpose)")
    pth = os.path.join(input_dir, f"model_epoch{epoch}.pth")
    if os.path.exists(pth):
        from vqatpu_torch.tools.import_torch import import_checkpoint

        return import_checkpoint(pth, model)
    raise FileNotFoundError(
        f"no model_epoch{epoch}.{{ckpt,orbax,pth}} under {input_dir}")
