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

JAX's ``--ckpt_backend orbax`` checkpoints (``vqatpu/train/checkpoints.py:
171-206``), directories ``model_epoch{N}.orbax`` that orbax's
``PyTreeCheckpointer`` writes, are read and written without JAX, orbax or
tensorstore: ``_METADATA`` (JSON) lists the tree's leaves by key path,
each array a zarr v2 array (:mod:`vqatpu_torch.train.zarr2`) whose keys
lie in an OCDBT store (:mod:`vqatpu_torch.train.ocdbt`; orbax's default)
or are files of the directory (the plain layout, which the port writes).
The tree is ``{"epoch", "step", "params", "opt_state"}`` with optax's
NamedTuples as dicts and its tuple as a list: ``{"count", "hyperparams":
{"learning_rate"}, "hyperparams_states": {}, "inner_state": [adamax,
None]}``, ``adamax`` ``{"count", "m", "u"}``, or ``{"inner_state": {"count",
"m", "u"}}`` where ``emb_`` is frozen (``None`` at its m and u).

:func:`load_params_any` also reads the reference's ``model_epoch{N}.pth``
(:mod:`vqatpu_torch.tools.import_torch`).  Under tensor parallelism the
savers gather the whole state first (``mesh``).
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import time
from typing import Any, Iterator, Optional, Tuple

import numpy as np
import torch

from vqatpu_torch.train.ocdbt import OcdbtStore
from vqatpu_torch.train.steps import TrainState
from vqatpu_torch.train.zarr2 import BF16, DirStore, read_array, write_array
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


def _moment_trees(state: TrainState, leaf) -> Tuple[dict, dict]:
    """The Adamax m and u as ``vqatpu`` param trees: ``leaf(k, i, p)`` at
    parameter ``p`` of optimizer slot ``i`` (``k`` 0 for m, 1 for u),
    ``None`` at the frozen leaves."""
    slot = {id(p): i for i, p in enumerate(state.optimizer.params)}
    trees = ({}, {})
    for name, p in state.model.named_parameters():
        *parents, key = _jax_path(name).split(".")
        i = slot.get(id(p))
        for k, node in enumerate(trees):
            for part in parents:
                node = node.setdefault(part, {})
            node[key] = None if i is None else leaf(k, i, p)
    return trees


def _state_trees(state: TrainState, mesh=None) -> Tuple[dict, dict]:
    """The Adamax m and u as ``vqatpu`` param trees (float32 numpy; None
    at the frozen leaves)."""
    full = _full(mesh)
    moments = (state.optimizer.m, state.optimizer.u)
    return _moment_trees(state, lambda k, i, p: full(
        p, moments[k][i]).detach().cpu().float().numpy())


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
    as a ``vqatpu`` param tree, from ``{input_dir}/model_epoch{epoch}``
    ``.ckpt``, else ``.orbax``, else the reference's ``.pth``
    (``FFOE/test.py:157-166``; ``vqatpu/train/checkpoints.py:49-69``)."""
    ckpt = os.path.join(input_dir, f"model_epoch{epoch}.ckpt")
    if os.path.exists(ckpt):
        return load_params(ckpt)
    orbax_dir = os.path.join(input_dir, f"model_epoch{epoch}.orbax")
    if os.path.isdir(orbax_dir):
        return restore_orbax(orbax_dir)["params"]
    pth = os.path.join(input_dir, f"model_epoch{epoch}.pth")
    if os.path.exists(pth):
        from vqatpu_torch.tools.import_torch import import_checkpoint

        return import_checkpoint(pth, model)
    raise FileNotFoundError(
        f"no model_epoch{epoch}.{{ckpt,orbax,pth}} under {input_dir}")


# -- .orbax: JAX's save_checkpoint_orbax / restore_train_state_orbax --------

_SEQUENCE, _DICT = 1, 2  # orbax's key types
# the value types of the leaves orbax skips, and what it restores them as
_EMPTY = {"None": lambda: None, "Dict": dict, "List": list, "Tuple": tuple}
_ARRAYS = ("np.ndarray", "jax.Array")
_COUNT, _LR = object(), object()  # opt_state leaves restored by position


def _entries(tree, path=()) -> Iterator[Tuple[tuple, Any]]:
    """``(key path, leaf)`` in JAX's flattening order (dict keys sorted,
    sequences in order), each key ``(name, key type)``; ``None`` and empty
    containers are leaves, as orbax records them."""
    if isinstance(tree, dict) and tree:
        for k in sorted(tree):
            yield from _entries(tree[k], path + ((k, _DICT),))
    elif isinstance(tree, (list, tuple)) and tree:
        for i, v in enumerate(tree):
            yield from _entries(v, path + ((str(i), _SEQUENCE),))
    else:
        yield path, tree


def _skipped(leaf) -> bool:
    """A leaf with no data: ``None`` or an empty container."""
    return leaf is None or isinstance(leaf, (dict, list, tuple))


def restore_orbax(path: str) -> dict:
    """The tree of the ``.orbax`` checkpoint ``path``, as orbax's
    ``PyTreeCheckpointer().restore`` gives it: dicts, lists for sequences,
    numpy arrays (``bfloat16`` ones as float32), Python scalars, and
    ``None``, ``{}``, ``[]`` or ``()`` where orbax skipped a leaf.  Reads
    the OCDBT store or the plain layout, as ``_METADATA``'s ``use_ocdbt``
    says; older layouts (an aggregate msgpack ``checkpoint`` file, zarr3
    arrays) raise, naming the file."""
    meta_path = os.path.join(path, "_METADATA")
    if not os.path.exists(meta_path):
        aggregate = os.path.join(path, "checkpoint")
        if os.path.exists(aggregate):
            raise ValueError(f"{aggregate}: an aggregate (msgpack) orbax "
                             "checkpoint, a layout that is not read")
        raise FileNotFoundError(f"{meta_path}: no orbax checkpoint here")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError(f"{meta_path}: zarr3 arrays (use_zarr3) are not "
                         "read")
    store = OcdbtStore(path) if meta.get("use_ocdbt") else DirStore(path)
    root: dict = {}
    sequences = set()  # the ids of the nodes whose keys are indices
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        node = root
        for depth, k in enumerate(keys):
            if k["key_type"] not in (_SEQUENCE, _DICT):
                raise ValueError(f"{meta_path}: key type {k['key_type']}")
            if k["key_type"] == _SEQUENCE:
                sequences.add(id(node))
            if depth < len(keys) - 1:
                node = node.setdefault(k["key"], {})
        node[keys[-1]["key"]] = _orbax_leaf(
            store, ".".join(k["key"] for k in keys), entry["value_metadata"],
            meta_path)

    def finish(node):
        if not isinstance(node, dict) or not node:
            return node
        if id(node) in sequences:
            return [finish(node[str(i)]) for i in range(len(node))]
        return {k: finish(v) for k, v in node.items()}

    return finish(root)


def _orbax_leaf(store, name: str, value: dict, where: str):
    kind = value["value_type"]
    if value.get("skip_deserialize"):
        if kind not in _EMPTY:
            raise ValueError(f"{where}: {name}: skipped value type {kind!r}")
        return _EMPTY[kind]()
    if kind in _ARRAYS:
        return read_array(store, name)
    if kind == "scalar":
        return read_array(store, name).item()
    raise ValueError(f"{where}: {name}: value type {kind!r} is not read")


def _opt_state(state: TrainState, count, lr, moment) -> dict:
    """JAX's ``opt_state`` (see the module docstring) for ``state``, with
    ``count`` and ``lr`` at its counts and learning rate and
    ``moment(k, i, p)`` at m (``k`` 0) and u (1) of trainable ``p``."""
    m, u = _moment_trees(state, moment)
    adamax = {"count": count, "m": m, "u": u}
    opt = state.optimizer
    if len(opt.params) < sum(1 for _ in state.model.parameters()):
        adamax = {"inner_state": adamax}  # optax.masked
    return {"count": count, "hyperparams": {"learning_rate": lr},
            "hyperparams_states": {}, "inner_state": [adamax, None]}


def _host(t: torch.Tensor):
    """A moment or parameter on the host: numpy, or a CPU tensor at
    bfloat16, which numpy lacks."""
    t = t.detach().cpu()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def save_checkpoint_orbax(path: str, state: TrainState, epoch: int,
                          mesh=None, write: bool = True) -> None:
    """Write ``state`` at the end of ``epoch`` as JAX's
    ``save_checkpoint_orbax`` does (``vqatpu/train/checkpoints.py:171-183``):
    ``epoch``, ``step``, ``params`` and ``opt_state`` with JAX's key paths
    and dtypes (the Adamax moments in their storage dtype), a
    ``_METADATA`` equal to the one JAX writes for the same state.  It is
    orbax's plain layout (``"use_ocdbt": false``; orbax reads both), one
    zstd (level 1) chunk an array, written into a temporary sibling
    directory and renamed.  ``path`` must not exist (orbax's rule).

    Under DDP or tensor parallelism (``mesh``) the ranks gather as
    :func:`save_checkpoint` does and the ranks with ``write`` False stop
    there; JAX's processes write their shards collectively instead, and
    either directory restores to the same content."""
    opt = state.optimizer
    full = _full(mesh)
    moments = (opt.m, opt.u)
    tree = {
        "epoch": np.asarray(epoch),
        "step": np.asarray(int(state.step)),
        "params": jax_params_from_torch({n: full(p, p.detach()) for n, p in
                                         state.model.named_parameters()}),
        "opt_state": _opt_state(
            state, np.asarray(opt.count, np.int32),
            np.asarray(float(opt.lr), np.float32),
            lambda k, i, p: _host(full(p, moments[k][i]))),
    }
    if not write:
        return
    if os.path.exists(path):
        raise FileExistsError(f"{path} exists; orbax checkpoints are not "
                              "overwritten")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    start = time.time_ns()
    tmp = f"{path}.orbax-checkpoint-tmp-{start}"  # orbax's name for it
    os.makedirs(tmp)
    try:
        store = DirStore(tmp)
        tree_metadata = {}
        for keys, leaf in _entries(tree):
            names = tuple(k for k, _ in keys)
            if isinstance(leaf, torch.Tensor):  # bfloat16 bit patterns
                write_array(store, ".".join(names),
                            leaf.view(torch.int16).numpy().view(np.uint16),
                            dtype=BF16)
            elif not _skipped(leaf):
                write_array(store, ".".join(names), leaf)
            kind = ("None" if leaf is None else type(leaf).__name__.title()
                    if _skipped(leaf) else "np.ndarray")
            tree_metadata[repr(names)] = {
                "key_metadata": [{"key": k, "key_type": t} for k, t in keys],
                "value_metadata": {"value_type": kind,
                                   "skip_deserialize": _skipped(leaf)}}
        store.put("_METADATA", json.dumps({
            "tree_metadata": tree_metadata, "use_ocdbt": False,
            "use_zarr3": False, "store_array_data_equal_to_fill_value": True,
            "custom_metadata": None}).encode())
        store.put("_CHECKPOINT_METADATA", json.dumps({
            "item_handlers": "orbax.checkpoint._src.handlers."
                             "pytree_checkpoint_handler."
                             "PyTreeCheckpointHandler",
            "metrics": {}, "performance_metrics": {},
            "init_timestamp_nsecs": start,
            "commit_timestamp_nsecs": time.time_ns(),
            "custom_metadata": {}}).encode())
        os.rename(tmp, path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def restore_train_state_orbax(path: str, state: TrainState
                              ) -> Tuple[TrainState, int]:
    """Load a ``.orbax`` checkpoint of either package into ``state`` (made
    by ``make_train_state`` for the same model and ``tfidf_loaded``), in
    place, as JAX's ``restore_train_state_orbax`` does
    (``vqatpu/train/checkpoints.py:186-206``): the params by tree, the
    optimizer state by leaf order against the fresh state's (JAX's
    flattening order), the update count from the file; the accumulation
    window starts empty.  Returns ``(state, epoch + 1)``.  A checkpoint of
    another model or width raises ``ValueError``."""
    payload = restore_orbax(path)
    try:
        load_jax_params(state.model, payload["params"])
    except (RuntimeError, KeyError, NotImplementedError) as e:
        raise ValueError(f"incompatible checkpoint {path}: {e}") from e
    opt = state.optimizer
    moments = (opt.m, opt.u)
    targets = [leaf for _, leaf in _entries(_opt_state(
        state, _COUNT, _LR, lambda k, i, p: moments[k][i]))
        if not _skipped(leaf)]
    values = [leaf for _, leaf in _entries(payload["opt_state"])
              if not _skipped(leaf)]
    if len(values) != len(targets):
        raise ValueError(f"incompatible checkpoint {path}: its opt_state "
                         f"has {len(values)} leaves, the optimizer's "
                         f"{len(targets)}")
    for dst, value in zip(targets, values):
        value = np.asarray(value)
        if dst is _COUNT:  # optax's count, then Adamax's (the same)
            opt.count = int(value)
        elif dst is _LR:
            opt.lr = float(value)
        elif tuple(value.shape) != tuple(dst.shape):
            raise ValueError(f"incompatible checkpoint {path}: an optimizer "
                             f"leaf of shape {tuple(value.shape)}, expected "
                             f"{tuple(dst.shape)}")
        else:
            with torch.no_grad():
                dst.copy_(torch.from_numpy(np.array(value, np.float32)))
    state.grad_accum, state.accum_count = None, 0
    state.step = int(payload["step"])
    return state, int(payload["epoch"]) + 1
