"""The device mesh and the tensor-parallel layout
(``vqatpu/parallel/sharding.py:29-127``).

JAX runs one process per host over a mesh of that host's devices and lets
GSPMD place every array by its ``NamedSharding``.  The port runs one
process per device (:mod:`vqatpu_torch.parallel.distributed`): a
:class:`Mesh` is this process's place in a ``dp x tp`` grid of processes,
global rank ``d * tp + m`` at data index ``d`` and model index ``m`` (the
device order of JAX's ``make_mesh_2d``), with a :class:`~vqatpu_torch.
parallel.collectives.Group` for its data axis (the ranks of equal ``m``),
its model axis (equal ``d``) and the world.

:func:`param_shardings` gives each key of a port state the dimension split
over the model axis, or None (replicated), by JAX's rules, leaf for leaf:

- the classifier's ``l2`` ``v``/``b`` on the output (vocab) dim;
- ``T_g`` and the stacked per-rank nets (``v_net``/``q_net``/``a_net``) on
  the PARALIND rank dim;
- the ``t_net{g}`` tuckers on ``d`` (column-parallel) and, only where
  ``t_net`` exists, ``q_prj{g}``/``a_prj{g}`` ``v`` on its input dim
  (row-parallel): Megatron's pairing;
- ``fits``: a leaf whose split dim the axis does not divide is replicated
  (the 3129-answer vocabulary at tp=2 and tp=4).

JAX's rules name the model axis on BAN's scalar weight-norm ``g`` of its
``BCNet`` ``v_net``/``q_net`` (a path ending ``v_net.l0.g``), where its
``fits`` raises ``IndexError``; the port raises a ``ValueError`` there:
neither package trains BAN with ``tp > 1``.

:func:`shard_model` puts a model on the mesh: each split parameter keeps
its slice (the ``Parameter`` object stays, so an optimizer built over it
stays valid), is tagged with ``_tp_dim``, and its module gets the model
group as ``tp``, which selects the tensor-parallel forward
(:mod:`vqatpu_torch.ops.linear`, :mod:`~vqatpu_torch.ops.trilinear`,
:mod:`~vqatpu_torch.ops.attention`, :mod:`~vqatpu_torch.ops.classifier`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

import torch
import torch.distributed as dist
from torch import nn

from vqatpu_torch.parallel.collectives import Group

@dataclasses.dataclass
class Mesh:
    """This process's place in the ``dp x tp`` process grid.  Without
    groups (``Mesh(dp, tp)``) it describes a layout only, as
    :func:`param_shardings` needs."""
    dp: int
    tp: int = 1
    rank: int = 0
    world: Optional[Group] = None
    data: Optional[Group] = None
    model: Optional[Group] = None

    @property
    def coords(self):
        """(data index, model index)."""
        return divmod(self.rank, self.tp)

    @property
    def primary(self) -> bool:
        return self.rank == 0


def _group(ranks, rank: int, backend: Optional[str]) -> Optional[Group]:
    """The group over ``ranks`` where this process is one of them, else
    None; every process creates every group, in the same order."""
    pg = dist.new_group(list(ranks)) if len(ranks) > 1 else None
    return Group(pg, ranks, rank, backend) if rank in ranks else None


def make_mesh_2d(dp: int, tp: int) -> Mesh:
    """The ``dp x tp`` mesh over all processes of the initialized process
    group (``dp * tp`` must be its size), or a one-process mesh where
    none is initialized."""
    init = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if init else 1
    if dp * tp != world:
        raise ValueError(f"a {dp} x {tp} mesh needs {dp * tp} processes, one "
                         f"a device; {world} are running")
    rank = dist.get_rank() if init else 0
    backend = dist.get_backend() if init else None
    model = [g for d in range(dp) if (g := _group(
        [d * tp + m for m in range(tp)], rank, backend))][0]
    data = [g for m in range(tp) if (g := _group(
        [d * tp + m for d in range(dp)], rank, backend))][0]
    world_group = Group(None, list(range(world)), rank, backend)
    return Mesh(dp, tp, rank, world_group, data, model)


def make_mesh(num_devices: Optional[int] = None) -> Mesh:
    """The data mesh over every process (``num_devices``, where given, must
    be their number: each process drives one device)."""
    init = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if init else 1
    if num_devices is not None and num_devices != world:
        raise ValueError(f"num_devices={num_devices}, but {world} processes "
                         "run: the port drives one device a process, so the "
                         "mesh has as many devices as processes")
    return make_mesh_2d(world, 1)


def _jax_path(key: str):
    from vqatpu_torch.weights import _jax_path as path_of

    return path_of(key).split(".")


def param_shardings(params, mesh: Mesh) -> Dict[str, Optional[int]]:
    """Key -> the dim split over the model axis, or None; ``params`` is a
    port state dict (or a module).  A 1-D mesh (``tp == 1``) replicates
    everything."""
    if isinstance(params, nn.Module):
        params = params.state_dict()
    tp = mesh.tp
    has_tnet = any(k.split(".")[0] == "t_net0" for k in params)
    out: Dict[str, Optional[int]] = {}
    for key, leaf in params.items():
        path = _jax_path(key)
        dim = None
        if tp > 1:
            if len(path) >= 2 and path[0] == "classifier" and path[-2] == "l2":
                dim = 0 if path[-1] in ("v", "b") else None
            elif path[-1] == "T_g":
                dim = 0
            elif len(path) >= 3 and path[-3] in ("v_net", "q_net", "a_net"):
                dim = 0
            elif (has_tnet and path[0].startswith("t_net") and len(path) >= 2
                  and path[1].endswith("_tucker")):
                dim = 0 if path[-1] in ("v", "b") else None
            elif has_tnet and path[0].startswith(("q_prj", "a_prj")):
                dim = 1 if path[-1] == "v" else None
        if dim is not None:
            shape = tuple(leaf.shape)
            if dim >= len(shape):
                raise ValueError(
                    f"{key}: JAX's layout splits dim {dim} of a leaf of shape "
                    f"{shape} over the model axis (its fits() raises "
                    "IndexError there): this model has no tensor-parallel "
                    "layout, train it with tp=1")
            if shape[dim] % tp:
                dim = None  # fits(): replicated
        out[key] = dim
    return out


def shard_leaf(t: torch.Tensor, dim: Optional[int], mesh: Mesh
               ) -> torch.Tensor:
    """This rank's slice of a full leaf along ``dim`` (None: the leaf)."""
    if dim is None:
        return t
    n = t.shape[dim] // mesh.tp
    return t.narrow(dim, mesh.coords[1] * n, n).contiguous()


def shard_params(params: Dict[str, torch.Tensor], mesh: Mesh
                 ) -> Dict[str, torch.Tensor]:
    """This rank's slices of a full state dict."""
    specs = param_shardings(params, mesh)
    return {k: shard_leaf(v, specs[k], mesh) for k, v in params.items()}


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of a global batch: its data index's slice (every
    rank of a model group takes the same rows)."""
    from vqatpu_torch.parallel.distributed import local_batch_slice

    return local_batch_slice(batch, mesh.dp, mesh.coords[0])


def replicate(tensors: Iterable[torch.Tensor], mesh: Mesh) -> None:
    """Give every process global rank 0's values, in place."""
    for t in tensors:
        mesh.world.broadcast(t, 0)


def shard_model(model: nn.Module, mesh: Mesh) -> Dict[str, Optional[int]]:
    """Put ``model`` (full weights, on its device) on the mesh in place:
    split parameters keep their slice and are tagged ``_tp_dim``, their
    modules get ``tp`` (the model group) and weight-normed linears
    ``tp_dim``.  Returns :func:`param_shardings`."""
    specs = param_shardings(model.state_dict(), mesh)
    for name, p in model.named_parameters():
        dim = specs.get(name)
        if dim is None:
            continue
        with torch.no_grad():
            p.data = shard_leaf(p.data, dim, mesh)
        p._tp_dim = dim
        owner = model.get_submodule(name.rpartition(".")[0])
        owner.tp = mesh.model
        if name.endswith(".v") and hasattr(owner, "tp_dim"):
            owner.tp_dim = dim
    return specs


def split_flags(params: Iterable[torch.Tensor]):
    """Per parameter: True where it holds a slice (see :func:`shard_model`)."""
    return [getattr(p, "_tp_dim", None) is not None for p in params]
