"""Several processes (``vqatpu/parallel/distributed.py:30-92``).

JAX runs one process per host, each holding several devices, and
``jax.distributed`` joins them into one global device set.  PyTorch runs
one process per device: ``--num_processes`` is the number of devices in
the mesh (on one host or several), ``--process_id`` this process's global
rank, and ``--coordinator host:port`` the TCP rendezvous of
``torch.distributed.init_process_group`` (``tcp://host:port``), served by
rank 0.  ``--num_devices`` sizes the mesh, which must then equal the number
of processes.

- :func:`init_distributed` joins the process group: NCCL for CUDA, gloo
  for ``cpu_gloo`` (the CPU, or CUDA tensors where NCCL cannot run, as with
  two processes on one card).  Under NCCL each process takes the device
  ``process_id % torch.cuda.device_count()``.
- :func:`local_batch_slice`: this process's rows of a global batch that
  every process assembled alike (the same seeded loader everywhere).
- :func:`global_batch_from_local`: the local slice stays local; its rows
  are rows ``[i*per, (i+1)*per)`` of the global batch, which no process
  ever holds whole on its device.
- :func:`replicate_tree_global`: broadcast tensors from rank 0, so that
  every process starts from rank 0's state.
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch
import torch.distributed as dist

from vqatpu_torch.parallel.sharding import Mesh, replicate


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int, cpu_gloo: bool = False) -> str:
    """Join the process group; -> its backend."""
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is initialized already")
    backend = "gloo" if cpu_gloo else "nccl"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("NCCL needs CUDA; pass cpu_gloo=True (the "
                               "CLIs do with --device cpu)")
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    address = coordinator_address
    if "://" not in address:
        address = "tcp://" + address
    dist.init_process_group(backend, init_method=address,
                            world_size=num_processes, rank=process_id)
    return backend


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def global_batch_from_local(batch: dict, mesh: Mesh) -> dict:
    """This process's part of the global batch, as it is: each rank's step
    consumes its own rows, and the gradients are summed over the data
    axis."""
    return batch


def local_batch_slice(batch: dict, num_processes: Optional[int] = None,
                      process_id: Optional[int] = None) -> dict:
    """Rows ``[i*per, (i+1)*per)`` of every array of the batch; the batch
    size must divide evenly (JAX's assert)."""
    n = process_count() if num_processes is None else num_processes
    i = process_index() if process_id is None else process_id
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        assert b % n == 0, (k, b, n)
        per = b // n
        out[k] = v[i * per:(i + 1) * per]
    return out


def replicate_tree_global(tensors: Iterable[torch.Tensor],
                          mesh: Mesh) -> None:
    """Rank 0's values into every process's tensors, in place
    (:func:`~vqatpu_torch.parallel.sharding.replicate`)."""
    replicate(tensors, mesh)
