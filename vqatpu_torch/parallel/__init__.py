"""Several devices: the mesh, the tensor-parallel layout, the collectives
and the process group (counterpart of ``vqatpu.parallel``)."""

from vqatpu_torch.parallel.sharding import (Mesh, make_mesh, make_mesh_2d,
                                            param_shardings, replicate,
                                            shard_batch, shard_model,
                                            shard_params)

__all__ = [
    "Mesh", "make_mesh", "make_mesh_2d", "param_shardings", "replicate",
    "shard_batch", "shard_model", "shard_params",
]
