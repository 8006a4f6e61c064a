"""Mesh serving over torch.distributed: the sharding rules
(dist/sharding.py), the meshes of ranks with their collectives
(dist/context.py) and weights sharded over the data axis
(dist/fsdp.py)."""
from repro_torch.dist.context import (ServeMesh, broadcast_data,
                                      current_mesh, gather_data,
                                      gather_fsdp, gather_model,
                                      mesh_context, model_coords,
                                      reduce_fsdp, reduce_model, spawn)
from repro_torch.dist.sharding import (batch_pspec, cache_pspec,
                                       mesh_axis_sizes, named_pspec)

__all__ = ["ServeMesh", "broadcast_data", "current_mesh", "gather_data",
           "gather_fsdp", "gather_model", "mesh_context", "model_coords",
           "reduce_fsdp", "reduce_model", "spawn", "batch_pspec",
           "cache_pspec", "mesh_axis_sizes", "named_pspec"]
