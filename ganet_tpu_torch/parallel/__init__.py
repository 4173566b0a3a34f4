"""Spatial (H) sharding of the SGA and LGA ops over `torch.distributed`
(counterpart of `ganet_tpu/parallel/`): process groups of the mesh,
neighbour exchanges, the SGA wavefront, the halo LGA, and a launcher of
ranks on one host.  Model-level sharding (halo convolutions, BatchNorm
over `space`), data parallelism and channel tensor parallelism are not
ported yet."""

from ganet_tpu_torch.parallel.mesh import Mesh, make_mesh
from ganet_tpu_torch.parallel.sharded_lga import sharded_lga
from ganet_tpu_torch.parallel.sharded_sga import chunk_layout, pipeline_stats, sharded_sga

__all__ = ["Mesh", "chunk_layout", "make_mesh", "pipeline_stats", "sharded_lga", "sharded_sga"]
