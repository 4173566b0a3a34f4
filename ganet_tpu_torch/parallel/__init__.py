"""Process groups of the mesh and their collectives over
`torch.distributed` (counterpart of `ganet_tpu/parallel/`): neighbour
exchanges, gathers and sums, the spatially (H) sharded SGA wavefront and
halo LGA, the halo convolutions and upsample of the H-sharded model, and a
launcher of ranks on one host.  Data-parallel training uses the mesh's
`data` axis (`train/trainer.py`); sharded inference both axes
(`entry.py`).  Sharded training (BatchNorm over `space`, gradients
through the halo ops) and channel tensor parallelism are not ported yet."""

from ganet_tpu_torch.parallel.mesh import Mesh, inference_mesh, make_mesh
from ganet_tpu_torch.parallel.sharded_lga import sharded_lga
from ganet_tpu_torch.parallel.sharded_sga import chunk_layout, pipeline_stats, sharded_sga

__all__ = [
    "Mesh", "chunk_layout", "inference_mesh", "make_mesh", "pipeline_stats", "sharded_lga",
    "sharded_sga",
]
