"""Process groups of the mesh and their collectives over
`torch.distributed` (counterpart of `ganet_tpu/parallel/`): neighbour
exchanges, gathers and sums, the spatially (H) sharded SGA wavefront and
halo LGA, the halo convolutions and upsample of the H-sharded model, the blocks of
disparity bins of the `disp` axis (`parallel/disparity.py`) and the
boundary ops that gather them, the blocks of channels that the same axis
splits under channel tensor parallelism (`parallel/channels.py`), and a
launcher of ranks on one host.  The model predicts and trains on all
three axes (`models/ganet.py`, `entry.py`, `train/trainer.py`)."""

from ganet_tpu_torch.parallel.mesh import Mesh, inference_mesh, make_mesh
from ganet_tpu_torch.parallel.sharded_lga import sharded_lga
from ganet_tpu_torch.parallel.sharded_sga import chunk_layout, pipeline_stats, sharded_sga

__all__ = [
    "Mesh", "chunk_layout", "inference_mesh", "make_mesh", "pipeline_stats", "sharded_lga",
    "sharded_sga",
]
