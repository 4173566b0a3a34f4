"""Process groups of the device mesh (counterpart of
`ganet_tpu/parallel/mesh.py:27-47`).

The JAX package lays its devices out as a (data, space, disp) mesh; here
each device is one rank of `torch.distributed`, laid out row-major over
(data, space, disp) as `make_mesh` reshapes the device list there, and
each axis is a set of process groups: one group for every line of ranks
along that axis.  The `data` axis carries data-parallel training (the
train step sums BatchNorm moments, losses, metrics and gradients over
`data_group`, `train/trainer.py`) and splits the batch of sharded
inference (`entry.predict`); the `space` axis the H-sharded model of
inference (`models/ganet.py`): its halo convolutions and upsample
(`parallel/spatial.py`), SGA wavefront and halo LGA
(`parallel/sharded_sga.py`, `parallel/sharded_lga.py`).  The `disp` axis
splits the conv phase's disparity bins, as the JAX package's
`volume_sharding` lays them out, `P("data", "disp", "space")`: each rank
of a `disp` line holds one block of the bins of every volume from the
cost volume to the heads' C -> 1 convs (`parallel/disparity.py`), and
the line gathers the bins around each SGA sweep and each head.  Under
`ModelConfig.channel_tp` the `disp` axis splits the same volumes'
channels instead (`parallel/channels.py`).  The same blocks train
(`train/trainer.py`): the loss and the metrics, which the heads compute
replicated over `disp`, sum over `volume_group`, the plane of `data` x
`space` ranks that share a `disp` index; the gradients, and the
aggregation's BatchNorm moments of blocks of bins, sum over the whole
mesh (`world_group`); those of blocks of channels over `volume_group`.

The JAX module's `batch_sharding`, `volume_sharding` and `constrain_*`
helpers are GSPMD sharding annotations, which have no counterpart in
eager PyTorch: a rank holds its own block and the sharded ops exchange
what they need explicitly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch.distributed as dist

from ganet_tpu_torch.config import MeshConfig

AXES = ("data", "space", "disp")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the mesh: its index along each axis and the
    process group of its line along each axis."""

    cfg: MeshConfig
    index: Dict[str, int]
    groups: Dict[str, dist.ProcessGroup]

    def size(self, axis: str) -> int:
        return getattr(self.cfg, axis)

    @property
    def data_group(self) -> dist.ProcessGroup:
        return self.groups["data"]

    @property
    def space_group(self) -> dist.ProcessGroup:
        return self.groups["space"]

    @property
    def disp_group(self) -> dist.ProcessGroup:
        return self.groups["disp"]

    @property
    def volume_group(self) -> dist.ProcessGroup:
        """The ranks that share this rank's `disp` index: the whole
        `data` x `space` plane, over which a train step sums the loss and
        the metrics (the world while `disp` is 1)."""
        return self.groups["volume"]

    @property
    def world_group(self) -> dist.ProcessGroup:
        """Every rank of the mesh, over which a train step sums what the
        blocks of the volumes hold: the aggregation's BatchNorm moments
        and the gradients."""
        return self.groups["world"]


def make_mesh(cfg: MeshConfig) -> Mesh:
    """Build the mesh's process groups over the initialised default group,
    whose world size must be `cfg.num_devices`.  Every rank calls it, in
    the same order with respect to other group creations."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised (see parallel/launch.py)")
    world, rank = dist.get_world_size(), dist.get_rank()
    shape = tuple(getattr(cfg, a) for a in AXES)
    if world != cfg.num_devices:
        raise ValueError(f"mesh {shape} needs {cfg.num_devices} ranks, the world has {world}")
    strides = (shape[1] * shape[2], shape[2], 1)
    index = {a: rank // s % n for a, s, n in zip(AXES, strides, shape)}
    groups = {}
    for k, axis in enumerate(AXES):
        # Every line along `axis`: the ranks that differ only in that index.
        others = [a for a in range(3) if a != k]
        for i in range(shape[others[0]]):
            for j in range(shape[others[1]]):
                base = i * strides[others[0]] + j * strides[others[1]]
                ranks = [base + t * strides[k] for t in range(shape[k])]
                group = dist.new_group(ranks)  # collective: every rank creates every group
                if rank in ranks:
                    groups[axis] = group
    for k in range(shape[2]):
        # Every data x space plane: the ranks of one disp index.
        ranks = [i * strides[0] + j * strides[1] + k for i in range(shape[0]) for j in range(shape[1])]
        group = dist.new_group(ranks)
        if rank in ranks:
            groups["volume"] = group
    groups["world"] = dist.group.WORLD
    return Mesh(cfg=cfg, index=index, groups=groups)


def inference_mesh(data: int, space: int) -> Optional[Mesh]:
    """The (data, space, 1) mesh of sharded inference over the initialised
    world (the counterpart of the JAX `predict.py`'s `build_mesh`), or None
    for one device.  A collective: every rank calls it."""
    if data * space <= 1:
        return None
    return make_mesh(MeshConfig(data=data, space=space, disp=1))
