"""Blocks of channels over the mesh's `disp` axis: channel tensor
parallelism (`ModelConfig.channel_tp`; the counterpart of the JAX
package's `volume_sharding(mesh, channel_tp=True)`,
`P("data", None, "space", None, "disp")`, in `ganet_tpu/parallel/mesh.py`).

From the cost volume to the heads' C -> 1 convs each rank of a `disp`
group holds one block of the channels of every 5D volume, the blocks in
rank order along the group, with every disparity bin (and its block of
rows when `space` > 1).  The parameters and buffers stay whole on every
rank, as the JAX package keeps them replicated, and each layer takes its
block of them (`models/layers.py`, `models/aggregation.py`):

  3D convolutions  column-parallel: the blocks of the input are gathered
                   (`comm.column_gather`) and each rank convolves the
                   whole input with its block of output channels' weights,
                   bias and folded eval BatchNorm.  Each output channel is
                   then one whole convolution, as on one device, so that
                   bfloat16 rounds once, as there; a row-parallel conv
                   (partial outputs summed and scattered) would move as
                   many bytes but round each rank's partial sum;
  BatchNorm        on the block's channels: moments over `data` x `space`
                   only (each rank's channels are its own), the running
                   statistics of every channel gathered over the group;
  SGA sweeps       on the block, with the block of the weights taken from
                   the replicated guidance (`comm.take_block`): the
                   recurrence is independent per channel, so no collective;
  heads' C -> 1    row-parallel: each rank convolves its block with its
                   block of input channels' weights in float32 and the
                   partial one-channel volumes are summed over the group
                   (`comm.row_reduce`) into one volume replicated on the
                   line, C times fewer bytes than gathering the input; the
                   upsample, softmax, LGA and expectation then run whole.

`check_channel_shape` is the rule that a configuration must meet: the
group's size divides every width the sharded volumes carry.  This differs
from the JAX package, whose `constrain_volume` leaves a volume whose C the
mesh does not divide unsharded (`mesh.py:90-92`): the port splits every
volume or raises, as `check_disp_shape` does for bins.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ganet_tpu_torch.parallel import comm


def channel_block(n: int, group=None) -> tuple[int, int]:
    """[start, stop) of this rank's block of `n` channels, split evenly over
    the ranks of `group` in rank order; (0, n) for no group."""
    if group is None:
        return 0, n
    idx, P = comm.group_rank(group)
    if n % P:
        raise ValueError(f"{n} channels do not split into {P} equal blocks")
    per = n // P
    return idx * per, (idx + 1) * per


def channel_slice(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """This rank's block of `t` along `dim` (a parameter's or buffer's
    channels); `t` itself for no group or a group of one rank."""
    if comm.group_size(group) == 1:
        return t
    a, b = channel_block(t.shape[dim], group)
    return t.narrow(dim, a, b - a)


def gather_channels(parts: Sequence[torch.Tensor], group=None) -> torch.Tensor:
    """The whole input of a column-parallel convolution: each of `parts`
    (this rank's block of its channels) gathered over `group`
    (`comm.column_gather`), then joined along the channels in order.  The
    block of a concatenation is not the concatenation of the blocks, so a
    skip connection is gathered part by part."""
    parts = [comm.column_gather(p, 1, group) for p in parts]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def volume_widths(cfg) -> list[int]:
    """The channel widths of the volumes that channel TP splits: the cost
    volume's 2 * feature_channels and each level of the hourglass."""
    from ganet_tpu_torch.models.layers import channel_schedule

    return [2 * cfg.feature_channels] + channel_schedule(cfg.agg_channels, cfg.agg_levels)


def check_channel_shape(cfg, tp: int) -> None:
    """Raise ValueError, naming the sizes that pass, unless `tp` ranks can
    split every width of `volume_widths(cfg)` into equal blocks."""
    if tp <= 1:
        return
    widths = volume_widths(cfg)
    if all(w % tp == 0 for w in widths):
        return
    fits = [p for p in range(1, min(widths) + 1) if all(w % p == 0 for w in widths)]
    raise ValueError(
        f"channel_tp over disp {tp} cannot split {cfg.name}'s volumes: their widths {widths} (the"
        f" cost volume's 2 * {cfg.feature_channels}, then each hourglass level) must each divide"
        f" by {tp}; disp may be {fits}"
    )
