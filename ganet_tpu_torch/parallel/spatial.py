"""Ops on a block of rows of a volume sharded along H over the mesh's
`space` axis (the counterpart of what GSPMD partitions around the JAX
package's `constrain_volume` in `ganet_tpu/models/aggregation.py`).

From the cost volume on, each rank of a `space` group holds one block of
H rows of every volume, the blocks in rank order along the group.  Each op
here takes the rank's block and the rows it needs from its neighbours
(`comm.halo_exchange`), so that the ranks' output blocks, joined in rank
order, are the unsharded op's output:

  halo_conv_same           a "SAME" conv, 2D or 3D, stride 1 or 2, with
                           an optional per-output-channel scale (the eval
                           BatchNorm folded in): the H pad of XLA's rule,
                           (1, 1) at stride 1 and (0, 1) at stride 2, is
                           taken from the neighbours, zeros only at the
                           image's edges.  At stride 2 each block must be
                           of even height, so that it starts on an even
                           row of the whole: its outputs are then its
                           block of the whole output;
  halo_conv_transpose      the stride-2, kernel-4 deconvolution (padding
                           1): one row from each neighbour; the haloed
                           block's 2 Hl + 4 output rows less 2 at each end;
  halo_trilinear_upsample  an integer ratio r along H (3 in the model):
                           one row from each neighbour and, at the image's
                           edges, the edge row repeated (the unsharded
                           resize clamps its source index there); the
                           haloed block's r (Hl + 2) output rows less r at
                           each end.

The two convolutions also take a `disp_group` (`parallel/disparity.py`):
the 3D volume x is then this rank's block of disparity bins (dim 2) as
well, and the D pad of XLA's rule, (1, 1) at stride 1 and (0, 1) at
stride 2, comes from the D neighbours first (zeros only at the first and
last bins; blocks of an even number of bins at stride 2), the
deconvolution's one bin from each, 2 less at each end of its output.
The H rows are then taken of the D-haloed block, so that the corner
elements a 3x3x3 kernel needs under both groups arrive in the two
exchanges, with no third.

The two convolutions take a `channel_group` too (channel tensor
parallelism, `parallel/channels.py`): x then holds every input channel
(the caller gathers its blocks, `channels.gather_channels`) and the output
is this rank's block of the output channels, made with that block of the
weights, bias and scale; the H halos of a `space` group work as before.

Each op with `group` None, or a group of one rank, is the unsharded op
(and likewise for `disp_group` and `channel_group`).
`row_block` gives a rank's rows, and `check_spatial_shape` the rule that
the model's shapes must meet to be sharded.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from ganet_tpu_torch.ops.disparity import trilinear_upsample
from ganet_tpu_torch.parallel import comm
from ganet_tpu_torch.parallel.channels import channel_slice


def same_padding(
    sizes: Sequence[int], kernel: int, stride: int
) -> list[tuple[int, int]]:
    """(low, high) padding of each spatial dim under XLA's "SAME" rule."""
    pads = []
    for n in sizes:
        out = -(-n // stride)
        total = max((out - 1) * stride + kernel - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def space_size(group) -> int:
    """The number of ranks that share H: 1 for no group."""
    return comm.group_size(group)


def row_block(n_rows: int, group=None) -> tuple[int, int]:
    """[start, stop) of this rank's block of `n_rows` rows, split evenly
    over the ranks of `group` in rank order; (0, n_rows) for no group."""
    if group is None:
        return 0, n_rows
    idx, S = comm.group_rank(group)
    if n_rows % S:
        raise ValueError(f"{n_rows} rows do not split into {S} equal blocks")
    per = n_rows // S
    return idx * per, (idx + 1) * per


def check_spatial_shape(cfg, height: int, space: int) -> None:
    """Raise ValueError unless `space` ranks can share an image of `height`
    rows: the cost volume's H/3 rows must split into `space` blocks whose
    height divides by 2**agg_levels, so that every stride-2 conv of the
    hourglass starts each block on an even row.  That is H divisible by
    3 * 2**agg_levels * space.  (The JAX package leaves a level that its
    mesh does not divide unsharded and lets GSPMD pad; the port shards
    every level or none.)"""
    if space <= 1:
        return
    unit = 3 * 2**cfg.agg_levels
    if height % (unit * space) == 0:
        return
    fits = [s for s in range(1, height // unit + 1) if height % (unit * s) == 0]
    step = math.lcm(48, unit * space)
    heights = sorted({max(step, height // step * step), -(-height // step) * step})
    L = cfg.agg_levels
    raise ValueError(
        f"space {space} cannot share a height of {height}: {cfg.name} has {L} hourglass levels,"
        f" so its H/3 rows must split into {space} blocks of a multiple of 2**{L} = {2**L} rows,"
        f" and H must be a multiple of 3 * {2**L} * {space} = {unit * space}; at height {height}"
        f" space may be {fits}, and at space {space} the height (a multiple of 48) may be"
        f" {' or '.join(map(str, heights))}"
    )


def _halo_bins(x: torch.Tensor, above: int, below: int, group) -> torch.Tensor:
    """The 3D volume x with `above` bins of the previous rank's block before
    it and `below` bins of the next rank's after it, along D (dim 2)."""
    if x.dim() != 5:
        raise ValueError(f"a disparity halo needs a (B, C, D, H, W) volume, got {tuple(x.shape)}")
    top, bottom = comm.halo_exchange(x, above, group, below=below, dim=2)
    return torch.cat([top, x, bottom], dim=2)


def _halo_rows(x: torch.Tensor, above: int, below: int, group, edge: str = "zeros") -> torch.Tensor:
    """x with `above` rows of the previous rank's block on top and `below`
    rows of the next rank's under it, along H (dim -2)."""
    top, bottom = comm.halo_exchange(x, above, group, below=below, dim=x.dim() - 2, edge=edge)
    return torch.cat([top, x, bottom], dim=-2)


def halo_conv_same(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor | None = None,
    stride: int = 1,
    scale: torch.Tensor | None = None,
    group=None,
    disp_group=None,
    channel_group=None,
) -> torch.Tensor:
    """`weight` applied to this rank's block x (B, C, [D,] Hl, W) with
    "SAME" padding, in x's dtype; with `scale`, each output channel's
    weights times it first, in float32.  With a `disp_group`, x is this
    rank's block of D bins too; with a `channel_group`, the output is this
    rank's block of output channels."""
    k = weight.shape[-1]
    if channel_group is not None:
        weight = channel_slice(weight, channel_group)
        scale = None if scale is None else channel_slice(scale, channel_group)
        bias = None if bias is None else channel_slice(bias, channel_group)
    if scale is not None:
        weight = weight * scale.view((-1,) + (1,) * (weight.dim() - 1))
    weight = weight.to(x.dtype)
    bias = None if bias is None else bias.to(x.dtype)
    pads = same_padding(x.shape[2:], k, stride)
    if space_size(disp_group) > 1:
        if x.shape[2] % stride:
            raise ValueError(
                f"a stride-{stride} conv needs blocks of a multiple of {stride} bins, got {x.shape[2]}"
            )
        x = _halo_bins(x, *pads[0], disp_group)
        pads[0] = (0, 0)
    if space_size(group) > 1:
        if x.shape[-2] % stride:
            raise ValueError(
                f"a stride-{stride} conv needs blocks of a multiple of {stride} rows, got {x.shape[-2]}"
            )
        x = _halo_rows(x, *pads[-2], group)
        pads[-2] = (0, 0)
    fn = F.conv3d if x.dim() == 5 else F.conv2d
    if all(lo == hi for lo, hi in pads):
        return fn(x, weight, bias, stride=stride, padding=[lo for lo, _ in pads])
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]  # F.pad: last dim first
    return fn(F.pad(x, flat), weight, bias, stride=stride)


def halo_conv_transpose(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None, group=None,
    disp_group=None, channel_group=None,
) -> torch.Tensor:
    """The stride-2, kernel-4, padding-1 transposed conv of this rank's
    block x (B, C, [D,] Hl, W), in x's dtype: its block of 2 Hl rows (and
    with a `disp_group`, of its block of Dl bins, 2 Dl bins; with a
    `channel_group`, of its block of output channels)."""
    if weight.shape[-1] != 4:
        raise ValueError(f"the deconvolution has kernel 4, got {tuple(weight.shape)}")
    if channel_group is not None:
        weight = channel_slice(weight, channel_group, dim=1)
        bias = None if bias is None else channel_slice(bias, channel_group)
    weight = weight.to(x.dtype)
    bias = None if bias is None else bias.to(x.dtype)
    fn = F.conv_transpose3d if x.dim() == 5 else F.conv_transpose2d
    bins, rows = space_size(disp_group) > 1, space_size(group) > 1
    if bins:
        x = _halo_bins(x, 1, 1, disp_group)
    if rows:
        x = _halo_rows(x, 1, 1, group)
    y = fn(x, weight, bias, stride=2, padding=1)
    if bins:
        y = y[:, :, 2:-2]
    return y[..., 2:-2, :] if rows else y


def halo_trilinear_upsample(
    x: torch.Tensor, target_shape: Sequence[int], group=None
) -> torch.Tensor:
    """`trilinear_upsample` of this rank's block x (B, D, Hl, W) to its
    block (B, D', H', W') of the whole output, H' an integer multiple of
    Hl."""
    if space_size(group) == 1:
        return trilinear_upsample(x, target_shape)
    D2, H2, W2 = target_shape
    r, rest = divmod(H2, x.shape[2])
    if rest or r < 1:
        raise ValueError(f"{x.shape[2]} rows do not upsample to {H2} by an integer ratio")
    y = trilinear_upsample(_halo_rows(x, 1, 1, group, edge="edge"), (D2, H2 + 2 * r, W2))
    return y[:, :, r:-r]
