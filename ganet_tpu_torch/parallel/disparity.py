"""Blocks of disparity bins over the mesh's `disp` axis (the counterpart of
the JAX package's `volume_sharding`, `P("data", "disp", "space")`, in
`ganet_tpu/parallel/mesh.py`).

From the cost volume to the heads' C -> 1 convs each rank of a `disp`
group holds one block of the conv phase's disparity bins, the blocks in
rank order along the group: `disp_block` gives a rank's bins, and the
halo convolutions of `parallel/spatial.py` take the bins their kernels
need from the neighbouring blocks.  The SGA sweeps couple every bin of a
pixel (the max over d), and the heads' upsample, softmax, LGA and
expectation run along D, so D is gathered around them
(`comm.gather_blocks`) and the result cut back to the block
(`comm.take_block`).

`check_disp_shape` is the rule that a configuration must meet to be
sharded over `disp`: every level of the hourglass is split, each block
starting on an even bin at every stride-2 conv.  This differs from the
JAX package, whose `constrain_volume` silently leaves a volume unsharded
when its D does not divide the mesh (`mesh.py:96-97`) and lets GSPMD
pad the levels that do not split evenly: the port shards every level or
raises, as `check_spatial_shape` does for `space`.
"""

from __future__ import annotations

import math

from ganet_tpu_torch.parallel import comm


def disp_block(n_bins: int, group=None) -> tuple[int, int]:
    """[start, stop) of this rank's block of `n_bins` disparity bins, split
    evenly over the ranks of `group` in rank order; (0, n_bins) for no
    group."""
    if group is None:
        return 0, n_bins
    idx, P = comm.group_rank(group)
    if n_bins % P:
        raise ValueError(f"{n_bins} disparity bins do not split into {P} equal blocks")
    per = n_bins // P
    return idx * per, (idx + 1) * per


def check_disp_shape(cfg, disp: int) -> None:
    """Raise ValueError, naming the sizes that pass, unless `disp` ranks can
    share the cost volume's max_disp / 3 bins: they must split into `disp`
    blocks whose size is a multiple of 2**agg_levels, so that every
    stride-2 conv of the hourglass starts each block on an even bin.  That
    is max_disp / 3 divisible by 2**agg_levels * disp."""
    if disp <= 1:
        return
    D3, unit = cfg.disp_channels, 2**cfg.agg_levels
    if D3 % (unit * disp) == 0:
        return
    fits = [p for p in range(1, D3 // unit + 1) if D3 % (unit * p) == 0]
    step = math.lcm(12, 3 * unit * disp)  # max_disp is a multiple of 12 too
    sizes = sorted({max(step, cfg.max_disp // step * step), -(-cfg.max_disp // step) * step})
    L = cfg.agg_levels
    raise ValueError(
        f"disp {disp} cannot share max_disp {cfg.max_disp}: {cfg.name} has {L} hourglass levels,"
        f" so its max_disp / 3 = {D3} bins must split into {disp} blocks of a multiple of"
        f" 2**{L} = {unit} bins, and max_disp must be a multiple of 3 * {unit} * {disp} ="
        f" {3 * unit * disp}; at max_disp {cfg.max_disp} disp may be {fits}, and at disp {disp}"
        f" max_disp (a multiple of 12) may be {' or '.join(map(str, sizes))}"
    )
