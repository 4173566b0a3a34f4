"""Spatially-sharded LGA: radius-r halo exchange and the local stencil
(counterpart of `ganet_tpu/parallel/sharded_lga.py`).

With H split over the ranks of a process group, the 5x5 stencil needs only
`radius` rows from each neighbour.  For each repeat, one exchange brings
the rows above and below the block (`comm.halo_exchange`, zero at the
edge ranks: the unsharded op's zero padding), the local LGA (K2 forward,
K4 backward, through `ops.lga.lga_nchw`) filters the haloed block with the
guidance zero-padded by `radius` rows, and the halo rows' outputs are
dropped.  Each repeat exchanges again: the second pass filters the first
pass's output, whose border rows live on the neighbours.  Differentiable:
the exchange's backward sends the halo rows' cotangents back.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ganet_tpu_torch.ops.lga import lga_nchw
from ganet_tpu_torch.parallel import comm


def sharded_lga(
    x: torch.Tensor,
    g75: torch.Tensor,
    radius: int = 2,
    repeats: int = 1,
    group=None,
) -> torch.Tensor:
    """LGA on this rank's H block: x (B, D, Hl, W), guidance g75
    (B, 3*K*K, Hl, W), normalised by the caller; the blocks of the ranks of
    `group` (the default group when None), in rank order, make the whole
    image.  Each block must be at least `radius` rows tall.  Without an
    initialised process group the op runs as one shard."""
    _, S = comm.group_rank(group)
    Hl = x.shape[2]
    if Hl < radius:
        raise ValueError(
            f"H={Hl * S} must divide into >={radius}-row blocks over {S} 'space' shards"
        )
    comm.check_group(group)
    r = radius
    gh = F.pad(g75, (0, 0, r, r))  # the halo rows' outputs are dropped: no guidance
    for _ in range(repeats):
        top, bottom = comm.halo_exchange(x, r, group)
        xh = torch.cat([top, x, bottom], dim=2)
        x = lga_nchw(xh, gh, r, 1)[:, :, r:-r]
    return x

