"""Point-to-point exchanges along a process group: the counterpart of
`lax.ppermute` in the JAX package's sharded ops.

A shard sends rows to its neighbours along the `space` axis.  All
transfers of one step go in one `dist.batch_isend_irecv` call, which
returns when every one of them is done.

Backends.  The caller picks the backend when it initialises the process
group; nothing here switches it.
  * gloo moves CPU tensors only, so CUDA tensors are staged through host
    memory explicitly: a send copies to the host, a receive lands in a host
    buffer and is copied to the device.  This is the route when several
    ranks share one card (NCCL refuses two ranks of a communicator on one
    device), and on the CPU.
  * nccl moves device tensors directly.  `check_group` raises when two
    ranks of the group share a device.
"""

from __future__ import annotations

import socket
from typing import Sequence, Tuple

import torch
import torch.distributed as dist

_checked: set = set()


def group_rank(group=None) -> Tuple[int, int]:
    """(this rank's index in `group`, the group's size); (0, 1) when
    torch.distributed is not initialised."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def check_group(group=None) -> None:
    """Collective on `group`, once per group: with NCCL, raise if two ranks
    of the group use one device.  Every rank of the group must call it."""
    if not dist.is_initialized() or id(group) in _checked:
        return
    if dist.get_backend(group) == "nccl":
        mine = (socket.gethostname(), torch.cuda.current_device())
        seen = [None] * dist.get_world_size(group)
        dist.all_gather_object(seen, mine, group=group)
        if len(set(seen)) != len(seen):
            raise RuntimeError(
                f"NCCL needs one device per rank; the group's ranks use {seen}. "
                "Ranks that share a card exchange over gloo."
            )
    _checked.add(id(group))


def exchange(
    sends: Sequence[Tuple[torch.Tensor, int]],
    recvs: Sequence[Tuple[torch.Tensor, int]],
    group=None,
) -> None:
    """Send each (tensor, peer) and receive into each (buffer, peer), peers
    given as ranks within `group`, in one `batch_isend_irecv`; returns when
    all are done.  The two sides of a transfer must list it at the same
    step."""
    if not sends and not recvs:
        return
    group = group if group is not None else dist.group.WORLD
    stage = dist.get_backend(group) == "gloo"
    ops, landed = [], []
    for t, peer in sends:
        src = t.detach()
        if stage and src.is_cuda:
            src = src.cpu()
        ops.append(dist.P2POp(dist.isend, src.contiguous(), dist.get_global_rank(group, peer), group))
    for buf, peer in recvs:
        dst = torch.empty(buf.shape, dtype=buf.dtype) if stage and buf.is_cuda else buf
        ops.append(dist.P2POp(dist.irecv, dst, dist.get_global_rank(group, peer), group))
        landed.append((buf, dst))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for buf, dst in landed:
        if dst is not buf:
            buf.copy_(dst)


def _halo_swap(lo: torch.Tensor, hi: torch.Tensor, group):
    """Send `lo` to the previous rank and `hi` to the next; returns what
    the previous rank sent as its `hi` and the next as its `lo` (zeros at
    the group's edges)."""
    idx, S = group_rank(group)
    from_prev, from_next = torch.zeros_like(hi), torch.zeros_like(lo)
    sends, recvs = [], []
    if idx > 0:
        sends.append((lo, idx - 1))
        recvs.append((from_prev, idx - 1))
    if idx < S - 1:
        sends.append((hi, idx + 1))
        recvs.append((from_next, idx + 1))
    exchange(sends, recvs, group)
    return from_prev, from_next


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, radius: int, group):
        ctx.radius, ctx.group, ctx.shape = radius, group, x.shape
        return _halo_swap(x[:, :, :radius].contiguous(), x[:, :, -radius:].contiguous(), group)

    @staticmethod
    def backward(ctx, g_top: torch.Tensor, g_bottom: torch.Tensor):
        # The top halo came from the previous rank's last rows: its
        # cotangent goes back there, and the same on the other side.
        r = ctx.radius
        d_first, d_last = _halo_swap(g_top.contiguous(), g_bottom.contiguous(), ctx.group)
        dx = g_top.new_zeros(ctx.shape)
        dx[:, :, :r] += d_first
        dx[:, :, -r:] += d_last
        return dx, None, None


def halo_exchange(x: torch.Tensor, radius: int, group=None):
    """(top, bottom): the `radius` rows of dim 2 above and below this
    rank's block, from its neighbours along `group`, zero at the edges (the
    unsharded op's zero padding).  One exchange; differentiable, its
    backward is the reverse exchange."""
    return _HaloExchange.apply(x, radius, group)
