"""Collectives along a process group: the point-to-point exchanges that
stand for `lax.ppermute` in the JAX package's sharded ops, and the sums
that stand for the all-reduces XLA inserts into a data-parallel step.

A shard sends rows to its neighbours along the `space` axis.  All
transfers of one step go in one `dist.batch_isend_irecv` call, which
returns when every one of them is done.  `halo_exchange` brings the rows
above and below a block, for the sharded LGA and the halo convolutions
and upsample (`parallel/spatial.py`); `all_gather_cat` joins the ranks'
blocks of an output.  A data-parallel step sums
BatchNorm moments, valid-pixel counts, metrics and gradients over the
`data` axis with `all_reduce_` (in place) and `all_reduce_sum`
(differentiable).

Backends.  The caller picks the backend when it initialises the process
group; nothing here switches it.
  * gloo is the route when several ranks share one card (NCCL refuses two
    ranks of a communicator on one device), and on the CPU.  Its
    point-to-point transfers move CPU tensors only, so CUDA tensors are
    staged through host memory explicitly: a send copies to the host, a
    receive lands in a host buffer and is copied to the device.  Its
    all_reduce and all_gather take CUDA tensors and stage them through
    the host themselves.
  * nccl moves device tensors directly.  `check_group` raises when two
    ranks of the group share a device.
"""

from __future__ import annotations

import socket
from typing import Iterable, Sequence, Tuple

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


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum contiguous `t` over the ranks of `group` in place; returns it.
    Every rank gets the same bits."""
    dist.all_reduce(t, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, group):
        ctx.group = group
        return all_reduce_(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        # Every rank's output is the sum of every rank's input, so the
        # cotangent of an input is the sum of the ranks' cotangents.
        return all_reduce_(g.clone(memory_format=torch.contiguous_format), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of `x` over the ranks of `group`, as a new tensor;
    differentiable: its backward sums the cotangents over the ranks."""
    return _AllReduceSum.apply(x, group)


def all_reduce_grads(params: Iterable[torch.nn.Parameter], group=None) -> None:
    """Sum the parameters' gradients over the ranks of `group` in place,
    through one flat buffer a dtype.  Call it after backward, so that it
    cannot interleave with the collectives that backward issues on the
    same group.  Parameters without a gradient are left out; every rank
    must leave out the same ones."""
    by_dtype: dict = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads]), group)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))


def all_gather_cat(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """Every rank's `x` (all of one shape), joined along `dim` in the rank
    order of `group`; `x` itself for a group of one rank.  Not
    differentiable."""
    _, S = group_rank(group)
    if S == 1:
        return x
    src = x.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(S)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim)


def _halo_swap(lo: torch.Tensor, hi: torch.Tensor, group):
    """Send `lo` to the previous rank and `hi` to the next; returns what
    the previous rank sent as its `hi` and the next as its `lo` (zeros at
    the group's edges).  A side of no rows is not exchanged."""
    idx, S = group_rank(group)
    from_prev, from_next = torch.zeros_like(hi), torch.zeros_like(lo)
    sends, recvs = [], []
    if idx > 0:
        if lo.numel():
            sends.append((lo, idx - 1))
        if hi.numel():
            recvs.append((from_prev, idx - 1))
    if idx < S - 1:
        if hi.numel():
            sends.append((hi, idx + 1))
        if lo.numel():
            recvs.append((from_next, idx + 1))
    exchange(sends, recvs, group)
    return from_prev, from_next


EDGES = ("zeros", "edge")


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, above: int, below: int, dim: int, edge: str, group):
        ctx.above, ctx.below, ctx.dim, ctx.edge, ctx.group = above, below, dim, edge, group
        ctx.shape = x.shape
        n = x.shape[dim]
        top, bottom = _halo_swap(
            x.narrow(dim, 0, below).contiguous(), x.narrow(dim, n - above, above).contiguous(), group
        )
        if edge == "edge":
            # The image's edge row repeated, where the unsharded op clamps.
            idx, S = group_rank(group)
            if idx == 0:
                top = x.narrow(dim, 0, 1).expand_as(top).contiguous()
            if idx == S - 1:
                bottom = x.narrow(dim, n - 1, 1).expand_as(bottom).contiguous()
        return top, bottom

    @staticmethod
    def backward(ctx, g_top: torch.Tensor, g_bottom: torch.Tensor):
        # The top halo came from the previous rank's last rows: its
        # cotangent goes back there, and the same on the other side.
        a, b, dim = ctx.above, ctx.below, ctx.dim
        n = ctx.shape[dim]
        d_first, d_last = _halo_swap(g_top.contiguous(), g_bottom.contiguous(), ctx.group)
        dx = g_top.new_zeros(ctx.shape)
        dx.narrow(dim, 0, b).add_(d_first)
        dx.narrow(dim, n - a, a).add_(d_last)
        if ctx.edge == "edge":
            idx, S = group_rank(ctx.group)
            if idx == 0 and a:
                dx.narrow(dim, 0, 1).add_(g_top.sum(dim, keepdim=True))
            if idx == S - 1 and b:
                dx.narrow(dim, n - 1, 1).add_(g_bottom.sum(dim, keepdim=True))
        return dx, None, None, None, None, None


def halo_exchange(x: torch.Tensor, radius: int, group=None, *, below=None, dim: int = 2,
                  edge: str = "zeros"):
    """(top, bottom): the `radius` rows along `dim` above this rank's block
    and the `below` rows (`radius` when None) under it, from its neighbours
    along `group`.  At the group's edges the halo is zeros (the unsharded
    op's zero padding) or, with edge "edge", the block's edge row repeated
    (an op that clamps its index there, as an upsample does).  One
    exchange; differentiable, its backward is the reverse exchange."""
    below = radius if below is None else below
    if edge not in EDGES:
        raise ValueError(f"edge must be one of {EDGES}, got {edge!r}")
    if min(radius, below) < 0 or max(radius, below) > x.shape[dim]:
        raise ValueError(f"halo ({radius}, {below}) rows of a {x.shape[dim]}-row block")
    return _HaloExchange.apply(x, radius, below, dim, edge, group)
