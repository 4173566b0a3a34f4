"""Implementation dispatch for SGA, LGA and channel-wise LGA (counterpart of
`ganet_tpu/ops/dispatch.py`).

`impl` is "auto" (the kernel for CUDA tensors, the plain version for CPU
tensors), "torch" (the plain version on any device) or "kernel" (the
kernel wrapper, which runs the plain version only for a CPU tensor and
otherwise launches the kernel or raises).

Every route is differentiable.  "kernel" (and "auto" on CUDA) goes through
the wrappers' autograd Functions where a gradient is wanted, whose
backward launches the gradient kernels (K3 for SGA, K4 for LGA and
`lga3d`); "torch" is autograd through the plain forward.  The forward
kernels are K1 (SGA), K2 (LGA) and K7 (`lga3d`).

Mesh routing, as the JAX package's: given a `space` group of more than one
rank, x is this rank's block of H rows, and SGA runs as the cross-shard
wavefront (`parallel.sharded_sga`: K1 along W, K5 along H) and LGA as the
halo stencil (`parallel.sharded_lga`: K2).  JAX shards LGA only where the
ranks divide H into blocks of at least `radius` rows; here the blocks are
given, and `sharded_lga` raises on a thinner one (the model's shape rule,
`parallel.spatial.check_spatial_shape`, keeps them thick enough).  The
sharded ops take the route by device ("auto" or "kernel": the kernels on
a CUDA tensor, the plain versions on a CPU one); "torch" on a CUDA tensor
has no sharded route and raises.
"""

from __future__ import annotations

import torch

from ganet_tpu_torch.config import IMPLS
from ganet_tpu_torch.ops import lga as _lga
from ganet_tpu_torch.ops import sga as _sga
from ganet_tpu_torch.parallel.sharded_lga import sharded_lga
from ganet_tpu_torch.parallel.sharded_sga import sharded_sga
from ganet_tpu_torch.parallel.spatial import space_size


def resolve_impl(impl: str, x: torch.Tensor) -> str:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; choose from {IMPLS}")
    if impl == "auto":
        return "kernel" if x.is_cuda else "torch"
    return impl


def _sharded(impl: str, x: torch.Tensor, group) -> bool:
    """Whether the op runs sharded over `group`; raises for "torch" on CUDA."""
    if space_size(group) == 1:
        return False
    if x.is_cuda and resolve_impl(impl, x) == "torch":
        raise ValueError("impl 'torch' has no sharded route on a CUDA tensor; the sharded ops"
                         " launch the kernels (impl 'auto' or 'kernel')")
    return True


def sga_ncdhw(x: torch.Tensor, w: torch.Tensor, impl: str = "auto", group=None) -> torch.Tensor:
    """SGA on the model's layout: x (B, C, D, H, W), w (B, C, 4, 5, H, W);
    with a `space` group, this rank's block of H rows."""
    if _sharded(impl, x, group):
        return sharded_sga(x, w, group)
    if resolve_impl(impl, x) == "kernel":
        return _sga.sga_ncdhw(x, w)
    return _sga.sga_reference_ncdhw(x, w)


def sga(x: torch.Tensor, w: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """SGA on the JAX package's layout: x (B, D, H, W, C), w (B, H, W, C, 4, 5)."""
    if w.shape[-2:] != (4, 5):
        raise ValueError(f"weights must end in (4, 5), got {tuple(w.shape)}")
    out = sga_ncdhw(
        x.permute(0, 4, 1, 2, 3).contiguous(),
        w.permute(0, 3, 4, 5, 1, 2).contiguous(),
        impl,
    )
    return out.permute(0, 2, 3, 4, 1)


def lga_nchw(
    x: torch.Tensor,
    g75: torch.Tensor,
    radius: int = 2,
    repeats: int = 1,
    impl: str = "auto",
    group=None,
) -> torch.Tensor:
    """LGA with the guidance as (B, 3*K*K, H, W); with a `space` group,
    this rank's block of H rows."""
    if _sharded(impl, x, group):
        return sharded_lga(x, g75, radius, repeats, group)
    if resolve_impl(impl, x) == "kernel":
        return _lga.lga_nchw(x, g75, radius, repeats)
    return _lga.lga_reference_nchw(x, g75, radius, repeats)


def lga(
    x: torch.Tensor,
    g: torch.Tensor,
    radius: int = 2,
    repeats: int = 1,
    impl: str = "auto",
) -> torch.Tensor:
    """LGA on the JAX package's layout: x (B, D, H, W), g (B, H, W, 3*K*K)."""
    return lga_nchw(x, g.permute(0, 3, 1, 2).contiguous(), radius, repeats, impl)


def lga3d_ncdhw(
    x: torch.Tensor,
    g75: torch.Tensor,
    radius: int = 2,
    repeats: int = 1,
    impl: str = "auto",
) -> torch.Tensor:
    """Channel-wise LGA: x (B, C, D, H, W), guidance (B, 3*K*K, H, W) shared
    by the C channels."""
    if resolve_impl(impl, x) == "kernel":
        return _lga.lga3d_ncdhw(x, g75, radius, repeats)
    return _lga.lga3d_reference_ncdhw(x, g75, radius, repeats)


def lga3d(
    x: torch.Tensor,
    g: torch.Tensor,
    radius: int = 2,
    repeats: int = 1,
    impl: str = "auto",
) -> torch.Tensor:
    """Channel-wise LGA on the JAX package's layout: x (B, D, H, W, C),
    g (B, H, W, 3*K*K) (the reference's Lga3dFunction)."""
    if resolve_impl(impl, x) == "kernel":
        return _lga.lga3d(x, g, radius, repeats)
    return _lga.lga3d_reference(x, g, radius, repeats)
