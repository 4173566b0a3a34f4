"""Implementation dispatch for SGA, LGA and channel-wise LGA (counterpart of
`ganet_tpu/ops/dispatch.py`, without the mesh routing).

`impl` is "auto" (the kernel for CUDA tensors, the plain version for CPU
tensors), "torch" (the plain version on any device) or "kernel" (the
kernel wrapper, which runs the plain version only for a CPU tensor and
otherwise launches the kernel or raises).

Every route is differentiable.  "kernel" (and "auto" on CUDA) goes through
the wrappers' autograd Functions where a gradient is wanted, whose
backward launches the gradient kernels (K3 for SGA, K4 for LGA and
`lga3d`); "torch" is autograd through the plain forward.  The forward
kernels are K1 (SGA), K2 (LGA) and K7 (`lga3d`).
"""

from __future__ import annotations

import torch

from ganet_tpu_torch.config import IMPLS
from ganet_tpu_torch.ops import lga as _lga
from ganet_tpu_torch.ops import sga as _sga


def resolve_impl(impl: str, x: torch.Tensor) -> str:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; choose from {IMPLS}")
    if impl == "auto":
        return "kernel" if x.is_cuda else "torch"
    return impl


def sga_ncdhw(x: torch.Tensor, w: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """SGA on the model's layout: x (B, C, D, H, W), w (B, C, 4, 5, H, W)."""
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
) -> torch.Tensor:
    """LGA with the guidance as (B, 3*K*K, H, W)."""
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
