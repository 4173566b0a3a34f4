"""Weight normalisation (counterpart of `ganet_tpu/ops/normalize.py`), and
the precision that sums and normalisations run at.

The eps is 1e-8 as in the JAX package; `torch.nn.functional.normalize`
uses 1e-12, so it is not used here.
"""

from __future__ import annotations

import torch


def at_least_f32(t: torch.Tensor) -> torch.Tensor:
    """`t` in float32, or in float64 when it is float64: the precision of
    the port's reductions, normalisations and carries."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def l1_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    """Scale so that sum(|x|) == 1 along `dim`, preserving signs."""
    denom = x.abs().sum(dim=dim, keepdim=True)
    return x / torch.clamp_min(denom, eps)


def normalize_weights(x: torch.Tensor, method: str = "l1", dim: int = -1) -> torch.Tensor:
    """Normalise guidance weight sets to unit mass along `dim`: "l1"
    (signed, sum |w| = 1) or "softmax" (positive, sum w = 1)."""
    if method == "l1":
        return l1_normalize(x, dim=dim)
    if method == "softmax":
        return torch.softmax(x, dim=dim)
    raise ValueError(f"unknown weight normalization {method!r}")
