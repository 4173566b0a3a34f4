"""Concatenation cost volume (counterpart of `ganet_tpu/ops/cost_volume.py`).

For each disparity d at 1/3 resolution, the left features are concatenated
with the right features shifted right by d, zero-filled where the shift
falls outside the image:

    cv[b, d, h, w] = concat(left[b, h, w], right[b, h, w - d])
"""

from __future__ import annotations

import torch


def build_cost_volume_ncdhw(
    left: torch.Tensor, right: torch.Tensor, num_disp: int, start: int = 0,
    stop: int | None = None, channels: tuple[int, int] | None = None,
) -> torch.Tensor:
    """left, right (B, C, H, W) -> (B, 2C, D, H, W), the model's layout;
    with `start`/`stop`, only the bins [start, stop) of the whole volume's
    D = num_disp (a rank's block over the mesh's `disp` axis), and with
    `channels` (c0, c1) only those channels of the 2C (a rank's block under
    channel tensor parallelism): each equals that slice of the whole
    volume."""
    if left.ndim != 4 or left.shape != right.shape:
        raise ValueError(f"expected matching (B,C,H,W) features, got {left.shape}")
    stop = num_disp if stop is None else stop
    if not 0 <= start < stop <= num_disp:
        raise ValueError(f"bins [{start}, {stop}) are not a block of {num_disp}")
    B, C, H, W = left.shape
    c0, c1 = (0, 2 * C) if channels is None else channels
    if not 0 <= c0 < c1 <= 2 * C:
        raise ValueError(f"channels [{c0}, {c1}) are not a block of {2 * C}")
    # The left features are channels [0, C), the shifted right ones [C, 2C).
    n_left = max(0, min(c1, C) - c0)
    right = right[:, max(c0, C) - C : max(c1 - C, 0)]
    cv = left.new_zeros((B, c1 - c0, stop - start, H, W))
    cv[:, :n_left] = left[:, c0 : c0 + n_left, None]
    if right.shape[1]:
        for d in range(start, stop):
            if d == 0:
                cv[:, n_left:, 0] = right
            elif d < W:
                cv[:, n_left:, d - start, :, d:] = right[:, :, :, : W - d]
    return cv


def build_cost_volume(
    left: torch.Tensor, right: torch.Tensor, num_disp: int
) -> torch.Tensor:
    """left, right (B, H, W, C) -> (B, D, H, W, 2C), the JAX package's layout."""
    if left.ndim != 4:
        raise ValueError(f"expected (B,H,W,C) features, got {left.shape}")
    cv = build_cost_volume_ncdhw(
        left.permute(0, 3, 1, 2), right.permute(0, 3, 1, 2), num_disp
    )
    return cv.permute(0, 2, 3, 4, 1)
