"""Procedural stereo pairs with exact ground truth: a copy of
`SyntheticStereoDataset` in `ganet_tpu/data/dataset.py` (numpy only), which
makes the same samples bit for bit from the same seed.  `stack` gathers
samples into a batch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np


@dataclasses.dataclass
class SyntheticStereoDataset:
    """Procedural stereo pairs with exact ground truth.

    Each scene: a background plane plus `num_layers` rectangular layers at
    increasing disparities; right view is generated by shifting each layer
    left by its disparity (right[w] = left[w + d]).  Occluded background is
    filled with the nearest layer; ground truth is the left-view disparity.
    """

    crop_height: int = 48
    crop_width: int = 96
    max_disp: int = 24
    length: int = 64
    num_layers: int = 3
    seed: int = 0
    training: bool = True
    left_right: bool = False  # also emit right-view GT
    # KITTI-LiDAR-like sparse supervision (reference --kitti2015 fine-tune,
    # SURVEY.md §3.5: KITTI GT covers ~30% of pixels, none in the upper
    # frame where LiDAR has no returns).  0 = dense GT; >0 thins the valid
    # mask to ≈ this fraction with a scanline-band pattern.
    sparse_frac: float = 0.0

    def __len__(self) -> int:
        return self.length

    def _lidar_mask(self, rng, H: int, W: int) -> "np.ndarray":
        """KITTI-like sparse-GT mask at ≈ sparse_frac coverage: the top
        ~30% of the frame has no returns, the rest is scanline bands
        (every other row) with per-pixel dropout."""
        top = int(H * 0.3)
        band = np.zeros((H, W), np.float32)
        band[top::2] = 1.0  # scanline rows
        band_frac = band.mean()
        p = min(1.0, self.sparse_frac / max(band_frac, 1e-6))
        return band * (rng.random((H, W)) < p).astype(np.float32)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed * 100003 + index)
        H, W = self.crop_height, self.crop_width
        Dmax = int(self.max_disp * 0.8)
        pad = self.max_disp  # extra width so shifts stay textured

        def texture():
            # Smooth random texture: low-res noise upsampled (keeps local
            # matching unambiguous but non-trivial).
            base = rng.standard_normal((H // 4 + 2, (W + pad) // 4 + 2, 3))
            t = np.kron(base, np.ones((4, 4, 1)))[: H, : W + pad]
            t = t + 0.05 * rng.standard_normal((H, W + pad, 3))
            return t.astype(np.float32)

        wide_left = texture()
        disp_wide = np.full((H, W + pad), float(rng.integers(1, max(2, Dmax // 4))), np.float32)
        for _ in range(self.num_layers):
            d = float(rng.integers(1, max(2, Dmax)))
            y0 = int(rng.integers(0, H // 2))
            x0 = int(rng.integers(0, (W + pad) // 2))
            h = int(rng.integers(H // 4, H // 2 + 1))
            w = int(rng.integers(W // 4, W // 2 + 1))
            patch_tex = texture()
            region = (slice(y0, min(y0 + h, H)), slice(x0, min(x0 + w, W + pad)))
            # nearer layers (larger d) overwrite
            mask = disp_wide[region] < d
            disp_wide[region][mask] = d
            wide_left[region][mask] = patch_tex[region][mask]

        # Right view: sample left at w + d (per-pixel disparity of the left
        # view; fine for fronto-parallel layers).
        xs = np.arange(W)
        right = np.empty((H, W, 3), np.float32)
        for y in range(H):
            src = np.clip(xs + disp_wide[y, :W].astype(np.int32), 0, W + pad - 1)
            right[y] = wide_left[y, src]
        left = wide_left[:, :W]
        disp = disp_wide[:, :W]
        valid = ((disp > 0) & (disp < self.max_disp)).astype(np.float32)
        if self.sparse_frac > 0.0:
            valid = valid * self._lidar_mask(rng, H, W)
        sample = {
            "left": left,
            "right": right,
            "disparity": disp,
            "valid": valid,
        }
        if self.left_right:
            # Right-view GT sampled with the same warp as the right image
            # (exact for these fronto-parallel layers).
            disp_r = np.empty((H, W), np.float32)
            for y in range(H):
                src = np.clip(
                    xs + disp_wide[y, :W].astype(np.int32), 0, W + pad - 1
                )
                disp_r[y] = disp_wide[y, src]
            sample["disparity_right"] = disp_r
            valid_r = ((disp_r > 0) & (disp_r < self.max_disp)).astype(
                np.float32
            )
            if self.sparse_frac > 0.0:
                valid_r = valid_r * self._lidar_mask(rng, H, W)
            sample["valid_right"] = valid_r
        return sample


def stack(dataset: SyntheticStereoDataset, indices: Sequence[int]) -> Dict[str, np.ndarray]:
    """The samples at `indices`, stacked along a leading batch axis."""
    samples = [dataset[i] for i in indices]
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}
