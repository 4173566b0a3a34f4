"""Stereo datasets from list files (SceneFlow, KITTI): a copy of
`StereoDataset`, `get_training_set` and `get_test_set` in
`ganet_tpu/data/dataset.py`.  A sample is decoded by the native C++ core
(`data/native_io.py`) where its library builds, as the JAX package's is,
else by the port's numpy PNG and PFM readers (no Pillow); both give the
same bits.

  * training: random crop to (crop_height, crop_width), per-channel
    normalisation; ground-truth disparity cropped identically.  The crop
    offsets come from one seeded numpy generator per dataset, drawn in the
    same order as the JAX package draws them, so the crops are equal;
  * test: pad (top/right) up to the crop size instead of cropping, so
    predictions can be unpadded back to the original frame;
  * valid-pixel mask: 0 < gt < max_disp (KITTI 0 = no ground truth).

A sample is a dict of float32 numpy arrays:
  left, right: (H, W, 3) normalised images
  disparity:   (H, W)
  valid:       (H, W) float mask
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from ganet_tpu_torch.data import pfm, png
from ganet_tpu_torch.data.lists import derive_paths, read_list
from ganet_tpu_torch.data.synthetic import SyntheticStereoDataset

# Per-channel normalisation constants (ImageNet statistics).
MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize_image(img: np.ndarray) -> np.ndarray:
    """uint8-range (H, W, 3) -> normalized float32."""
    return (img.astype(np.float32) / 255.0 - MEAN) / STD


def _random_crop(
    arrays: Tuple[np.ndarray, ...], ch: int, cw: int, rng: np.random.Generator
) -> Tuple[np.ndarray, ...]:
    H, W = arrays[0].shape[:2]
    if H < ch or W < cw:
        # Pad reflect-free (zeros) up to crop size first.
        padded = []
        for a in arrays:
            pad = [(max(ch - H, 0), 0), (0, max(cw - W, 0))] + [(0, 0)] * (a.ndim - 2)
            padded.append(np.pad(a, pad))
        arrays = tuple(padded)
        H, W = arrays[0].shape[:2]
    y = int(rng.integers(0, H - ch + 1))
    x = int(rng.integers(0, W - cw + 1))
    return tuple(a[y : y + ch, x : x + cw] for a in arrays)


def _pad_to(arrays: Tuple[np.ndarray, ...], ch: int, cw: int):
    """Pad on top and right, as the reference's test transform does, so the
    bottom-left origin of the frame is preserved."""
    H, W = arrays[0].shape[:2]
    if H > ch or W > cw:
        raise ValueError(f"image {H}x{W} larger than pad target {ch}x{cw}")
    out = []
    for a in arrays:
        pad = [(ch - H, 0), (0, cw - W)] + [(0, 0)] * (a.ndim - 2)
        out.append(np.pad(a, pad))
    return tuple(out)


@dataclasses.dataclass
class StereoDataset:
    """List-file-backed dataset (SceneFlow / KITTI)."""

    data_path: str
    list_path: str
    crop_height: int
    crop_width: int
    kind: str = "sceneflow"  # sceneflow | kitti2012 | kitti2015
    training: bool = True
    max_disp: int = 192
    seed: int = 0
    # Also return the right-view ground truth as disparity_right /
    # valid_right (--left_right).  SceneFlow only.
    left_right: bool = False
    # Decode in the native C++ core (csrc/ganet_io.cpp) when its library
    # builds; falls back to the Python readers transparently.
    use_native: bool = True

    def __post_init__(self):
        self.entries = read_list(self.list_path)
        self._rng = np.random.default_rng(self.seed)
        self._size_cache = {}
        if self.left_right and self.kind != "sceneflow":
            raise ValueError(
                "left_right requires right-view ground truth, which only"
                " SceneFlow provides (KITTI publishes left-view GT only)"
            )

    def _native_item(self, index: int, paths):
        """The sample from the native core, or None where the Python path
        reads it: no library, or a training frame smaller than the crop
        (padded, then cropped, in Python; no crop drawn here).  The crop's
        y then x come from `self._rng`, as in `_random_crop`."""
        from ganet_tpu_torch.data import native_io

        if not native_io.native_available():
            return None
        size = self._size_cache.get(index)
        if size is None:
            size = self._size_cache[index] = png.png_size(paths.left)
        H, W = size
        if self.training:
            if H < self.crop_height or W < self.crop_width:
                return None
            y = int(self._rng.integers(0, H - self.crop_height + 1))
            x = int(self._rng.integers(0, W - self.crop_width + 1))
        else:
            if H > self.crop_height or W > self.crop_width:
                raise ValueError(
                    f"image {H}x{W} larger than pad target {self.crop_height}x{self.crop_width}"
                )
            y = x = -1  # pad mode
        sample = native_io.decode_sample(
            paths.left,
            paths.right,
            paths.disparity,
            disp_is_pfm=(self.kind == "sceneflow"),
            crop_h=self.crop_height,
            crop_w=self.crop_width,
            crop_y=y,
            crop_x=x,
        )
        disp = sample["disparity"]
        sample["valid"] = ((disp > 0) & (disp < self.max_disp)).astype(np.float32)
        return sample

    def __len__(self) -> int:
        return len(self.entries)

    def original_size(self, index: int) -> Tuple[int, int]:
        """(H, W) of the left image, from its PNG header."""
        paths = derive_paths(self.data_path, self.entries[index], self.kind)
        return png.png_size(paths.left)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        paths = derive_paths(self.data_path, self.entries[index], self.kind)
        if self.use_native and not self.left_right:
            try:
                sample = self._native_item(index, paths)
            except IOError:
                sample = None  # a file the core cannot read: the Python path
            if sample is not None:
                return sample
        left = png.read_image(paths.left)
        right = png.read_image(paths.right)

        def read_disp(path):
            if self.kind == "sceneflow":
                d = pfm.read_pfm(path)
                if d.ndim == 3:
                    d = d[..., 0]
                return np.abs(d)  # SceneFlow signs disparity by view
            return png.read_disparity_png(path)

        disp = read_disp(paths.disparity)
        arrays = [normalize_image(left), normalize_image(right), disp]
        if self.left_right:
            arrays.append(read_disp(paths.disparity_right))
        if self.training:
            arrays = _random_crop(tuple(arrays), self.crop_height, self.crop_width, self._rng)
        else:
            arrays = _pad_to(tuple(arrays), self.crop_height, self.crop_width)
        left, right, disp = arrays[:3]
        valid = ((disp > 0) & (disp < self.max_disp)).astype(np.float32)
        sample = {
            "left": left.astype(np.float32),
            "right": right.astype(np.float32),
            "disparity": disp.astype(np.float32),
            "valid": valid,
        }
        if self.left_right:
            disp_r = arrays[3]
            sample["disparity_right"] = disp_r.astype(np.float32)
            sample["valid_right"] = ((disp_r > 0) & (disp_r < self.max_disp)).astype(np.float32)
        return sample


def get_training_set(cfg_data, max_disp: int):
    """The training set of a `DataConfig`: random crops (or synthetic pairs)."""
    if cfg_data.kind == "synthetic":
        return SyntheticStereoDataset(
            crop_height=cfg_data.crop_height,
            crop_width=cfg_data.crop_width,
            max_disp=max_disp,
            training=True,
            left_right=cfg_data.left_right,
            sparse_frac=cfg_data.sparse_frac,
        )
    return StereoDataset(
        data_path=cfg_data.data_path,
        list_path=cfg_data.training_list,
        crop_height=cfg_data.crop_height,
        crop_width=cfg_data.crop_width,
        kind=cfg_data.kind,
        training=True,
        max_disp=max_disp,
        left_right=cfg_data.left_right,
    )


def get_test_set(cfg_data, max_disp: int):
    """The test set of a `DataConfig`: frames padded to the crop (or
    synthetic pairs)."""
    if cfg_data.kind == "synthetic":
        return SyntheticStereoDataset(
            crop_height=cfg_data.crop_height,
            crop_width=cfg_data.crop_width,
            max_disp=max_disp,
            length=16,
            training=False,
            sparse_frac=cfg_data.sparse_frac,
        )
    return StereoDataset(
        data_path=cfg_data.data_path,
        list_path=cfg_data.val_list,
        crop_height=cfg_data.crop_height,
        crop_width=cfg_data.crop_width,
        kind=cfg_data.kind,
        training=False,
        max_disp=max_disp,
    )
