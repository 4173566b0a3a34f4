"""PFM (Portable Float Map) IO, the SceneFlow ground-truth disparity format:
a copy of `ganet_tpu/data/pfm.py` (numpy only).

Pure numpy; handles both big- and little-endian files and both grayscale
('Pf') and color ('PF') variants.  PFM stores rows bottom-to-top, so the
image is flipped vertically on read/write.
"""

from __future__ import annotations

import re

import numpy as np


def read_pfm(path: str) -> np.ndarray:
    """Read a PFM file -> float32 array (H, W) or (H, W, 3)."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError(f"{path}: not a PFM file (header {header!r})")

        dims = f.readline()
        while dims.startswith(b"#"):  # comments permitted by the spec
            dims = f.readline()
        m = re.match(rb"^\s*(\d+)\s+(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"{path}: malformed PFM dimensions {dims!r}")
        width, height = int(m.group(1)), int(m.group(2))

        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"

        data = np.fromfile(f, endian + "f", width * height * (3 if color else 1))
    shape = (height, width, 3) if color else (height, width)
    if data.size != np.prod(shape):
        raise ValueError(f"{path}: truncated PFM payload")
    return np.flipud(data.reshape(shape)).astype(np.float32)


def write_pfm(path: str, image: np.ndarray, scale: float = 1.0) -> None:
    """Write a float32 array (H, W) or (H, W, 3) as little-endian PFM."""
    image = np.asarray(image, dtype=np.float32)
    if image.ndim == 2:
        header = b"Pf"
    elif image.ndim == 3 and image.shape[2] == 3:
        header = b"PF"
    else:
        raise ValueError(f"unsupported PFM shape {image.shape}")
    with open(path, "wb") as f:
        f.write(header + b"\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        f.write(f"{-abs(scale)}\n".encode())  # negative = little-endian
        np.flipud(image).astype("<f").tofile(f)
