"""Sample-list parsing and path derivation: a copy of
`ganet_tpu/data/lists.py`.

A .list file contains one
relative left-image path per line; right-image and disparity paths are
derived per dataset flavor:

  sceneflow:  left  = <data_path>/<line>              (frames_finalpass/.../left/NNNN.png)
              right = left with '/left/'  -> '/right/'
              disp  = left with 'frames_finalpass' -> 'disparity',
                      '.png' -> '.pfm'
  kitti2015:  left  = <data_path>/image_2/<line>
              right = <data_path>/image_3/<line>
              disp  = <data_path>/disp_occ_0/<line>
  kitti2012:  left  = <data_path>/colored_0/<line>
              right = <data_path>/colored_1/<line>
              disp  = <data_path>/disp_occ/<line>
"""

from __future__ import annotations

import dataclasses
import os
from typing import List


@dataclasses.dataclass(frozen=True)
class SamplePaths:
    left: str
    right: str
    disparity: str
    # Right-view ground truth (--left_right; SceneFlow only: KITTI
    # publishes no right-view disparity).  Empty when unavailable.
    disparity_right: str = ""


def read_list(path: str) -> List[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip() and not ln.startswith("#")]


def derive_paths(data_path: str, line: str, kind: str) -> SamplePaths:
    if kind == "sceneflow":
        left = os.path.join(data_path, line)
        if "/left/" not in left:
            raise ValueError(f"sceneflow list entry missing '/left/': {line}")
        right = left.replace("/left/", "/right/")
        disp = left.replace("frames_finalpass", "disparity").replace(
            "frames_cleanpass", "disparity"
        )
        disp = os.path.splitext(disp)[0] + ".pfm"
        disp_right = disp.replace("/left/", "/right/")
        return SamplePaths(left, right, disp, disp_right)
    if kind == "kitti2015":
        return SamplePaths(
            os.path.join(data_path, "image_2", line),
            os.path.join(data_path, "image_3", line),
            os.path.join(data_path, "disp_occ_0", line),
        )
    if kind == "kitti2012":
        return SamplePaths(
            os.path.join(data_path, "colored_0", line),
            os.path.join(data_path, "colored_1", line),
            os.path.join(data_path, "disp_occ", line),
        )
    raise ValueError(f"unknown dataset kind {kind!r}")
