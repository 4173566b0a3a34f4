"""Data of the port: the procedural stereo dataset, the SceneFlow and KITTI
datasets from list files, and their PNG and PFM readers (counterpart of
`ganet_tpu/data/`)."""

from ganet_tpu_torch.data.dataset import StereoDataset, get_test_set, get_training_set
from ganet_tpu_torch.data.pfm import read_pfm, write_pfm
from ganet_tpu_torch.data.png import read_disparity_png, read_image, write_disparity_png
from ganet_tpu_torch.data.synthetic import SyntheticStereoDataset, stack

__all__ = [
    "StereoDataset",
    "SyntheticStereoDataset",
    "get_test_set",
    "get_training_set",
    "read_disparity_png",
    "read_image",
    "read_pfm",
    "stack",
    "write_disparity_png",
    "write_pfm",
]
