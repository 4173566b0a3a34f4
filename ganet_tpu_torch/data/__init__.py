"""Data of the port: the procedural stereo dataset."""

from ganet_tpu_torch.data.synthetic import SyntheticStereoDataset, stack

__all__ = ["SyntheticStereoDataset", "stack"]
