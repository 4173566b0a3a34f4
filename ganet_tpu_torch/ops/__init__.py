"""Operators of the port: plain PyTorch versions, and the wrappers of the
hand-written CUDA kernels for SGA, LGA and channel-wise LGA."""

from ganet_tpu_torch.ops.cost_volume import build_cost_volume
from ganet_tpu_torch.ops.disparity import disparity_regression, soft_argmin, trilinear_upsample
from ganet_tpu_torch.ops.lga import lga3d_reference, lga_reference
from ganet_tpu_torch.ops.normalize import l1_normalize, normalize_weights
from ganet_tpu_torch.ops.sga import sga_reference, sga_sweep_reference

__all__ = [
    "build_cost_volume",
    "disparity_regression",
    "l1_normalize",
    "lga3d_reference",
    "lga_reference",
    "normalize_weights",
    "sga_reference",
    "sga_sweep_reference",
    "soft_argmin",
    "trilinear_upsample",
]
