"""ganet_tpu_torch: the GANet stereo network in PyTorch, with hand-written
CUDA kernels for SGA and LGA on Hopper (sm_90a).

A port of `ganet_tpu` (JAX), which stays the reference.  This package
imports nothing of JAX or of `ganet_tpu`.

`build_model` and `predict` live in `ganet_tpu_torch.entry`; the name
`ganet_tpu_torch.predict` is the inference CLI's module
(`python -m ganet_tpu_torch.predict`), so the package exports no function
of that name.
"""

from ganet_tpu_torch.config import ModelConfig, ganet11, ganet_deep, ganet_small, model_config
from ganet_tpu_torch.entry import build_model

__all__ = [
    "ModelConfig",
    "build_model",
    "ganet11",
    "ganet_deep",
    "ganet_small",
    "model_config",
]
