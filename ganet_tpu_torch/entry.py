"""Entry points: build a model and predict (counterparts of
`fresh_init_state` and `make_predict_fn` in `ganet_tpu/train/trainer.py`).

Both run on the CUDA device unless the caller asks for the CPU with
`device="cpu"`; with no card and no such request they raise.
"""

from __future__ import annotations

from typing import Mapping, Optional, Union

import numpy as np
import torch

from ganet_tpu_torch.config import ModelConfig
from ganet_tpu_torch.models.ganet import GANet
from ganet_tpu_torch.models.layers import init_weights
from ganet_tpu_torch.ops.sga import SGA_MAX_D

Device = Union[str, torch.device, None]


def resolve_device(device: Device = None) -> torch.device:
    """`device` as given, else the CUDA device; raises when there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU; pass device='cpu' to"
            " run it on the CPU"
        )
    return torch.device("cuda")


def build_model(
    cfg: ModelConfig,
    device: Device = None,
    seed: int = 0,
    state_dict: Optional[Mapping[str, torch.Tensor]] = None,
) -> GANet:
    """An eval-mode GANet with weights from `state_dict` (for example from
    `convert.convert_flax_variables`) or, without one, a seeded init.

    On a CUDA device the SGA kernels take D <= `SGA_MAX_D` bins, and the
    model's SGA volume has D = max_disp / 3: a larger max_disp raises here,
    before the model is built, unless `cfg.impl` is "torch"."""
    dev = resolve_device(device)
    if dev.type == "cuda" and cfg.impl != "torch" and cfg.disp_channels > SGA_MAX_D:
        raise ValueError(
            f"max_disp {cfg.max_disp} gives an SGA volume of D = {cfg.disp_channels} bins; the"
            f" SGA kernels take D <= {SGA_MAX_D}, so max_disp <= {3 * SGA_MAX_D} on a CUDA device"
            " (impl='torch' runs the plain versions without this limit)"
        )
    model = GANet(cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model.to(dev).eval()


def predict(
    model: GANet,
    left: Union[torch.Tensor, np.ndarray],
    right: Union[torch.Tensor, np.ndarray],
) -> torch.Tensor:
    """(B, H, W, 3) pair -> (B, H, W) float32 disparity, on the model's device.

    The inputs are copied to one memory layout first: a size-1 dimension may
    carry any stride (a numpy `image[None]` has 0), and cuDNN may pick
    another algorithm for another layout of the same values."""
    dev = next(model.parameters()).device
    left = torch.as_tensor(left, dtype=torch.float32, device=dev)
    right = torch.as_tensor(right, dtype=torch.float32, device=dev)
    left = left.clone(memory_format=torch.contiguous_format)
    right = right.clone(memory_format=torch.contiguous_format)
    with torch.inference_mode():
        return model(left, right)
