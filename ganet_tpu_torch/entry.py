"""Entry points: build a model and predict (counterparts of
`fresh_init_state` and `make_predict_fn` in `ganet_tpu/train/trainer.py`).

Both run on the CUDA device unless the caller asks for the CPU with
`device="cpu"`; with no card and no such request they raise.

With a mesh (`parallel.mesh.inference_mesh`, every rank of the world
calling both), the model is one rank of `make_predict_fn(cfg, mesh)`:
`predict` gives each `data` line its share of the batch (the whole batch,
replicated, when `data` does not divide it, as the JAX package's dispatch
does), the `space` ranks of a line share its rows (`models/ganet.py`), and
the output is joined over `space` along H and then over `data` along B, so
that every rank returns the whole disparity.
"""

from __future__ import annotations

from typing import Mapping, Optional, Union

import numpy as np
import torch

from ganet_tpu_torch.config import ModelConfig
from ganet_tpu_torch.models.ganet import GANet
from ganet_tpu_torch.models.layers import init_weights
from ganet_tpu_torch.ops.sga import SGA_MAX_D
from ganet_tpu_torch.parallel.comm import all_gather_cat

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
    mesh=None,
) -> GANet:
    """An eval-mode GANet with weights from `state_dict` (for example from
    `convert.convert_flax_variables`) or, without one, a seeded init; with
    a `mesh` (`parallel.mesh.Mesh`), this rank's part of the sharded model
    (every rank builds it with the same weights).

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
    model = GANet(cfg, mesh)
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
    With a mesh every rank passes the whole batch and gets the whole output.

    The inputs are copied to one memory layout first: a size-1 dimension may
    carry any stride (a numpy `image[None]` has 0), and cuDNN may pick
    another algorithm for another layout of the same values."""
    dev = next(model.parameters()).device
    mesh = getattr(model, "mesh", None)
    split = mesh is not None and mesh.size("data") > 1 and len(left) % mesh.size("data") == 0
    if split:
        per = len(left) // mesh.size("data")
        rows = slice(mesh.index["data"] * per, (mesh.index["data"] + 1) * per)
        left, right = left[rows], right[rows]
    left = torch.as_tensor(left, dtype=torch.float32, device=dev)
    right = torch.as_tensor(right, dtype=torch.float32, device=dev)
    left = left.clone(memory_format=torch.contiguous_format)
    right = right.clone(memory_format=torch.contiguous_format)
    with torch.inference_mode():
        out = model(left, right)
        if mesh is None:
            return out
        out = all_gather_cat(out, 1, mesh.space_group)
        return all_gather_cat(out, 0, mesh.data_group) if split else out
