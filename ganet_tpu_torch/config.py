"""Configuration of the PyTorch port.

A copy of `ganet_tpu/config.py` (the port imports nothing of the JAX
package).  Field names, defaults and presets match the JAX package, so a
configuration means the same network and training run in both.  The
model's `sga_impl` becomes `impl`:

  * "auto":   the CUDA kernels for tensors on a CUDA device, the plain
              PyTorch versions for tensors on the CPU;
  * "torch":  the plain PyTorch versions on any device;
  * "kernel": the CUDA kernels (on a CPU tensor a kernel wrapper runs its
              plain version, since a CUDA kernel cannot run there).

`ModelConfig.remat` (rematerialisation) is ported, with
`torch.utils.checkpoint`; `channel_tp` (channel tensor parallelism) is
not.  `TrainConfig.mesh` is kept; the port's trainer runs on one device
and refuses a larger mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

IMPLS = ("auto", "torch", "kernel")
REMATS = ("none", "sga", "full")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture preset (see `ganet_tpu.config.ModelConfig`)."""

    name: str = "GANet_deep"
    max_disp: int = 192
    feature_channels: int = 32
    agg_channels: int = 32
    feature_cycles: int = 2
    agg_cycles: int = 2
    feature_levels: int = 4
    agg_levels: int = 3
    num_sga_full: int = 3
    num_sga_half: int = 4
    lga_radius: int = 2
    num_outputs: int = 3
    # Dtype of the conv stacks, BatchNorm and SGA volumes ("float32" or
    # "bfloat16"); parameters stay float32.
    compute_dtype: str = "float32"
    # Dtype of the full-resolution head volumes; "" follows compute_dtype.
    head_dtype: str = ""
    impl: str = "auto"
    sga_norm: str = "l1"
    lga_repeats: int = 2
    # Rematerialisation in the train-mode forward with gradients:
    #   "none"  keep every activation autograd saves;
    #   "sga"   recompute the SGA blocks and the disparity heads in backward;
    #   "full"  also recompute the hourglass's 3D-conv stages.
    remat: str = "none"

    def __post_init__(self):
        if self.impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {self.impl!r}")
        if self.remat not in REMATS:
            raise ValueError(f"unknown remat policy {self.remat!r}; choose from {REMATS}")

    @property
    def resolved_head_dtype(self) -> str:
        return self.head_dtype or self.compute_dtype

    @property
    def disp_channels(self) -> int:
        """Disparity bins of the 1/3-resolution cost volume."""
        return self.max_disp // 3

    def validate_image_shape(self, height: int, width: int) -> None:
        if height % 48 != 0 or width % 48 != 0:
            raise ValueError(
                f"height/width must be multiples of 48 (got {height}x{width})"
            )
        if self.max_disp % 12 != 0:
            raise ValueError("max_disp must be divisible by 12")


def ganet_deep(max_disp: int = 192, **kw) -> ModelConfig:
    return ModelConfig(name="GANet_deep", max_disp=max_disp, **kw)


def ganet11(max_disp: int = 192, **kw) -> ModelConfig:
    return ModelConfig(
        name="GANet11",
        max_disp=max_disp,
        feature_cycles=1,
        agg_cycles=1,
        num_sga_full=2,
        num_sga_half=1,
        num_outputs=2,
        **kw,
    )


def ganet_small(max_disp: int = 48, **kw) -> ModelConfig:
    """Tiny CPU-runnable preset used by the tests."""
    return ModelConfig(
        name="GANet_small",
        max_disp=max_disp,
        feature_channels=8,
        agg_channels=8,
        feature_cycles=1,
        agg_cycles=1,
        feature_levels=2,
        agg_levels=1,
        num_sga_full=2,
        num_sga_half=1,
        num_outputs=2,
        **kw,
    )


MODEL_PRESETS = {
    "GANet_deep": ganet_deep,
    "GANet11": ganet11,
    "GANet_small": ganet_small,
}


def model_config(name: str, max_disp: int = 192, **kw) -> ModelConfig:
    if name not in MODEL_PRESETS:
        raise KeyError(f"unknown model {name!r}; choose from {sorted(MODEL_PRESETS)}")
    return MODEL_PRESETS[name](max_disp=max_disp, **kw)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Data source and crop (see `ganet_tpu.config.DataConfig`)."""

    data_path: str = ""
    training_list: str = "lists/sceneflow_train.list"
    val_list: str = "lists/sceneflow_test_select.list"
    crop_height: int = 240
    crop_width: int = 528
    # "sceneflow" | "kitti2012" | "kitti2015" | "synthetic".
    kind: str = "sceneflow"
    left_right: bool = False  # also supervise the right view (mirror trick)
    shuffle: bool = True
    num_prefetch: int = 2
    # Synthetic only: thin the valid mask to about this fraction (0 = dense).
    sparse_frac: float = 0.0


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    """Adam with an optional step decay (see `ganet_tpu.config.OptimConfig`)."""

    lr: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    # Multiply lr by `decay_factor` from epoch `decay_epoch` on.
    decay_epoch: Optional[int] = None
    decay_factor: float = 0.1


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh: data (batch), space (H of the cost volume), disp."""

    data: int = 1
    space: int = 1
    disp: int = 1

    @property
    def num_devices(self) -> int:
        return self.data * self.space * self.disp


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig = dataclasses.field(default_factory=ganet_deep)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    batch_size: int = 8
    num_epochs: int = 10
    steps_per_epoch: Optional[int] = None  # None = full dataset
    save_path: str = "./checkpoint/"
    resume: str = ""
    seed: int = 0
    # Deep-supervision weights over (disp0, disp1, disp2).
    loss_weights: Tuple[float, ...] = (0.2, 0.6, 1.0)
    log_every: int = 10
    keep_checkpoints: int = 5
