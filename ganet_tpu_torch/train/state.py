"""Train state: the model (parameters and BatchNorm statistics), Adam and
its learning-rate schedule (counterpart of `ganet_tpu/train/state.py`)."""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Tuple

import torch

from ganet_tpu_torch.config import OptimConfig
from ganet_tpu_torch.models.ganet import GANet


def make_optimizer(
    optim: OptimConfig,
    params: Iterable[torch.nn.Parameter],
    steps_per_epoch: Optional[int] = None,
) -> Tuple[torch.optim.Adam, torch.optim.lr_scheduler.LambdaLR]:
    """Adam (betas from `optim`, eps 1e-8 outside the square root, as
    optax's `adam`) and its schedule: lr times `decay_factor` from update
    `decay_epoch * steps_per_epoch` on, counting updates from 0, which is
    `optax.piecewise_constant_schedule` with that boundary.  Call the
    scheduler's `step()` after each optimiser step; `get_last_lr()` then
    gives the lr of the next update."""
    opt = torch.optim.Adam(params, lr=optim.lr, betas=(optim.beta1, optim.beta2), eps=1e-8)
    if optim.decay_epoch is not None and steps_per_epoch:
        boundary = optim.decay_epoch * steps_per_epoch
        factor = optim.decay_factor
        rule = lambda step: factor if step >= boundary else 1.0  # noqa: E731
    else:
        rule = lambda step: 1.0  # noqa: E731
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, rule)


@dataclasses.dataclass
class TrainState:
    """What a train step updates in place: the model's parameters and
    running statistics, the optimiser's moments, the schedule, the step."""

    model: GANet
    optimizer: torch.optim.Adam
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int = 0

    @property
    def lr(self) -> float:
        """The learning rate of the next update, read from the scheduler."""
        return self.scheduler.get_last_lr()[0]
