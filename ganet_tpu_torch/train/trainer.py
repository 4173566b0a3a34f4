"""Train and eval steps (counterpart of `make_train_step`,
`make_eval_step` and `create_train_state` in `ganet_tpu/train/`).

A train step runs the model in train mode on one device: the forward with
deep supervision, the smooth-L1 loss over every head, the backward (SGA
and LGA gradients through the hand-written kernels on a CUDA device), one
Adam update and the BatchNorm running statistics.  With
`cfg.data.left_right` the right view is supervised too, by the mirror
trick of the JAX trainer: the pair (flip(right), flip(left)) predicts the
flipped right-view disparity, and both pairs run in one forward stacked
along the batch, so BatchNorm statistics cover both.

Checkpoints, the epoch loop and evaluation over a dataset come later.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Union

import numpy as np
import torch

from ganet_tpu_torch.config import TrainConfig
from ganet_tpu_torch.entry import Device, build_model
from ganet_tpu_torch.train.loss import deep_supervision_loss
from ganet_tpu_torch.train.metrics import disparity_metrics
from ganet_tpu_torch.train.state import TrainState, make_optimizer

Batch = Mapping[str, Union[np.ndarray, torch.Tensor]]


def create_train_state(
    cfg: TrainConfig, device: Device = None, steps_per_epoch: Optional[int] = None
) -> TrainState:
    """A train-mode GANet from a seeded init (`cfg.seed`) on `device` (the
    CUDA device unless given), with Adam and its schedule.
    `steps_per_epoch` (default `cfg.steps_per_epoch`) places the decay."""
    if cfg.mesh.num_devices > 1:
        raise NotImplementedError(
            f"the port trains on one device; mesh {cfg.mesh} needs {cfg.mesh.num_devices}"
        )
    model = build_model(cfg.model, device, seed=cfg.seed).train()
    opt, sched = make_optimizer(
        cfg.optim, model.parameters(), steps_per_epoch or cfg.steps_per_epoch
    )
    return TrainState(model=model, optimizer=opt, scheduler=sched)


def _to_device(batch: Batch, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in batch.items()}


def make_train_step(cfg: TrainConfig) -> Callable[[TrainState, Batch], Dict[str, object]]:
    """`train_step(state, batch)`: one update of `state` in place.

    batch: "left", "right" (B, H, W, 3), "disparity", "valid" (B, H, W),
    and with `cfg.data.left_right` also "disparity_right", "valid_right";
    numpy arrays or tensors.  Returns the loss and the final head's metrics
    as device tensors (no synchronisation), and "lr", the learning rate of
    this update, as a float.
    """
    left_right = cfg.data.left_right

    def train_step(state: TrainState, batch: Batch) -> Dict[str, object]:
        model = state.model
        b = _to_device(batch, next(model.parameters()).device)
        model.train()
        left, right = b["left"], b["right"]
        if left_right:
            nb = left.shape[0]
            left = torch.cat([b["left"], b["right"].flip(2)])
            right = torch.cat([b["right"], b["left"].flip(2)])
        outputs = model(left, right)
        if left_right:
            outs_l = [o[:nb] for o in outputs]
            outs_r = [o[nb:].flip(-1) for o in outputs]
            loss = 0.5 * (
                deep_supervision_loss(outs_l, b["disparity"], b["valid"], cfg.loss_weights)
                + deep_supervision_loss(
                    outs_r, b["disparity_right"], b["valid_right"], cfg.loss_weights
                )
            )
            outputs = outs_l
        else:
            loss = deep_supervision_loss(outputs, b["disparity"], b["valid"], cfg.loss_weights)
        lr = state.lr
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        metrics: Dict[str, object] = {"loss": loss.detach()}
        with torch.no_grad():
            metrics.update(disparity_metrics(outputs[-1], b["disparity"], b["valid"]))
        metrics["lr"] = lr
        return metrics

    return train_step


def make_eval_step(cfg: TrainConfig) -> Callable[[TrainState, Batch], Dict[str, torch.Tensor]]:
    """`eval_step(state, batch)`: the eval-mode forward (running BatchNorm
    statistics, final head only) and its metrics, as device tensors."""

    def eval_step(state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
        model = state.model
        b = _to_device(batch, next(model.parameters()).device)
        model.eval()
        with torch.no_grad():
            disp = model(b["left"], b["right"])
            return disparity_metrics(disp, b["disparity"], b["valid"])

    return eval_step
