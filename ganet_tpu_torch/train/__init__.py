"""Training: loss, metrics, optimiser and the train and eval steps
(counterpart of `ganet_tpu/train/`)."""

from ganet_tpu_torch.train.loss import deep_supervision_loss, smooth_l1_loss
from ganet_tpu_torch.train.metrics import disparity_metrics
from ganet_tpu_torch.train.state import TrainState, make_optimizer
from ganet_tpu_torch.train.trainer import create_train_state, make_eval_step, make_train_step

__all__ = [
    "TrainState",
    "create_train_state",
    "deep_supervision_loss",
    "disparity_metrics",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
    "smooth_l1_loss",
]
