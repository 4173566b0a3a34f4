"""Training: loss, metrics, optimiser, the train and eval steps, `Trainer`
and the train CLI (counterpart of `ganet_tpu/train/` and the repo's
`train.py`; run the CLI as `python -m ganet_tpu_torch.train`)."""

from ganet_tpu_torch.train.loss import deep_supervision_loss, smooth_l1_loss
from ganet_tpu_torch.train.metrics import disparity_metrics
from ganet_tpu_torch.train.state import TrainState, make_optimizer
from ganet_tpu_torch.train.trainer import (
    Trainer,
    create_train_state,
    make_eval_step,
    make_train_step,
)
from ganet_tpu_torch.train.cli import build_config, main, parse_args

__all__ = [
    "TrainState",
    "Trainer",
    "build_config",
    "create_train_state",
    "deep_supervision_loss",
    "disparity_metrics",
    "make_eval_step",
    "make_optimizer",
    "main",
    "make_train_step",
    "parse_args",
    "smooth_l1_loss",
]
