"""Train and eval steps and the `Trainer` (counterpart of
`make_train_step`, `make_eval_step`, `create_train_state` and `Trainer` in
`ganet_tpu/train/`).

A train step runs the model in train mode on one device: the forward with
deep supervision, the smooth-L1 loss over every head, the backward (SGA
and LGA gradients through the hand-written kernels on a CUDA device), one
Adam update and the BatchNorm running statistics.  With
`cfg.data.left_right` the right view is supervised too, by the mirror
trick of the JAX trainer: the pair (flip(right), flip(left)) predicts the
flipped right-view disparity, and both pairs run in one forward stacked
along the batch, so BatchNorm statistics cover both.

`Trainer` trains from a `TrainConfig`: its datasets (files or synthetic)
through `BatchIterator`, the epoch loop with JSONL rows (`MetricLogger`),
a checkpoint after each epoch (`train/checkpoint.py`, keyed by the epoch),
resume, and evaluation over the test set with a best-EPE checkpoint.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Mapping, Optional, Union

import numpy as np
import torch

from ganet_tpu_torch.config import TrainConfig
from ganet_tpu_torch.data.dataset import get_test_set, get_training_set
from ganet_tpu_torch.data.pipeline import BatchIterator, process_coordinates
from ganet_tpu_torch.entry import Device, build_model, resolve_device
from ganet_tpu_torch.train.checkpoint import latest_step, load_train_state, save_checkpoint
from ganet_tpu_torch.train.loss import deep_supervision_loss
from ganet_tpu_torch.train.metrics import disparity_metrics
from ganet_tpu_torch.train.state import TrainState, make_optimizer
from ganet_tpu_torch.utils.logging import MetricLogger

BATCH_KEYS = ("left", "right", "disparity", "valid")

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


class Trainer:
    """The training run of a `TrainConfig` on one device (the CUDA device
    unless `device` names another), with the JAX `Trainer`'s methods and
    their semantics.

    A `save_path` that already holds a checkpoint, or `cfg.resume`, restores
    the newest one: `start_epoch` becomes its epoch + 1 and nothing else is
    reset.  As in the JAX package, the batch iterator and the training set
    start afresh, so a resumed run's first epoch sees epoch 0's permutation
    and crops again, where an uninterrupted run would see epoch 1's.
    """

    def __init__(self, cfg: TrainConfig, device: Device = None):
        self.cfg = cfg
        if cfg.mesh.num_devices > 1:
            raise NotImplementedError(
                f"the port trains on one device; mesh {cfg.mesh} needs {cfg.mesh.num_devices}"
            )
        self.device = resolve_device(device)
        self.logger = MetricLogger(cfg.save_path)
        self.train_ds = get_training_set(cfg.data, cfg.model.max_disp)
        self.train_iter = BatchIterator(
            self.train_ds,
            cfg.batch_size,
            shuffle=cfg.data.shuffle,
            seed=cfg.seed,
            prefetch=cfg.data.num_prefetch,
        )
        self.steps_per_epoch = cfg.steps_per_epoch or len(self.train_iter)
        self.state = create_train_state(cfg, self.device, self.steps_per_epoch)
        self.train_keys = BATCH_KEYS + (
            ("disparity_right", "valid_right") if cfg.data.left_right else ()
        )
        self.train_step = make_train_step(cfg)
        self.eval_step = make_eval_step(cfg)
        self.ckpt_dir = os.path.abspath(cfg.save_path)
        self.start_epoch = 0
        if cfg.resume:
            self.restore(cfg.resume)
        elif latest_step(self.ckpt_dir) is not None:
            self.restore()

    # -- checkpointing ----------------------------------------------------
    def _save(self, root: str, key: int, keep: int, **extra) -> None:
        state = self.state
        extra["train_step"] = state.step
        save_checkpoint(root, key, state.model, state.optimizer, state.scheduler, extra, keep)

    def save(self, epoch: int) -> None:
        """The checkpoint of `epoch` under `save_path`, keyed by the epoch;
        the newest `cfg.keep_checkpoints` are kept."""
        self._save(self.ckpt_dir, epoch, self.cfg.keep_checkpoints, epoch=epoch)

    def save_best(self, epe: float) -> bool:
        """Keep a best-EPE checkpoint (`best/`, keyed by the step, keep-1) and
        `best_epe.json` {"epe", "step"}; True when `epe` improves on the
        stored best."""
        marker = os.path.join(self.ckpt_dir, "best_epe.json")
        best = float("inf")
        if os.path.exists(marker):
            with open(marker) as f:
                best = json.load(f).get("epe", float("inf"))
        if epe >= best:
            return False
        step = self.state.step
        self._save(os.path.join(self.ckpt_dir, "best"), step, keep=1)
        with open(marker, "w") as f:
            json.dump({"epe": epe, "step": step}, f)
        return True

    def restore(self, path_or_latest: Optional[str] = None) -> None:
        """Restore the newest checkpoint under `save_path` (or under the
        directory given, as the reference's --resume); `start_epoch` becomes
        its epoch + 1."""
        root = os.path.abspath(path_or_latest) if path_or_latest else self.ckpt_dir
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoint found under {root}")
        load_train_state(root, step, self.state)
        self.start_epoch = step + 1

    def close(self) -> None:
        """Close the metric log.  Saves are synchronous: nothing is in flight."""
        self.logger.close()

    # -- loops ------------------------------------------------------------
    def fit(self) -> TrainState:
        """Train from `start_epoch` to `cfg.num_epochs`, at most
        `cfg.steps_per_epoch` steps an epoch, logging a row at each epoch's
        first step and every `cfg.log_every` steps (the only places that
        wait for the device), and saving after each epoch."""
        cfg = self.cfg
        step = self.state.step
        for epoch in range(self.start_epoch, cfg.num_epochs):
            it = iter(self.train_iter)
            try:
                for i, batch in enumerate(it):
                    if cfg.steps_per_epoch and i >= cfg.steps_per_epoch:
                        break
                    metrics = self.train_step(self.state, {k: batch[k] for k in self.train_keys})
                    step += 1
                    if step % cfg.log_every == 0 or i == 0:
                        # "lr" is the learning rate of the update just made.
                        self.logger.log(step, metrics, prefix=f"epoch{epoch}")
            finally:
                # Close the generator, so that its prefetch thread is reaped
                # even after a break.
                it.close()
            self.save(epoch)
        return self.state

    def evaluate(self, max_batches: Optional[int] = None) -> Dict[str, float]:
        """Metrics over the test set (batch 1 on one device), pixel-weighted
        by each batch's valid pixels; logged under "val", and the EPE is
        offered to `save_best`."""
        cfg = self.cfg
        test_ds = get_test_set(cfg.data, cfg.model.max_disp)
        eval_batch = max(cfg.mesh.data, process_coordinates()[1])
        it = BatchIterator(
            test_ds,
            eval_batch,
            shuffle=False,
            drop_remainder=False,
            # Short and synchronous: more than one batch ahead buys nothing.
            prefetch=min(1, cfg.data.num_prefetch),
        )
        # Each batch's masked means are scaled back up by its valid-pixel
        # count, so that sparse batches and the zero-valid padded tail carry
        # their share instead of one vote a batch.
        totals: Dict[str, float] = {}
        weight = 0.0
        n = 0
        gen = iter(it)
        try:
            for i, batch in enumerate(gen):
                if max_batches and i >= max_batches:
                    break
                m = {k: float(v) for k, v in self.eval_step(self.state, batch).items()}
                w = m.pop("valid_px")
                for k, v in m.items():
                    totals[k] = totals.get(k, 0.0) + v * w
                weight += w
                n += 1
        finally:
            gen.close()
        result = {k: v / max(weight, 1.0) for k, v in totals.items()}
        result["valid_px"] = weight
        self.logger.log(n, result, prefix="val")
        if "epe" in result:
            self.save_best(float(result["epe"]))
        return result
