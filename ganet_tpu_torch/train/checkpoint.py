"""Checkpoints of the port (counterpart of the orbax checkpoints of
`ganet_tpu/train/trainer.py`).

A checkpoint is a directory `<save_path>/<step>/` holding

  * `model.pt`: `torch.save` of the model's `state_dict` (parameters and
    BatchNorm buffers);
  * `optimizer.pt`: the optimiser's `state_dict`, when one was given;
  * `scheduler.pt`: the learning-rate schedule's `state_dict`, when one was
    given;
  * `meta.json`: the step (the checkpoint's key: `Trainer.save` keys its
    checkpoints by the epoch, as the JAX trainer does), the model
    configuration and any extra fields (`Trainer` stores the epoch and
    `train_step`, the number of updates made).

A save writes into a temporary directory beside the checkpoints and moves
it into place with one `os.replace`, so a save killed part-way leaves the
previous checkpoint as the newest; only the newest `keep` are kept.

The port reads no orbax directory (orbax imports JAX).  A JAX checkpoint is
converted where JAX is installed::

    state = ganet_tpu.train.trainer.load_inference_state(jax_dir)
    sd = convert.convert_flax_variables(jax.device_get(
        {"params": state.params, "batch_stats": state.batch_stats}))
    save_checkpoint(port_dir, 0, build_model(cfg, "cpu", state_dict=sd))
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
from typing import Any, Dict, Mapping, Optional

import torch

from ganet_tpu_torch.config import ModelConfig
from ganet_tpu_torch.models.ganet import GANet
from ganet_tpu_torch.models.layers import init_weights

_MODEL, _OPTIMIZER, _SCHEDULER, _META = "model.pt", "optimizer.pt", "scheduler.pt", "meta.json"


def _steps(root: str) -> list:
    """The steps of the complete checkpoints under `root`, ascending."""
    if not os.path.isdir(root):
        return []
    return sorted(
        int(name) for name in os.listdir(root)
        if name.isdigit() and os.path.exists(os.path.join(root, name, _META))
    )


def latest_step(save_path: str) -> Optional[int]:
    """The newest checkpoint's step under `save_path`, or None."""
    steps = _steps(os.path.abspath(save_path))
    return steps[-1] if steps else None


def save_checkpoint(
    save_path: str,
    step: int,
    model: GANet,
    optimizer: Optional[torch.optim.Optimizer] = None,
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None,
    extra: Optional[Mapping[str, Any]] = None,
    keep: int = 5,
) -> str:
    """Write the checkpoint of `step` under `save_path` (replacing one of the
    same step) and keep the newest `keep`; returns its directory."""
    if keep < 1:
        raise ValueError(f"keep must be at least 1, got {keep}")
    root = os.path.abspath(save_path)
    os.makedirs(root, exist_ok=True)
    meta = {"step": int(step), "model_config": dataclasses.asdict(model.cfg), **(extra or {})}
    tmp = tempfile.mkdtemp(prefix=f".{step}.", dir=root)
    try:
        torch.save(model.state_dict(), os.path.join(tmp, _MODEL))
        if optimizer is not None:
            torch.save(optimizer.state_dict(), os.path.join(tmp, _OPTIMIZER))
        if scheduler is not None:
            torch.save(scheduler.state_dict(), os.path.join(tmp, _SCHEDULER))
        with open(os.path.join(tmp, _META), "w") as f:
            json.dump(meta, f, indent=1)
        final = os.path.join(root, str(int(step)))
        if os.path.exists(final):  # a directory is replaced only when empty
            old = tempfile.mkdtemp(prefix=f".{step}.old.", dir=root)
            os.replace(final, os.path.join(old, "ckpt"))
            shutil.rmtree(old)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    for old_step in _steps(root)[:-keep]:
        shutil.rmtree(os.path.join(root, str(old_step)))
    return final


def _resolve(save_path: str, step: Optional[int]) -> str:
    root = os.path.abspath(save_path)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoint found under {root}")
    path = os.path.join(root, str(int(step)))
    if not os.path.exists(os.path.join(path, _META)):
        raise FileNotFoundError(f"no checkpoint of step {step} under {root}")
    return path


def load_meta(save_path: str, step: Optional[int] = None) -> Dict[str, Any]:
    """The metadata of a checkpoint (the newest without `step`)."""
    with open(os.path.join(_resolve(save_path, step), _META)) as f:
        return json.load(f)


def load_inference_state(save_path: str, step: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """The weights and BatchNorm buffers of a checkpoint (the newest without
    `step`), on the CPU, for `entry.build_model(state_dict=...)`: no
    optimiser state.  Raises FileNotFoundError when there is none."""
    path = os.path.join(_resolve(save_path, step), _MODEL)
    return torch.load(path, map_location="cpu", weights_only=True)


def load_train_state(save_path: str, step: Optional[int], state) -> Dict[str, Any]:
    """Restore a `TrainState` in place from the checkpoint of `step` (the
    newest when None): the model's parameters and BatchNorm buffers, the
    optimiser's moments, the schedule and `state.step`.  Returns the
    checkpoint's metadata.  Raises FileNotFoundError when there is no
    checkpoint, or when it holds weights only."""
    path = _resolve(save_path, step)
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    missing = [n for n in (_OPTIMIZER, _SCHEDULER) if not os.path.exists(os.path.join(path, n))]
    if missing or "train_step" not in meta:
        raise FileNotFoundError(
            f"{path} holds weights only (no {', '.join(missing) or 'train_step'}); a train"
            " state is restored from a checkpoint that Trainer.save wrote"
        )
    # On the CPU: Adam keeps its step counts there, and load_state_dict moves
    # the moments to their parameters' device.
    load = lambda name: torch.load(os.path.join(path, name), map_location="cpu", weights_only=True)  # noqa: E731
    state.model.load_state_dict(load(_MODEL), strict=True)
    state.optimizer.load_state_dict(load(_OPTIMIZER))
    state.scheduler.load_state_dict(load(_SCHEDULER))
    state.step = int(meta["train_step"])
    return meta


def fresh_init_state(model_cfg: ModelConfig, seed: int = 0) -> Dict[str, torch.Tensor]:
    """The state_dict of a freshly initialised model (random weights from
    `seed`), for runs without a checkpoint."""
    model = GANet(model_cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.state_dict()
