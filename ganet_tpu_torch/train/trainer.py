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

A mesh `MeshConfig(data=N, space=S, disp=P)`, run as N x S x P ranks
of `torch.distributed`, one device each, computes what one device
computes on the global batch, as the JAX step `make_train_step(cfg,
mesh)` does under GSPMD.  The `data` axis splits the batch (every rank
of a `space` x `disp` plane reads the same slice); the `space` axis
splits the image height and the `disp` axis the conv phase's disparity
bins: each rank runs the 2D part on the whole image and the aggregation
on its block of rows and bins (`models/ganet.py`), and holds its rows of
the heads' maps, which every rank of a `disp` line computes alike,
against its rows of the targets (`row_block`).  Train-mode BatchNorm
takes its moments over the global tensor (`sync_batch_norm`: the 2D
part's over `data`, the aggregation's over the whole mesh, or over
`data` x `space` under channel tensor parallelism), the loss
divides by the global batch's valid pixels, the loss, the valid count
and the metrics sum over the `data` x `space` plane (`Mesh.volume_group`),
the gradients are summed over the whole mesh after backward (one flat
buffer; summing from autograd hooks, as DDP's reducer does, would
interleave with the collectives that backward issues, in an order that
can differ between ranks) and the 2D part's then divided by P
(`make_train_step`), and every rank takes the same Adam update.  The
loss and the metrics a step returns are the global batch's.  The ranks'
parameters stay the same bits.  The 2D part's running statistics are
each rank's own: on the card cuDNN's default algorithms do not repeat
bit for bit, so the ranks of a `space` x `disp` plane, each running that
part whole, hold them equal up to float noise; a checkpoint holds rank
0's.

With `cfg.model.channel_tp` the `disp` axis splits the aggregation's
channels instead of its bins (`parallel/channels.py`); the gradients and
the loss sum as above, and every rank of a `disp` line gathers the
running statistics of the aggregation's BatchNorm, which are then the
same bits on every rank.

`Trainer` trains from a `TrainConfig`: its datasets (files or synthetic)
through `BatchIterator` (each rank reads its slice of the global batch),
the epoch loop with JSONL rows (`MetricLogger`), a checkpoint after each
epoch (`train/checkpoint.py`, keyed by the epoch), resume, and evaluation
over the test set with a best-EPE checkpoint.  With a mesh, rank 0 alone
logs and writes; every rank reads a checkpoint to resume.  A checkpoint
holds no trace of the mesh.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Callable, Dict, Mapping, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from ganet_tpu_torch.config import MeshConfig, TrainConfig
from ganet_tpu_torch.data.dataset import get_test_set, get_training_set
from ganet_tpu_torch.data.pipeline import BatchIterator, process_coordinates
from ganet_tpu_torch.entry import Device, build_model, resolve_device
from ganet_tpu_torch.models.layers import sync_batch_norm
from ganet_tpu_torch.parallel.channels import check_channel_shape
from ganet_tpu_torch.parallel.comm import all_reduce_, all_reduce_grads
from ganet_tpu_torch.parallel.disparity import check_disp_shape
from ganet_tpu_torch.parallel.mesh import Mesh, make_mesh
from ganet_tpu_torch.parallel.spatial import check_spatial_shape, row_block
from ganet_tpu_torch.train.checkpoint import latest_step, load_train_state, save_checkpoint
from ganet_tpu_torch.train.loss import deep_supervision_loss
from ganet_tpu_torch.train.metrics import disparity_metrics
from ganet_tpu_torch.train.state import TrainState, make_optimizer, model_digest
from ganet_tpu_torch.utils.logging import MetricLogger

BATCH_KEYS = ("left", "right", "disparity", "valid")
# The keys of a batch that hold (B, H, W) targets, which a rank of a
# `space` line takes its rows of.
TARGET_KEYS = ("disparity", "valid", "disparity_right", "valid_right")

Batch = Mapping[str, Union[np.ndarray, torch.Tensor]]


def check_train_shape(cfg: TrainConfig) -> None:
    """Raise ValueError, naming the sizes that pass, unless `cfg.mesh.space`
    ranks can share the crop height (`check_spatial_shape`) and
    `cfg.mesh.disp` ranks the cost volume's bins (`check_disp_shape`), or
    under `channel_tp` every volume's channels (`check_channel_shape`).
    The test set is padded to the crop, so one check covers training and
    evaluation."""
    check_spatial_shape(cfg.model, cfg.data.crop_height, cfg.mesh.space)
    if cfg.model.channel_tp:
        check_channel_shape(cfg.model, cfg.mesh.disp)
    else:
        check_disp_shape(cfg.model, cfg.mesh.disp)


def train_mesh(mesh: MeshConfig) -> Optional[Mesh]:
    """This rank's place in the (data, space, disp) mesh `mesh`, built over
    the initialised default group (a collective); None for one device."""
    return make_mesh(mesh) if mesh.num_devices > 1 else None


def create_train_state(
    cfg: TrainConfig,
    device: Device = None,
    steps_per_epoch: Optional[int] = None,
    mesh: Optional[Mesh] = None,
) -> TrainState:
    """A train-mode GANet from a seeded init (`cfg.seed`) on `device` (the
    CUDA device unless given), with Adam and its schedule.
    `steps_per_epoch` (default `cfg.steps_per_epoch`) places the decay.

    `mesh` is this rank's place in `cfg.mesh` (default `train_mesh(cfg.mesh)`),
    whose model is this rank's part of the sharded model.  Its BatchNorm
    takes two groups (`sync_batch_norm`): the 2D part's moments sum over
    `data`, the aggregation's over the whole mesh, or under `channel_tp`
    over `data` x `space` (`Mesh.volume_group`), since the ranks of a
    `disp` line then hold other channels.  The state's steps sum
    the loss and the metrics over `data` x `space` (`Mesh.volume_group`)
    and the gradients over the whole mesh, and the ranks' initial
    parameters and buffers are compared bit for bit over the whole mesh:
    a rank that built others raises."""
    mesh = train_mesh(cfg.mesh) if mesh is None else mesh
    model = build_model(cfg.model, device, seed=cfg.seed, mesh=mesh).train()
    group = space = None
    if mesh is not None:
        sync_batch_norm(model, mesh.data_group if mesh.size("data") > 1 else None)
        group = mesh.volume_group
        if not cfg.model.channel_tp:
            sync_batch_norm(model.cost_agg, mesh.world_group)
        elif mesh.size("data") * mesh.size("space") > 1:
            sync_batch_norm(model.cost_agg, group)
        space = mesh.space_group if mesh.size("space") > 1 else None
        digests = [None] * dist.get_world_size()
        dist.all_gather_object(digests, model_digest(model))
        if len(set(digests)) > 1:
            raise RuntimeError(
                f"the ranks of the mesh built different models from seed {cfg.seed}:"
                f" state digests {digests}"
            )
    opt, sched = make_optimizer(
        cfg.optim, model.parameters(), steps_per_epoch or cfg.steps_per_epoch
    )
    return TrainState(model=model, optimizer=opt, scheduler=sched, group=group, space_group=space)


def batch_digest(batch: Mapping[str, np.ndarray]) -> str:
    """SHA-256 of a batch's keys and bytes: equal digests, equal batches."""
    h = hashlib.sha256()
    for k in sorted(batch):
        h.update(k.encode() + np.ascontiguousarray(batch[k]).tobytes())
    return h.hexdigest()


def _target_rows(b: Dict[str, torch.Tensor], space) -> Dict[str, torch.Tensor]:
    """`b` with its targets cut to this rank's block of rows along the
    `space` group (the rows of the model's outputs); the images stay
    whole.  Under `left_right` the right view's targets are flipped along
    W only, so their block is the same rows."""
    if space is None:
        return b
    a, c = row_block(b["left"].shape[1], space)
    return {k: v[:, a:c] if k in TARGET_KEYS else v for k, v in b.items()}


def _to_device(batch: Batch, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in batch.items()}


def make_train_step(cfg: TrainConfig) -> Callable[[TrainState, Batch], Dict[str, object]]:
    """`train_step(state, batch)`: one update of `state` in place.

    batch: "left", "right" (B, H, W, 3), "disparity", "valid" (B, H, W),
    and with `cfg.data.left_right` also "disparity_right", "valid_right";
    numpy arrays or tensors.  Returns the loss and the final head's metrics
    as device tensors (no synchronisation), and "lr", the learning rate of
    this update, as a float.  With `state.group` the batch is this rank's
    slice of the global batch (its `data` index's; the ranks of a `space`
    x `disp` plane pass the same whole images), and the loss and the
    metrics are the global batch's.

    Why the gradients' sum over `data` x `space` is the global batch's:
    the global loss is the sum of the ranks' losses, each divided by the
    global valid count.  An aggregation parameter's gradient on a rank
    covers that rank's rows.  The 2D part runs whole on every rank of a
    `space` line, but a rank's loss reaches it only through that rank's
    rows of the cost volume and the guidance, so the line's sum is the
    gradient through every row; the sum over `data` is that of the data
    slices, as BatchNorm's all-reduce backward on the `data` group sums
    the cotangents of the moments that the slices share.

    Why, with `disp` P > 1, the sum over the whole mesh is the global
    batch's for the aggregation and P times it for the 2D part.  The ranks
    of a `disp` line compute one loss, whose cotangent is then the same on
    every rank, and the boundary ops keep two kinds of tensor exact:
    a block's cotangent on a rank is the loss's derivative by that block,
    a replicated tensor's is its whole derivative on every rank.
    `gather_blocks` hands each rank its block of the replicated
    cotangent, `take_block` gathers the blocks' cotangents, and
    `copy_in` sums over the line the cotangents that each rank's block of
    the cost volume gives the whole features.  BatchNorm's sum over the
    mesh sums the cotangents of the moments that all blocks share.  So an
    aggregation parameter's gradient on a rank covers its rows and bins,
    and the whole mesh sums them, the heads' C -> 1 convs included; a 2D
    parameter's covers every bin of the rank's rows, alike on each rank
    of the line, so the mesh's sum counts it P times and is divided by P:
    on the card, where cuDNN's replicated runs need not agree bit for
    bit, that is their mean, the same bits on every rank.

    Under `channel_tp` the same sums hold with channels for bins.  A
    blocked 3D conv's gradient on a rank covers its block of output
    channels' weights, and its BatchNorm's scale and bias their block:
    `column_gather`'s backward sums the ranks' cotangents of the gathered
    input and hands each rank its block, so each rank's block of a volume
    gets its whole derivative.  A head's C -> 1 conv runs on the rank's
    block of input channels (row-parallel) and `row_reduce`'s backward
    hands each rank the replicated cotangent of the sum, so its gradient
    covers that block of its weights.  So every aggregation parameter's
    gradient is a block, and the mesh's sum is the whole; the 2D part is
    reached through `copy_in` and `take_block` (the SGA weights), whose
    backward gives every rank the whole derivative, and the mesh's sum is
    divided by P as above.
    """
    left_right = cfg.data.left_right

    def train_step(state: TrainState, batch: Batch) -> Dict[str, object]:
        model, group = state.model, state.group
        b = _target_rows(_to_device(batch, next(model.parameters()).device), state.space_group)
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
                deep_supervision_loss(outs_l, b["disparity"], b["valid"], cfg.loss_weights, group)
                + deep_supervision_loss(
                    outs_r, b["disparity_right"], b["valid_right"], cfg.loss_weights, group
                )
            )
            outputs = outs_l
        else:
            loss = deep_supervision_loss(
                outputs, b["disparity"], b["valid"], cfg.loss_weights, group
            )
        lr = state.lr
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if group is not None:
            all_reduce_grads(model.parameters(), model.mesh.world_group)
            disp = model.mesh.size("disp")
            if disp > 1:
                blocked = {id(p) for p in model.cost_agg.parameters()}
                for p in model.parameters():
                    if p.grad is not None and id(p) not in blocked:
                        p.grad.div_(disp)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        loss = loss.detach()
        metrics: Dict[str, object] = {"loss": loss if group is None else all_reduce_(loss.clone(), group)}
        with torch.no_grad():
            metrics.update(disparity_metrics(outputs[-1], b["disparity"], b["valid"], group))
        metrics["lr"] = lr
        return metrics

    return train_step


def make_eval_step(cfg: TrainConfig) -> Callable[[TrainState, Batch], Dict[str, torch.Tensor]]:
    """`eval_step(state, batch)`: the eval-mode forward (running BatchNorm
    statistics, final head only) and its metrics, as device tensors; with
    `state.group`, on this rank's slice (and block of rows) and over the
    global batch."""

    def eval_step(state: TrainState, batch: Batch) -> Dict[str, torch.Tensor]:
        model = state.model
        b = _target_rows(_to_device(batch, next(model.parameters()).device), state.space_group)
        model.eval()
        with torch.no_grad():
            disp = model(b["left"], b["right"])
            return disparity_metrics(disp, b["disparity"], b["valid"], state.group)

    return eval_step


class Trainer:
    """The training run of a `TrainConfig` on one device (the CUDA device
    unless `device` names another), or on this rank's device of a mesh
    (`cfg.mesh.num_devices` ranks, every one of which builds a `Trainer`;
    `mesh` defaults to `train_mesh(cfg.mesh)`), with the JAX `Trainer`'s
    methods and their semantics.  The ranks of a `space` x `disp` plane
    read the same slice of each global batch, the slice of their `data`
    index, crops included (checked at the first step); a crop height that
    `space` cannot share, or a max_disp that `disp` cannot, raises
    ValueError here, before any step.

    A `save_path` that already holds a checkpoint, or `cfg.resume`, restores
    the newest one: `start_epoch` becomes its epoch + 1 and nothing else is
    reset.  As in the JAX package, the batch iterator and the training set
    start afresh, so a resumed run's first epoch sees epoch 0's permutation
    and crops again, where an uninterrupted run would see epoch 1's.  A
    checkpoint holds no trace of the mesh: one from N ranks restores on one
    device, and one from one device on N ranks.
    """

    def __init__(self, cfg: TrainConfig, device: Device = None, mesh: Optional[Mesh] = None):
        self.cfg = cfg
        check_train_shape(cfg)
        self.mesh = train_mesh(cfg.mesh) if mesh is None else mesh
        # This rank's slice of each global batch: its index along `data`.
        self.data_index, self.data_size = (
            (0, 1) if self.mesh is None else (self.mesh.index["data"], self.mesh.size("data"))
        )
        if cfg.batch_size % self.data_size != 0:
            raise ValueError(
                f"batch_size {cfg.batch_size} must be divisible by the data"
                f" mesh axis ({self.data_size})"
            )
        self.device = resolve_device(device)
        # With a mesh only rank 0 logs and writes checkpoints: the state is
        # the same on every rank, and the log then holds one run's rows.
        self.is_lead = process_coordinates()[0] == 0
        self.logger = MetricLogger(cfg.save_path) if self.is_lead else None
        self.train_ds = get_training_set(cfg.data, cfg.model.max_disp)
        self.train_iter = BatchIterator(
            self.train_ds,
            cfg.batch_size,
            shuffle=cfg.data.shuffle,
            seed=cfg.seed,
            process_index=self.data_index,
            process_count=self.data_size,
            prefetch=cfg.data.num_prefetch,
        )
        self.steps_per_epoch = cfg.steps_per_epoch or len(self.train_iter)
        self.state = create_train_state(cfg, self.device, self.steps_per_epoch, self.mesh)
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
    def _barrier(self) -> None:
        """With a mesh, wait until every rank is here (after rank 0's writes)."""
        if self.mesh is not None:
            dist.barrier()

    def _save(self, root: str, key: int, keep: int, **extra) -> None:
        state = self.state
        extra["train_step"] = state.step
        save_checkpoint(root, key, state.model, state.optimizer, state.scheduler, extra, keep)

    def save(self, epoch: int) -> None:
        """The checkpoint of `epoch` under `save_path`, keyed by the epoch;
        the newest `cfg.keep_checkpoints` are kept.  With a mesh every rank
        calls it: rank 0 writes (the state is the same on every rank), the
        others wait for it."""
        if self.is_lead:
            self._save(self.ckpt_dir, epoch, self.cfg.keep_checkpoints, epoch=epoch)
        self._barrier()

    def save_best(self, epe: float) -> bool:
        """Keep a best-EPE checkpoint (`best/`, keyed by the step, keep-1) and
        `best_epe.json` {"epe", "step"}; True when `epe` improves on the
        stored best.  With a mesh every rank calls it: rank 0 reads the
        marker and writes, the others wait for it and return False."""
        improved = False
        if self.is_lead:
            marker = os.path.join(self.ckpt_dir, "best_epe.json")
            best = float("inf")
            if os.path.exists(marker):
                with open(marker) as f:
                    best = json.load(f).get("epe", float("inf"))
            if epe < best:
                step = self.state.step
                self._save(os.path.join(self.ckpt_dir, "best"), step, keep=1)
                with open(marker, "w") as f:
                    json.dump({"epe": epe, "step": step}, f)
                improved = True
        self._barrier()
        return improved

    def restore(self, path_or_latest: Optional[str] = None) -> None:
        """Restore the newest checkpoint under `save_path` (or under the
        directory given, as the reference's --resume); `start_epoch` becomes
        its epoch + 1.  With a mesh every rank reads it."""
        root = os.path.abspath(path_or_latest) if path_or_latest else self.ckpt_dir
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoint found under {root}")
        load_train_state(root, step, self.state)
        self.start_epoch = step + 1

    def close(self) -> None:
        """Close the metric log.  Saves are synchronous: nothing is in flight."""
        if self.logger is not None:
            self.logger.close()

    def _log(self, step: int, metrics: Dict[str, object], prefix: str) -> None:
        if self.logger is not None:
            self.logger.log(step, metrics, prefix=prefix)

    def _check_same_batch(self, batch: Mapping[str, np.ndarray]) -> None:
        """Raise unless the ranks of this rank's `space` x `disp` plane (its
        `data` index's) hold the same batch: one all-gather of (data index,
        digest) over the mesh."""
        if self.mesh is None or self.mesh.size("space") * self.mesh.size("disp") == 1:
            return
        seen = [None] * dist.get_world_size()
        dist.all_gather_object(seen, (self.data_index, batch_digest(batch)))
        digests = [d for i, d in seen if i == self.data_index]
        if len(set(digests)) > 1:
            raise RuntimeError(
                f"the ranks of a space x disp plane read different batches (digests {digests}):"
                " they must share their data index's slice, crops included"
            )

    # -- loops ------------------------------------------------------------
    def fit(self) -> TrainState:
        """Train from `start_epoch` to `cfg.num_epochs`, at most
        `cfg.steps_per_epoch` steps an epoch, logging a row at each epoch's
        first step and every `cfg.log_every` steps (the only places that
        wait for the device), and saving after each epoch."""
        cfg = self.cfg
        step = first = self.state.step
        for epoch in range(self.start_epoch, cfg.num_epochs):
            it = iter(self.train_iter)
            try:
                for i, batch in enumerate(it):
                    if cfg.steps_per_epoch and i >= cfg.steps_per_epoch:
                        break
                    batch = {k: batch[k] for k in self.train_keys}
                    if step == first:
                        self._check_same_batch(batch)
                    metrics = self.train_step(self.state, batch)
                    step += 1
                    if step % cfg.log_every == 0 or i == 0:
                        # "lr" is the learning rate of the update just made.
                        self._log(step, metrics, prefix=f"epoch{epoch}")
            finally:
                # Close the generator, so that its prefetch thread is reaped
                # even after a break.
                it.close()
            self.save(epoch)
        return self.state

    def evaluate(self, max_batches: Optional[int] = None) -> Dict[str, float]:
        """Metrics over the test set (batch 1 a device: with a mesh each rank
        evaluates its slice of each global batch, whose metrics the eval
        step sums over the ranks), pixel-weighted by each batch's valid
        pixels; logged under "val" (by rank 0), and the EPE is offered to
        `save_best`."""
        cfg = self.cfg
        test_ds = get_test_set(cfg.data, cfg.model.max_disp)
        it = BatchIterator(
            test_ds,
            self.data_size,
            shuffle=False,
            drop_remainder=False,
            process_index=self.data_index,
            process_count=self.data_size,
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
        self._log(n, result, prefix="val")
        if "epe" in result:
            self.save_best(float(result["epe"]))
        return result
