"""Train-step cases on a mesh, run on every rank of a launch, and the
one-device run that they are held against.

    launch(run_cases, N, (cases, out_dir, device), backend=..., device=device)
    reference(case, device)

Each case is a dict:
  name      file stem of the results;
  kind      "step": train steps of a GANet through `create_train_state`
            and `make_train_step` on the mesh `MeshConfig(*mesh)`; "bn":
            one train-mode BatchNorm (`bn_train`) forward and backward;
            "trainer": a `Trainer` on the mesh, its first batch's digest
            and its check that a `space` line reads one batch;
  mesh      (data, space[, disp]) of a step or trainer case, whose
            product is N (default (N, 1, 1));
  model     preset name ("GANet_small", "GANet_deep"), with
  size      (H, W), max_disp, dtype ("float32", "bfloat16", or "float64",
            which measures the float32 noise of the others), remat,
            left_right, lr (step), channel_tp (the `disp` axis splits
            channels, default False);
  batch     the global batch, which N divides;
  steps     train steps, each on its own global batch;
  valid     "dense", or "unequal": the second half of each batch (the
            last `data` ranks' rows) loses the valid pixels of its top
            third of rows, so that the ranks' valid counts differ along
            `data` and, with `space` 2, between the row blocks;
  weights   optional path of a `state_dict` that every rank (and the
            reference) loads before the first step;
  reps      (step, CUDA) time that many further steps between
            synchronises, and the gradient all-reduce alone as often;
  shape     (bn) the global input's (B, C, D, H, W), seed.
Every input is made from the case's seed with numpy, alike on every rank
and in the reference.  Each rank takes its `data` index's slice of each
global batch (index i of `data` D: batch rows [i B/D, (i+1) B/D), as
`BatchIterator` slices them; the ranks of a `space` x `disp` plane pass
the same whole images, and the train step takes their rows), and saves to
`<out_dir>/<name>.<rank>.pt`: the losses, the last step's metrics, the
state_dict after the steps (on the CPU), its digest, the last step's
gradients, and on a CUDA device the launches of every kernel a step, the
step and all-reduce times and the peak memory.
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections import Counter
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ganet_tpu_torch.config import DataConfig, MeshConfig, OptimConfig, TrainConfig, model_config
from ganet_tpu_torch.data import SyntheticStereoDataset, stack
from ganet_tpu_torch.models.layers import bn_train, sync_batch_norm
from ganet_tpu_torch.parallel.comm import all_reduce_grads
from ganet_tpu_torch.train.state import model_digest
from ganet_tpu_torch.train.trainer import (
    Trainer,
    batch_digest,
    create_train_state,
    make_train_step,
    train_mesh,
)
from ganet_tpu_torch.utils.profiling import read_launches, recording_shapes, reset_launches


def mesh_shape(case: dict, nprocs: int = 1) -> tuple:
    """(data, space, disp) of a case: its "mesh", padded with 1s, or
    (nprocs, 1, 1)."""
    return (tuple(case.get("mesh", (nprocs,))) + (1, 1))[:3]


def train_config(case: dict, data: int = 1, space: int = 1, disp: int = 1) -> TrainConfig:
    """The `TrainConfig` of a step case on the mesh (data, space, disp)."""
    H, W = case["size"]
    model = model_config(case["model"], max_disp=case["max_disp"],
                         compute_dtype=case.get("dtype", "float32"), remat=case.get("remat", "none"),
                         channel_tp=case.get("channel_tp", False))
    return TrainConfig(
        model=model,
        data=DataConfig(crop_height=H, crop_width=W, kind="synthetic",
                        left_right=case.get("left_right", False)),
        optim=OptimConfig(lr=case.get("lr", 1e-3)),
        mesh=MeshConfig(data=data, space=space, disp=disp),
        batch_size=case["batch"],
        seed=case.get("seed", 0),
    )


def batches(case: dict) -> List[Dict[str, np.ndarray]]:
    """The case's global batches, one a step."""
    H, W = case["size"]
    B = case["batch"]
    ds = SyntheticStereoDataset(H, W, case["max_disp"], left_right=case.get("left_right", False),
                                seed=case.get("seed", 0))
    out = []
    for s in range(case.get("steps", 1)):
        b = stack(ds, range(s * B, (s + 1) * B))
        if case.get("valid", "dense") == "unequal":
            for k in ("valid", "valid_right"):
                if k in b:
                    b[k] = b[k].copy()
                    b[k][B // 2 :, : H // 3] = 0.0
        out.append(b)
    return out


def bn_inputs(case: dict) -> Dict[str, np.ndarray]:
    """x and the cotangent `gbar` of a bn case, float32, from its seed."""
    rng = np.random.default_rng(case.get("seed", 0))
    shape = tuple(case["shape"])
    x = rng.standard_normal(shape, dtype=np.float32) * 2.0 + 0.5
    return {"x": x, "gbar": rng.standard_normal(shape, dtype=np.float32)}


def _rows(a, rank: int, n: int):
    per = a.shape[0] // n
    return a[rank * per : (rank + 1) * per]


def _bn_module(case: dict, device) -> torch.nn.BatchNorm3d:
    C = case["shape"][1]
    bn = torch.nn.BatchNorm3d(C, eps=1e-5, momentum=0.1).to(device).train()
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, C))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, C))
    return bn


def _bn_run(case: dict, rank: int, n: int, device, group) -> Dict[str, object]:
    bn = _bn_module(case, device)
    sync_batch_norm(bn, group)
    inp = bn_inputs(case)
    x = torch.from_numpy(_rows(inp["x"], rank, n).copy()).to(device).requires_grad_()
    y = bn_train(x, bn)
    (y * torch.from_numpy(_rows(inp["gbar"], rank, n).copy()).to(device)).sum().backward()
    if group is not None:
        all_reduce_grads(bn.parameters(), group)
    return {"y": y.detach().cpu(), "dx": x.grad.cpu(),
            "dweight": bn.weight.grad.cpu(), "dbias": bn.bias.grad.cpu(),
            "state": {k: v.cpu() for k, v in bn.state_dict().items()}}


def _step_run(case: dict, rank: int, mesh: tuple, device, keep_init: bool = False) -> Dict[str, object]:
    data, space, disp = mesh
    cfg = train_config(case, data, space, disp)
    # This rank's slice of each global batch: its `data` index's.
    i, n = rank // (space * disp), data
    cuda = torch.device(device).type == "cuda"
    state = create_train_state(cfg, device, mesh=train_mesh(cfg.mesh))
    if cfg.model.compute_dtype == "float64":
        state.model.double()  # Adam's moments follow the parameters' dtype
    if case.get("weights"):
        state.model.load_state_dict(torch.load(case["weights"], map_location="cpu", weights_only=True))
    init = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()} if keep_init else None
    step = make_train_step(cfg)
    losses, launches = [], []
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    all_batches = batches(case)
    shapes: Counter = Counter()
    with recording_shapes(shapes):
        for b in all_batches:
            reset_launches()
            m = step(state, {k: _rows(v, i, n) for k, v in b.items()})
            losses.append(m["loss"].item())
            launches.append(read_launches())
    result: Dict[str, object] = {
        "losses": losses,
        "metrics": {k: float(v) for k, v in m.items()},
        "state": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
        "digest": model_digest(state.model),
        # The last step's gradients, summed over the ranks: the global batch's.
        "grads": {k: p.grad.detach().cpu() for k, p in state.model.named_parameters()
                  if p.grad is not None},
        "launches": launches,
        # (kernel, volume shape, dtype[, radius]) -> launches, as `recording_shapes` counts
        "shapes": dict(shapes),
    }
    if init is not None:
        result["init"] = init
    if cuda:
        result["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        times, reduce_ms = [], []
        local = {k: _rows(v, i, n) for k, v in all_batches[0].items()}
        for _ in range(case.get("reps", 0)):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, local)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        for _ in range(case.get("reps", 0)):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            all_reduce_grads(state.model.parameters(), state.model.mesh.world_group)
            torch.cuda.synchronize()
            reduce_ms.append((time.perf_counter() - t0) * 1e3)
        result.update(step_ms=times, allreduce_ms=reduce_ms,
                      grad_mib=sum(p.numel() * p.element_size() for p in state.model.parameters()) / 2**20)
    return result


def _trainer_run(case: dict, rank: int, mesh: tuple, device, out_dir: str) -> Dict[str, object]:
    """A `Trainer` on the mesh: the digest of its first batch, then its
    check at the first step, given a batch that odd ranks alter (which
    must raise on every rank of a line with an altered rank), and one step
    of `fit`."""
    cfg = dataclasses.replace(train_config(case, *mesh), num_epochs=1, steps_per_epoch=1,
                              save_path=os.path.join(out_dir, f"{case['name']}.ckpt"))
    trainer = Trainer(cfg, device=device)
    it = iter(trainer.train_iter)
    batch = {k: v for k, v in next(it).items() if k in trainer.train_keys}
    it.close()
    altered = {k: v + (rank % 2) for k, v in batch.items()}
    try:
        trainer._check_same_batch(altered)
        raised = None
    except RuntimeError as e:
        raised = str(e)
    trainer.fit()
    trainer.close()
    return {"digest": batch_digest(batch), "raised": raised, "step": trainer.state.step,
            "index": dict(trainer.mesh.index), "state_digest": model_digest(trainer.state.model)}


def run_cases(rank: int, nprocs: int, cases: Sequence[dict], out_dir: str, device: str) -> None:
    """Run every case on this rank of a launch of `nprocs` ranks, on
    `device` ("cuda": this rank's card, float32 convolutions and products
    without TF32, as the caller's reference runs them); see the module
    docstring."""
    group = dist.new_group(list(range(nprocs)))
    if device == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    for case in cases:
        mesh = mesh_shape(case, nprocs)
        if case["kind"] == "bn":
            result = _bn_run(case, rank, nprocs, device, group)
        elif case["kind"] == "trainer":
            result = _trainer_run(case, rank, mesh, device, out_dir)
        else:
            result = _step_run(case, rank, mesh, device)
        torch.save(result, os.path.join(out_dir, f"{case['name']}.{rank}.pt"))
        del result
        if device == "cuda":
            torch.cuda.empty_cache()


def load(case: dict, out_dir: str, nprocs: int) -> List[Dict[str, object]]:
    """Every rank's results of a case, in rank order."""
    return [torch.load(os.path.join(out_dir, f"{case['name']}.{r}.pt"), weights_only=False)
            for r in range(nprocs)]


def reference(case: dict, device) -> Dict[str, object]:
    """The case on one device, on the whole global batch: what the ranks
    together must compute, with (step) its state before the steps under
    "init"."""
    if case["kind"] == "bn":
        return _bn_run(case, 0, 1, device, None)
    return _step_run(dict(case, reps=0), 0, (1, 1, 1), device, keep_init=True)
