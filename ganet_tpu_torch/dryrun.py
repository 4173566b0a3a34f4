"""One training step on a mesh of n ranks, held against one device, then
a sharded predict from the trained state (the port's counterpart of
`dryrun_multichip` in the repo's `__graft_entry__.py`):

    python -m ganet_tpu_torch.dryrun 4 [--device cpu]

The mesh follows the JAX rule: n a multiple of 8 puts 2 on `disp`; else
an even n puts gcd(n / 2, 16) on `space` and the rest on `data`; else
gcd(n, 16) on `space` when that is all of n, or n on `data`.  So n = 8
runs (data, space, disp) = (2, 2, 2): the cost volume's 8 bins in blocks
of 4 over `disp`, 24 of its rows over `space`, with D halos, H halos and
their corners, the wavefront and BatchNorm over the whole mesh together.

The run: GANet_small, max_disp 24, 48x96 synthetic pairs, global batch
2 x data, the seeded init 0.  This process computes one step of the
whole batch on one device first; then n ranks (`parallel/launch.py`,
this process rank 0; gloo on the CPU and for ranks that share a card)
take one step of the same batch from the same state, whose loss must be
finite and equal the one-device loss within rtol 1e-5, and run
`entry.predict` on the batch from the trained state, whose disparity
must be finite and of the batch's shape.  Float32 without TF32, as the
check compares float32 sums.  Runs on the CUDA device unless `device`
says "cpu".
"""

from __future__ import annotations

import argparse
import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

from ganet_tpu_torch.config import DataConfig, MeshConfig, TrainConfig, ganet_small
from ganet_tpu_torch.data import SyntheticStereoDataset, stack
from ganet_tpu_torch.entry import predict, resolve_device
from ganet_tpu_torch.parallel.launch import default_backend, launch
from ganet_tpu_torch.train.trainer import create_train_state, make_train_step, train_mesh

H, W, MAX_DISP = 48, 96, 24
RTOL = 1e-5


def dryrun_mesh(n_devices: int) -> MeshConfig:
    """The (data, space, disp) mesh of n devices, by the JAX dryrun's rule."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be at least 1, got {n_devices}")
    if n_devices % 8 == 0:
        disp = 2
        rem = n_devices // (2 * disp)
        space = math.gcd(rem, 16)
        return MeshConfig(data=2 * rem // space, space=space, disp=disp)
    if n_devices % 2 == 0 and n_devices > 1:
        space = math.gcd(n_devices // 2, 16)
        return MeshConfig(data=n_devices // space, space=space, disp=1)
    mesh = MeshConfig(data=1, space=math.gcd(n_devices, 16), disp=1)
    return mesh if mesh.num_devices == n_devices else MeshConfig(data=n_devices, space=1, disp=1)


def dryrun_config(mesh: MeshConfig) -> TrainConfig:
    return TrainConfig(
        model=ganet_small(max_disp=MAX_DISP),
        data=DataConfig(crop_height=H, crop_width=W, kind="synthetic"),
        mesh=mesh,
        batch_size=2 * mesh.data,
    )


def dryrun_batch(cfg: TrainConfig) -> Dict[str, np.ndarray]:
    """The global batch: the synthetic set's first batch_size pairs."""
    return stack(SyntheticStereoDataset(H, W, MAX_DISP), range(cfg.batch_size))


def _rank(rank: int, world: int, cfg: TrainConfig, device: str) -> Optional[dict]:
    mesh = train_mesh(cfg.mesh)
    # On the card: the device that the launcher made current for this rank.
    state = create_train_state(cfg, "cpu" if device == "cpu" else None, mesh=mesh)
    batch = dryrun_batch(cfg)
    data = 1 if mesh is None else mesh.size("data")
    i = 0 if mesh is None else mesh.index["data"]
    per = cfg.batch_size // data
    metrics = make_train_step(cfg)(state, {k: v[i * per : (i + 1) * per] for k, v in batch.items()})
    loss, epe = float(metrics["loss"]), float(metrics["epe"])
    disp = predict(state.model.eval(), batch["left"], batch["right"]).cpu()
    if rank != 0:
        return None
    return {"loss": loss, "epe": epe, "shape": tuple(disp.shape),
            "finite": bool(torch.isfinite(disp).all())}


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the dryrun on `n_devices` ranks (see the module docstring);
    prints the JAX dryrun's ok line and returns its figures; raises on a
    failed check."""
    mesh = dryrun_mesh(n_devices)
    kind = resolve_device(device).type
    cfg = dryrun_config(mesh)
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        one = create_train_state(dataclasses.replace(cfg, mesh=MeshConfig()), kind)
        ref_loss = float(make_train_step(cfg)(one, dryrun_batch(cfg))["loss"])
        del one
        res = launch(_rank, n_devices, (cfg, kind), backend=default_backend(kind, n_devices),
                     device=kind, caller_rank=True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    loss, shape = res["loss"], res["shape"]
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    shape_name = {"data": mesh.data, "space": mesh.space, "disp": mesh.disp}
    np.testing.assert_allclose(loss, ref_loss, rtol=RTOL,
                               err_msg=f"mesh {shape_name} loss {loss} != (1,1,1) {ref_loss}")
    if shape != (cfg.batch_size, H, W) or not res["finite"]:
        raise AssertionError(f"sharded predict: shape {shape}, finite {res['finite']}")
    print(
        f"dryrun_multichip ok: mesh={shape_name} loss={loss:.4f} epe={res['epe']:.3f} "
        f"mesh_invariance |d|={abs(loss - ref_loss):.2e} predict_sharded ok shape={shape}"
    )
    return dict(res, mesh=mesh, ref_loss=ref_loss)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="one sharded training step and predict, held "
                                "against one device")
    p.add_argument("n_devices", type=int)
    p.add_argument("--device", default=None, help="'cpu' for gloo ranks on the CPU (default: the card)")
    args = p.parse_args(argv)
    return dryrun_multichip(args.n_devices, args.device)


if __name__ == "__main__":
    main()
