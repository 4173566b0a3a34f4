"""Sharded SGA and LGA cases, run on every rank of a launch.

    launch(run_cases, S, (cases, out_dir, device), backend=..., device=device)

Each case is a dict:
  name     file stem of the results;
  op       "sga" (x (B, C, D, H, W), w (B, C, 4, 5, H, W)) or "lga"
           (x (B, D, H, W), guidance (B, 75, H, W), radius 2);
  shape    the whole volume's shape, H divisible by the rank count;
  seed     of the inputs, which every rank and the caller rebuild alike
           with `make_inputs` (numpy, float32);
  dtype    "float32" or "bfloat16";
  chunks, force_pipeline (sga), repeats (lga);
  grad     also run the backward with the cotangent `gbar` of the inputs;
  reps     time that many further runs (host clock, after a barrier, up to
           a synchronize), 0 for none;
  mesh     optional (data, space, disp): the ranks form that mesh
           (`make_mesh`), the batch is split over `data` and H over
           `space`, whose group the op runs on; without it H is split over
           all ranks.
Each rank takes its block of the inputs, runs `sharded_sga` or
`sharded_lga` on it, and saves its block of the output (and of dx and dw
or dg) with the launch counts of the kernels and the times to
`<out_dir>/<name>.<rank>.pt`.  `gather` joins the ranks' blocks.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ganet_tpu_torch.config import MeshConfig
from ganet_tpu_torch.parallel.mesh import make_mesh
from ganet_tpu_torch.parallel.sharded_lga import sharded_lga
from ganet_tpu_torch.parallel.sharded_sga import sharded_sga
from ganet_tpu_torch.utils.profiling import read_launches, reset_launches

def make_inputs(case: dict) -> Dict[str, np.ndarray]:
    """The whole volume's inputs of a case, float32, from its seed: x, the
    weights `w` (SGA, L1-normalised over the 5) or guidance `g` (LGA,
    L1-normalised over the 75), and the cotangent `gbar`."""
    rng = np.random.default_rng(case["seed"])
    shape = tuple(case["shape"])
    x = rng.standard_normal(shape, dtype=np.float32)
    if case["op"] == "sga":
        B, C, D, H, W = shape
        w = rng.standard_normal((B, C, 4, 5, H, W), dtype=np.float32)
        w /= np.maximum(np.abs(w).sum(axis=3, keepdims=True), 1e-8)
    else:
        B, D, H, W = shape
        w = rng.standard_normal((B, 75, H, W), dtype=np.float32)
        w /= np.maximum(np.abs(w).sum(axis=1, keepdims=True), 1e-8)
    out = {"x": x, "w" if case["op"] == "sga" else "g": w}
    if case.get("grad"):
        out["gbar"] = rng.standard_normal(shape, dtype=np.float32)
    return out


def h_axis(case: dict, name: str) -> int:
    """The H axis of input or output `name` of a case."""
    if case["op"] == "sga":
        return 4 if name in ("w", "dw") else 3
    return 2


def gather(case: dict, out_dir: str, nprocs: int) -> Dict[str, object]:
    """Every rank's results of a case, blocks joined along H; "launches"
    and "times" as lists over the ranks."""
    parts = [torch.load(os.path.join(out_dir, f"{case['name']}.{r}.pt")) for r in range(nprocs)]
    n_data = case.get("mesh", (1,))[0]
    per = nprocs // n_data  # ranks of one data block, in space order (disp = 1)
    joined: Dict[str, object] = {
        k: torch.cat([
            torch.cat([p[k] for p in parts[i * per : (i + 1) * per]], dim=h_axis(case, k))
            for i in range(n_data)
        ], dim=0)
        for k in parts[0] if k not in ("launches", "times")
    }
    joined["launches"] = [p["launches"] for p in parts]
    joined["times"] = [p["times"] for p in parts]
    return joined


def _block(a: np.ndarray, axis: int, index: int, count: int) -> np.ndarray:
    return np.split(a, count, axis=axis)[index]


def run_cases(rank: int, nprocs: int, cases: Sequence[dict], out_dir: str, device: str) -> None:
    """Run every case on this rank, on `device` ("cuda": this rank's card;
    see the module docstring)."""
    for case in cases:
        dtype = getattr(torch, case.get("dtype", "float32"))
        group, (b, nb), (h, nh) = None, (0, 1), (rank, nprocs)
        if "mesh" in case:
            mesh = make_mesh(MeshConfig(*case["mesh"]))
            group = mesh.space_group
            b, nb = mesh.index["data"], mesh.size("data")
            h, nh = mesh.index["space"], mesh.size("space")
        inputs = make_inputs(case)
        local = {
            k: torch.from_numpy(_block(_block(v, 0, b, nb), h_axis(case, k), h, nh).copy()).to(device, dtype)
            for k, v in inputs.items()
        }
        grad = bool(case.get("grad"))
        x = local["x"].requires_grad_(grad)
        other = local["w" if case["op"] == "sga" else "g"].requires_grad_(grad)

        def run():
            if case["op"] == "sga":
                return sharded_sga(x, other, group, case.get("chunks", 0),
                                   case.get("force_pipeline", False))
            return sharded_lga(x, other, 2, case.get("repeats", 1), group)

        reset_launches()
        with torch.set_grad_enabled(grad):
            out = run()
            if grad:
                out.backward(local["gbar"])
        if device == "cuda":
            torch.cuda.synchronize()
        result = {"out": out.detach().cpu(), "launches": read_launches()}
        if grad:
            result["dx"] = x.grad.cpu()
            result["dw" if case["op"] == "sga" else "dg"] = other.grad.cpu()
        times: List[float] = []
        for _ in range(case.get("reps", 0)):
            x.grad, other.grad = None, None
            dist.barrier()
            t0 = time.perf_counter()
            with torch.set_grad_enabled(grad):
                out = run()
                if grad:
                    out.backward(local["gbar"])
            if device == "cuda":
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        result["times"] = times
        torch.save(result, os.path.join(out_dir, f"{case['name']}.{rank}.pt"))
        del out, x, other, local, inputs
