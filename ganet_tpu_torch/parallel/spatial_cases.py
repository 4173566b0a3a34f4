"""Cases of the H-sharded model, run on every rank of a launch.

    launch(run_cases, N, (cases, out_dir, device), backend=..., device=device)

Each case is a dict:
  name     file stem of the results;
  mesh     (data, space): the ranks form the mesh (data, space, 1)
           (`make_mesh`), whose size is the launch's N;
  kind     "halo": one op of `parallel/spatial.py` on this rank's block of
           rows, with
             op     "conv" (`halo_conv_same`, 3D, stride 1, with a folded
                    BatchNorm scale), "conv_s2" (the same at stride 2),
                    "conv2d" (2D, stride 1), "deconv"
                    (`halo_conv_transpose`, 3D, with a bias) or
                    "upsample" (`halo_trilinear_upsample`, x3 in D, H, W);
             shape  the whole input's shape, H divisible by `space`;
             seed   of the inputs (`halo_inputs`, numpy float32);
           the `data` lines run the same op on the same input;
  kind     "model": the sharded eval forward through `entry.build_model`
           and `entry.predict`, with
             model  preset name, size (H, W), max_disp, batch, dtype;
             weights  optional path of a `state_dict` that every rank
                    loads, else the seeded init `init_seed` (default 0);
             seed   of the input pair (`model_inputs`, numpy float32);
             reps   (CUDA) time that many further forwards.
Every rank saves `<out_dir>/<name>.<rank>.pt`: for "halo" its block of
the output ("out") and of the gradient of <output, the cotangent
`halo_cotangent`> with respect to x ("dx"), each joined by `gather`; for
"model" the whole disparity that `predict` returned there ("out"), the
launches of every kernel in that forward ("launches"), the shapes K1, K2
and K5 were launched at ("shapes", as `utils.profiling.recording_shapes`
keys them), and on a CUDA device the forward's wall time after a barrier
up to a synchronize ("times", ms) and the peak memory ("peak_gib").
"""

from __future__ import annotations

import os
import time
from collections import Counter
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ganet_tpu_torch.config import MeshConfig, model_config
from ganet_tpu_torch.entry import build_model, predict
from ganet_tpu_torch.parallel.mesh import make_mesh
from ganet_tpu_torch.parallel.spatial import (
    halo_conv_same,
    halo_conv_transpose,
    halo_trilinear_upsample,
    row_block,
)
from ganet_tpu_torch.utils.profiling import read_launches, recording_shapes, reset_launches

def halo_inputs(case: dict) -> Dict[str, np.ndarray]:
    """The whole input x and the op's parameters, float32, from the seed."""
    rng = np.random.default_rng(case["seed"])
    shape = tuple(case["shape"])
    out = {"x": rng.standard_normal(shape, dtype=np.float32)}
    op = case["op"]
    if op == "upsample":
        return out
    cin = shape[1]
    cout = cin + 1
    k = 4 if op == "deconv" else 3
    wshape = (cin, cout) if op == "deconv" else (cout, cin)
    wshape += (k,) * (len(shape) - 2)
    out["weight"] = rng.standard_normal(wshape, dtype=np.float32) / np.sqrt(cin * k ** (len(shape) - 2))
    if op in ("conv", "conv_s2"):
        out["scale"] = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    if op == "deconv":
        out["bias"] = rng.standard_normal(cout, dtype=np.float32)
    return out


def halo_cotangent(case: dict, shape) -> torch.Tensor:
    """The cotangent of a halo case's whole output, of `shape`, float32,
    from the seed."""
    rng = np.random.default_rng(case["seed"] + 1)
    return torch.from_numpy(rng.standard_normal(tuple(shape), dtype=np.float32))


def halo_op(case: dict, x: torch.Tensor, params: Dict[str, torch.Tensor], group=None) -> torch.Tensor:
    """The case's op on x, this rank's block of rows over `group`, or the
    whole input with group None (the unsharded op)."""
    op = case["op"]
    if op == "upsample":
        _, D, H, W = x.shape
        return halo_trilinear_upsample(x, (3 * D, 3 * H, 3 * W), group)
    if op == "deconv":
        return halo_conv_transpose(x, params["weight"], params.get("bias"), group)
    stride = 2 if op == "conv_s2" else 1
    return halo_conv_same(x, params["weight"], None, stride, params.get("scale"), group)


def model_inputs(case: dict) -> tuple:
    """(left, right), (B, H, W, 3) float32 in [0, 1), from the seed."""
    rng = np.random.default_rng(case["seed"])
    H, W = case["size"]
    shape = (case["batch"], H, W, 3)
    return rng.random(shape, dtype=np.float32), rng.random(shape, dtype=np.float32)


def case_config(case: dict):
    """The `ModelConfig` of a model case."""
    return model_config(case["model"], max_disp=case["max_disp"],
                        compute_dtype=case.get("dtype", "float32"))


def _halo_run(case: dict, mesh, device) -> Dict[str, object]:
    group = mesh.space_group
    inputs = {k: torch.from_numpy(v).to(device) for k, v in halo_inputs(case).items()}
    x = inputs.pop("x")
    a, b = row_block(x.shape[-2], group)
    x = x[..., a:b, :].contiguous().requires_grad_()
    out = halo_op(case, x, inputs, group)
    whole = out.shape[:-2] + (out.shape[-2] * mesh.size("space"), out.shape[-1])
    a, b = row_block(whole[-2], group)
    out.backward(halo_cotangent(case, whole)[..., a:b, :].to(device))
    return {"out": out.detach().cpu(), "dx": x.grad.cpu()}


def _model_run(case: dict, mesh, device) -> Dict[str, object]:
    cuda = torch.device(device).type == "cuda"
    state = None
    if case.get("weights"):
        state = torch.load(case["weights"], map_location="cpu", weights_only=True)
    model = build_model(case_config(case), device, seed=case.get("init_seed", 0), state_dict=state,
                        mesh=mesh)
    left, right = model_inputs(case)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    seen: Counter = Counter()
    with recording_shapes(seen):
        reset_launches()
        out = predict(model, left, right)
        if cuda:
            torch.cuda.synchronize()
        launches = read_launches()
    result: Dict[str, object] = {"out": out.cpu(), "launches": launches, "shapes": dict(seen)}
    if cuda:
        result["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        times: List[float] = []
        for _ in range(case.get("reps", 0)):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            predict(model, left, right)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        result["times"] = times
    return result


def run_cases(rank: int, nprocs: int, cases: Sequence[dict], out_dir: str, device: str) -> None:
    """Run every case on this rank, on `device` ("cuda": this rank's card,
    float32 convolutions and products without TF32); see the module
    docstring.  The meshes are built once each, in the cases' order."""
    if device == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    meshes: dict = {}
    for case in cases:
        shape = tuple(case["mesh"])
        if shape not in meshes:
            meshes[shape] = make_mesh(MeshConfig(*shape, 1))
        run = _halo_run if case["kind"] == "halo" else _model_run
        result = run(case, meshes[shape], device)
        torch.save(result, os.path.join(out_dir, f"{case['name']}.{rank}.pt"))
        del result
        if device == "cuda":
            torch.cuda.empty_cache()


def load(case: dict, out_dir: str, nprocs: int) -> List[Dict[str, object]]:
    """Every rank's results of a case, in rank order."""
    return [torch.load(os.path.join(out_dir, f"{case['name']}.{r}.pt"), weights_only=False)
            for r in range(nprocs)]


def gather(case: dict, out_dir: str, nprocs: int, key: str = "out") -> torch.Tensor:
    """A halo case's output ("out") or gradient ("dx"): the blocks of the
    first `data` line's ranks (ranks 0 .. space - 1), joined along H.
    Every `data` line's blocks must be the same bits."""
    parts = [r[key] for r in load(case, out_dir, nprocs)]
    space = case["mesh"][1]
    for r, p in enumerate(parts):
        if not torch.equal(p, parts[r % space]):
            raise AssertionError(f"{case['name']}: rank {r} computed another block than rank {r % space}")
    return torch.cat(parts[:space], dim=-2)
