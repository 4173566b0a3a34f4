"""Cases of the sharded model of inference (H over `space`, disparity
bins over `disp`), run on every rank of a launch.

    launch(run_cases, N, (cases, out_dir, device), backend=..., device=device)

Each case is a dict:
  name     file stem of the results;
  mesh     (data, space[, disp]): the ranks form the mesh (data, space,
           disp) (`make_mesh`; disp 1 when not given), whose size is the
           launch's N;
  kind     "halo": one op of `parallel/spatial.py` on this rank's block of
           rows, with
             op     "conv" (`halo_conv_same`, 3D, stride 1, with a folded
                    BatchNorm scale), "conv_s2" (the same at stride 2),
                    "conv2d" (2D, stride 1), "deconv"
                    (`halo_conv_transpose`, 3D, with a bias) or
                    "upsample" (`halo_trilinear_upsample`, x3 in D, H, W);
             shape  the whole input's shape, H divisible by `space`
                    and, with `disp` > 1 (3D ops only), D by `disp`;
             seed   of the inputs (`halo_inputs`, numpy float32);
             channels  optional: the `disp` group splits the channels
                    instead of D (channel tensor parallelism): this rank's
                    block of the input's channels, gathered
                    (`channels.gather_channels`), and its block of the
                    output's, both of which `disp` must divide;
             cout   optional: the output channels (default C + 1);
             dtype  optional: of the inputs and the op (default
                    "float32");
           the `data` lines run the same op on the same input;
  kind     "boundary": one of `comm`'s boundary ops over the `disp`
           group, with
             op     "gather" (`gather_blocks` of this rank's block of x
                    along dim 2), "take" (`take_block` of the whole x) or
                    "copy_in" (`copy_in` of the whole x, whose output
                    each rank weighs with its own cotangent),
                    "column_gather" (`column_gather` of this rank's block
                    of x along dim 1, whose output each rank weighs with
                    its own cotangent) or "row_reduce" (`row_reduce` of
                    this rank's own partial, the same cotangent on every
                    rank);
             shape  the whole x's shape, its dims 1 and 2 divisible by
                    `disp`;
             seed   of x and the cotangents (`boundary_inputs`);
             dtype  of x and the cotangents (default "float64");
  kind     "model": the sharded eval forward through `entry.build_model`
           and `entry.predict`, with
             model  preset name, size (H, W), max_disp, batch, dtype,
                    channel_tp (default False);
             weights  optional path of a `state_dict` that every rank
                    loads, else the seeded init `init_seed` (default 0);
             seed   of the input pair (`model_inputs`, numpy float32);
             reps   (CUDA) time that many further forwards;
  kind     "meshless": `GANet(cfg)` without a mesh on every rank of the
           launch's world, each rank on its own input pair (`model_inputs`
           at seed + rank), with model, size, max_disp, batch and dtype as
           for "model" (the seeded init): a model that is not sharded must
           not act on the default world.
Every rank saves `<out_dir>/<name>.<rank>.pt`: for "halo" its block of
the output ("out") and of the gradient of <output, the cotangent
`halo_cotangent`> with respect to x ("dx"), each joined by `gather`; for
"boundary" its output and its gradient of <output, its cotangent> with
respect to its input ("out", "dx"); for
"model" the whole disparity that `predict` returned there ("out"), the
launches of every kernel in that forward ("launches"), the shapes K1, K2
and K5 were launched at ("shapes", as `utils.profiling.recording_shapes`
keys them), the depth (dim 2) of every 3D convolution's and
deconvolution's input in that forward ("depths"), the (input, output) channels of each ("widths"),
and on a CUDA device the
forward's wall time after a barrier up to a synchronize ("times", ms) and
the peak memory ("peak_gib"); for "meshless" its eval disparity ("out")
and, in train mode, the gradient of the sum of its outputs with respect
to every parameter ("grads", by name).
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
from ganet_tpu_torch.parallel import comm
from ganet_tpu_torch.parallel.channels import channel_block, gather_channels
from ganet_tpu_torch.parallel.disparity import disp_block
from ganet_tpu_torch.parallel.dp_cases import mesh_shape
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
    cout = case.get("cout", cin + 1)
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


def halo_op(case: dict, x: torch.Tensor, params: Dict[str, torch.Tensor], group=None,
            disp_group=None, channel_group=None) -> torch.Tensor:
    """The case's op on x, this rank's block of rows over `group` (and of
    D bins over `disp_group`, or of channels over `channel_group`, gathered
    here), or the whole input with all None (the unsharded op)."""
    op = case["op"]
    if op == "upsample":
        _, D, H, W = x.shape
        return halo_trilinear_upsample(x, (3 * D, 3 * H, 3 * W), group)
    if channel_group is not None:
        x = gather_channels([x], channel_group)
    if op == "deconv":
        return halo_conv_transpose(x, params["weight"], params.get("bias"), group, disp_group,
                                   channel_group)
    stride = 2 if op == "conv_s2" else 1
    return halo_conv_same(x, params["weight"], None, stride, params.get("scale"), group, disp_group,
                          channel_group)


def boundary_inputs(case: dict, disp: int) -> Dict[str, np.ndarray]:
    """The whole x of a boundary case and the cotangent of each rank of a
    `disp` line, ["cot"][p], float64, from the seed: the whole output's
    for "gather" (the same on every rank: the output is replicated), that
    of rank p's block for "take", and of rank p's copy of x for
    "copy_in" and "column_gather"; for "row_reduce" also rank p's partial,
    ["parts"][p], and the whole output's cotangent on every rank."""
    rng = np.random.default_rng(case["seed"])
    shape = tuple(case["shape"])
    x = rng.standard_normal(shape)
    if case["op"] == "row_reduce":
        parts = [rng.standard_normal(shape) for _ in range(disp)]
        return {"x": x, "parts": parts, "cot": [rng.standard_normal(shape)] * disp}
    if case["op"] == "gather":
        whole = rng.standard_normal(shape)
        return {"x": x, "cot": [whole] * disp}
    if case["op"] == "take":
        whole = rng.standard_normal(shape)
        return {"x": x, "cot": np.split(whole, disp, axis=2)}
    return {"x": x, "cot": [rng.standard_normal(shape) for _ in range(disp)]}


def model_inputs(case: dict, rank: int = 0) -> tuple:
    """(left, right), (B, H, W, 3) float32 in [0, 1), from the seed plus
    `rank`."""
    rng = np.random.default_rng(case["seed"] + rank)
    H, W = case["size"]
    shape = (case["batch"], H, W, 3)
    return rng.random(shape, dtype=np.float32), rng.random(shape, dtype=np.float32)


def case_config(case: dict):
    """The `ModelConfig` of a model case."""
    return model_config(case["model"], max_disp=case["max_disp"],
                        compute_dtype=case.get("dtype", "float32"),
                        channel_tp=case.get("channel_tp", False))


def _blocks(t: torch.Tensor, mesh, bins: bool, chans: bool = False) -> torch.Tensor:
    """This rank's block of the whole tensor t: its rows over `space` and,
    when `bins`, its D bins (dim 2) over `disp`, or when `chans` its
    channels (dim 1)."""
    a, b = row_block(t.shape[-2], mesh.space_group)
    t = t[..., a:b, :]
    if bins:
        a, b = disp_block(t.shape[2], mesh.disp_group)
        t = t[:, :, a:b]
    if chans:
        a, b = channel_block(t.shape[1], mesh.disp_group)
        t = t[:, a:b]
    return t.contiguous()


def _halo_run(case: dict, mesh, device) -> Dict[str, object]:
    group = mesh.space_group
    split = mesh.size("disp") > 1
    chans = split and case.get("channels", False)
    bins = split and not chans
    dtype = getattr(torch, case.get("dtype", "float32"))
    inputs = {k: torch.from_numpy(v).to(device, dtype) for k, v in halo_inputs(case).items()}
    x = _blocks(inputs.pop("x"), mesh, bins, chans).requires_grad_()
    out = halo_op(case, x, inputs, group, mesh.disp_group if bins else None,
                  mesh.disp_group if chans else None)
    whole = list(out.shape)
    whole[-2] *= mesh.size("space")
    if bins:
        whole[2] *= mesh.size("disp")
    if chans:
        whole[1] *= mesh.size("disp")
    out.backward(_blocks(halo_cotangent(case, whole), mesh, bins, chans).to(device, dtype))
    return {"out": out.detach().cpu(), "dx": x.grad.cpu()}


def _boundary_run(case: dict, mesh, device) -> Dict[str, object]:
    group, p = mesh.disp_group, mesh.index["disp"]
    inputs = boundary_inputs(case, mesh.size("disp"))
    dtype = getattr(torch, case.get("dtype", "float64"))
    x = torch.from_numpy(inputs["x"]).to(device, dtype)
    if case["op"] == "gather":
        a, b = disp_block(x.shape[2], group)
        x = x[:, :, a:b].contiguous().requires_grad_()
        out = comm.gather_blocks(x, 2, group)
    elif case["op"] == "take":
        x.requires_grad_()
        out = comm.take_block(x, 2, group)
    elif case["op"] == "column_gather":
        a, b = channel_block(x.shape[1], group)
        x = x[:, a:b].contiguous().requires_grad_()
        out = comm.column_gather(x, 1, group)
    elif case["op"] == "row_reduce":
        x = torch.from_numpy(inputs["parts"][p]).to(device, dtype).requires_grad_()
        out = comm.row_reduce(x, group)
    else:
        x.requires_grad_()
        out = comm.copy_in(x, group)
    out.backward(torch.from_numpy(inputs["cot"][p]).to(device, dtype))
    return {"out": out.detach().cpu(), "dx": x.grad.cpu()}


class _Depths(torch.overrides.TorchFunctionMode):
    """Records the depth of every 3D convolution's and deconvolution's
    input, and its (input, output) channels."""

    def __init__(self, depths: list, widths: list):
        super().__init__()
        self.depths, self.widths = depths, widths

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.nn.functional.conv3d, torch.nn.functional.conv_transpose3d):
            x, w = args[0], args[1]
            self.depths.append(int(x.shape[2]))
            out = w.shape[0] if func is torch.nn.functional.conv3d else w.shape[1]
            self.widths.append((int(x.shape[1]), int(out)))
        return func(*args, **(kwargs or {}))


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
    depths: List[int] = []
    widths: List[tuple] = []
    with recording_shapes(seen), _Depths(depths, widths):
        reset_launches()
        out = predict(model, left, right)
        if cuda:
            torch.cuda.synchronize()
        launches = read_launches()
    result: Dict[str, object] = {"out": out.cpu(), "launches": launches, "shapes": dict(seen),
                                 "depths": depths, "widths": widths}
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


def meshless_run(case: dict, rank: int, device) -> Dict[str, object]:
    """A meshless case on `rank`'s inputs (see the module docstring); run
    in one process too, as the reference."""
    model = build_model(case_config(case), device, seed=case.get("init_seed", 0))
    left, right = model_inputs(case, rank)
    result: Dict[str, object] = {"out": predict(model, left, right).cpu()}
    model.train()
    sum(o.sum() for o in model(torch.from_numpy(left).to(device),
                               torch.from_numpy(right).to(device))).backward()
    result["grads"] = {n: p.grad.cpu() for n, p in model.named_parameters() if p.grad is not None}
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
        shape = mesh_shape(case)
        if shape not in meshes:
            meshes[shape] = make_mesh(MeshConfig(*shape))
        if case["kind"] == "meshless":
            result = meshless_run(case, rank, device)
        else:
            run = {"halo": _halo_run, "boundary": _boundary_run, "model": _model_run}[case["kind"]]
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
    first `data` index's ranks (ranks 0 .. space x disp - 1), joined along
    D (dim 2) over `disp`, or along the channels (dim 1) for a "channels"
    case, and along H over `space`.  Every `data` index's blocks must be
    the same bits."""
    parts = [r[key] for r in load(case, out_dir, nprocs)]
    _, space, disp = mesh_shape(case)
    plane = space * disp
    for r, p in enumerate(parts):
        if not torch.equal(p, parts[r % plane]):
            raise AssertionError(f"{case['name']}: rank {r} computed another block than rank {r % plane}")
    axis = 1 if case.get("channels") else 2
    rows = [torch.cat(parts[s * disp : (s + 1) * disp], dim=axis) for s in range(space)]
    return torch.cat(rows, dim=-2)
