"""Semi-Global Aggregation: plain PyTorch versions and the CUDA kernel's
wrapper (counterparts of `ganet_tpu/ops/sga.py` and `ops/sga_pallas.py`).

For each direction r the volume is swept along one spatial axis with

    A(p, d) = w0 x(p, d) + w1 A(p-r, d) + w2 A(p-r, d-1) + w3 A(p-r, d+1)
            + w4 max_d' A(p-r, d')

where A = x at the first pixel of the sweep and the d-1/d+1 neighbours are
zero outside [0, D).  The four directions are fused by an elementwise max.
Directions, in order: 0 left->right (+W), 1 right->left (-W),
2 top->bottom (+H), 3 bottom->top (-H).

Layouts:
  * public functions take the JAX package's layout: x (B, D, H, W, C),
    weights (B, H, W, C, 5) for a sweep and (B, H, W, C, 4, 5) for `sga`;
  * the `*_ncdhw` functions take the model's layout, x (B, C, D, H, W) and
    weights (B, C, 4, 5, H, W), which the kernel reads directly as
    (N = B*C, D, H, W) without a transpose.

The plain versions carry the recurrence in float32 (float64 for a float64
input) and round each sweep's output to the input dtype, as the kernel does.

Gradients.  `sga_ncdhw` is differentiable.  Where a gradient is wanted it
runs `SGAFunction`: the four sweeps are kept apart, fused by the JAX
package's max tree max(max(A0, A1), max(A2, A3)) (ties split the gradient
evenly, as `jnp.maximum` does), and each direction's gradient goes through
the reverse sweep (K3, `csrc/sga_bwd.cu`, or its plain version
`sga_sweep_bwd_plain`).  Without a gradient the fused in-place max of four
forward launches runs and no directional volume is kept.

Seeded sweeps.  The H-sharded wavefront (`ganet_tpu_torch/parallel/
sharded_sga.py`) runs each vertical sweep chunk by chunk with the carry
entering the first step taken from the upstream shard: K5
(`csrc/sga_fwd_seeded.cu`, `sga_sweep_seeded_kernel`) and its gradient K6
(`csrc/sga_bwd_seeded.cu`, `sga_sweep_bwd_seeded_kernel`, which also
returns the seed's cotangent), each on a column window of the volume;
`SeededSweep` pairs them for one whole sweep.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ganet_tpu_torch.ops import _build
from ganet_tpu_torch.ops.normalize import at_least_f32

# (axis, reverse) of each direction, in the order above.
DIRECTIONS = (("w", False), ("w", True), ("h", False), ("h", True))

# The largest D that one launch of K1, K3, K5 or K6 takes: 16 lanes x 32
# bins a column along H, 32 x 16 along W.  It equals `sga_sweep_max_d`,
# `sga_sweep_bwd_max_d`, `sga_sweep_fwd_seeded_max_d` and
# `sga_sweep_bwd_seeded_max_d` of the kernels' libraries (a `gpu` test holds
# them to it).  The model's SGA volume has D = max_disp / 3, so it caps
# max_disp at 3 * SGA_MAX_D on the kernels (`entry.build_model` checks).
SGA_MAX_D = 512
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def sga_sweep_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    axis: str,
    reverse: bool,
    initial: torch.Tensor | None = None,
    initial_valid: bool = True,
) -> torch.Tensor:
    """Plain version of `sga_sweep_kernel`, on its layout: x (N, D, H, W),
    w (N, 5, H, W) -> float32 (N, D, H, W).

    `initial` (N, D, M), M the axis across the sweep, is the carry entering
    the sweep's first step (the seeded sweep of the H-sharded wavefront,
    K5): with it and `initial_valid`, the first step is a full recurrence
    step from the seed; with `initial_valid` False the first step copies x
    and the seed is ignored (the pipeline's head shard)."""
    if axis not in ("h", "w"):
        raise ValueError(f"axis must be 'h' or 'w', got {axis!r}")
    dim = 2 if axis == "h" else 3
    xf, wf = at_least_f32(x), at_least_f32(w)
    out = torch.empty_like(xf)
    steps = range(x.shape[dim] - 1, -1, -1) if reverse else range(x.shape[dim])
    prev = at_least_f32(initial) if initial is not None and initial_valid else None
    for l in steps:
        xt = xf.select(dim, l)  # (N, D, M)
        if prev is None:
            cur = xt
        else:
            wt = wf.select(dim, l)  # (N, 5, M)
            w0, w1, w2, w3, w4 = (wt[:, k : k + 1] for k in range(5))
            prev_dm1 = F.pad(prev[:, :-1], (0, 0, 1, 0))
            prev_dp1 = F.pad(prev[:, 1:], (0, 0, 0, 1))
            pmax = torch.amax(prev, dim=1, keepdim=True)
            cur = w0 * xt + w1 * prev + w2 * prev_dm1 + w3 * prev_dp1 + w4 * pmax
        out.select(dim, l).copy_(cur)
        prev = cur
    return out


def sga_sweep_bwd_plain(
    x: torch.Tensor,
    w: torch.Tensor,
    a: torch.Tensor,
    gbar: torch.Tensor,
    axis: str,
    reverse: bool,
    seed: torch.Tensor | None = None,
    valid: bool = True,
    dboundary: torch.Tensor | None = None,
):
    """Plain version of `sga_sweep_bwd_kernel`: the gradient of one sweep,
    written out as the transposed recurrence (not autograd of the forward).

    x (N, D, H, W), w (N, 5, H, W), a the sweep's output A and gbar its
    cotangent, both (N, D, H, W) -> (dx in x's dtype, dw in w's dtype).
    Walking the sweep backwards with a float32 carry c (zero at the start):

        g     = gbar[l] + c
        dx[l] = w0 g                       (g at the sweep's first step)
        dw[l] = (sum_d g x, sum_d g A', sum_d g A'(d-1), sum_d g A'(d+1),
                 (sum_d g) max_d A')       (0 at the sweep's first step)
        c     = w1 g + w2 g(d+1) + w3 g(d-1) + w4 (sum_d g) e
                                           (0 after the sweep's first step)

    where A' is A at the previous position of the sweep and e is the
    indicator of argmax_d A', divided by the number of tied maxima.

    Seeded sweep (plain version of `sga_sweep_bwd_seeded_kernel`, K6): with
    `seed` (N, D, M) the function returns (dx, dw, dseed).  With `valid`
    the first step is a full step whose A' is the seed, and dseed, float32,
    is the carry after it; with `valid` False the first step is the copy
    step above and dseed is 0.  `dboundary` (N, D, M), when given, is the
    cotangent of the sweep's last row sent downstream: the carry starts at
    it instead of 0.
    """
    if axis not in ("h", "w"):
        raise ValueError(f"axis must be 'h' or 'w', got {axis!r}")
    dim = 2 if axis == "h" else 3
    xf, wf, af, gf = (at_least_f32(t) for t in (x, w, a, gbar))
    dx = torch.empty_like(xf)
    dw = torch.zeros_like(wf)
    L = x.shape[dim]
    first = L - 1 if reverse else 0
    seeded = seed is not None and valid
    back = range(L) if reverse else range(L - 1, -1, -1)  # opposite to the sweep
    c = torch.zeros_like(xf.select(dim, 0))  # (N, D, M)
    if dboundary is not None:
        c = c + at_least_f32(dboundary)
    for l in back:
        g = gf.select(dim, l) + c
        if l == first and not seeded:
            dx.select(dim, l).copy_(g)
            c = torch.zeros_like(c)
            break
        wt = wf.select(dim, l)  # (N, 5, M)
        w0, w1, w2, w3, w4 = (wt[:, k : k + 1] for k in range(5))
        ap = at_least_f32(seed) if l == first else af.select(dim, l + 1 if reverse else l - 1)
        ap_dm1 = F.pad(ap[:, :-1], (0, 0, 1, 0))
        ap_dp1 = F.pad(ap[:, 1:], (0, 0, 0, 1))
        ap_max = torch.amax(ap, dim=1, keepdim=True)
        gsum = g.sum(dim=1, keepdim=True)
        dx.select(dim, l).copy_(w0 * g)
        dw.select(dim, l).copy_(
            torch.cat(
                [
                    (g * xf.select(dim, l)).sum(dim=1, keepdim=True),
                    (g * ap).sum(dim=1, keepdim=True),
                    (g * ap_dm1).sum(dim=1, keepdim=True),
                    (g * ap_dp1).sum(dim=1, keepdim=True),
                    gsum * ap_max,
                ],
                dim=1,
            )
        )
        eq = (ap == ap_max).to(g.dtype)
        eq = eq / torch.clamp_min(eq.sum(dim=1, keepdim=True), 1.0)
        g_up = F.pad(g[:, 1:], (0, 0, 0, 1))  # g(d+1)
        g_dn = F.pad(g[:, :-1], (0, 0, 1, 0))  # g(d-1)
        c = w1 * g + w2 * g_up + w3 * g_dn + w4 * gsum * eq
    if seed is None:
        return dx.to(x.dtype), dw.to(w.dtype)
    return dx.to(x.dtype), dw.to(w.dtype), c


def max_tree(a: list[torch.Tensor]) -> torch.Tensor:
    """max(max(a0, a1), max(a2, a3)): the JAX package's fusion of the four
    directions, whose order decides how a tie splits the gradient."""
    return torch.maximum(torch.maximum(a[0], a[1]), torch.maximum(a[2], a[3]))


def _tie_share(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """d max(a, b) / d a with ties split evenly: 1, 1/2 or 0."""
    return (a > b).to(a.dtype) + 0.5 * (a == b).to(a.dtype)


def max_tree_bwd(a: list[torch.Tensor], g: torch.Tensor) -> list[torch.Tensor]:
    """The cotangent of `max_tree` for each of its four inputs."""
    m01, m23 = torch.maximum(a[0], a[1]), torch.maximum(a[2], a[3])
    g01, g23 = g * _tie_share(m01, m23), g * _tie_share(m23, m01)
    return [
        g01 * _tie_share(a[0], a[1]),
        g01 * _tie_share(a[1], a[0]),
        g23 * _tie_share(a[2], a[3]),
        g23 * _tie_share(a[3], a[2]),
    ]


def sga_reference_ncdhw(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain SGA on the model's layout: x (B, C, D, H, W), w (B, C, 4, 5, H, W).
    Differentiable by autograd; the max over directions is `max_tree`."""
    B, C, D, H, W = x.shape
    xn = x.reshape(B * C, D, H, W)
    wn = w.reshape(B * C, 4, 5, H, W)
    a = [
        sga_sweep_plain(xn, wn[:, direction], axis, reverse).to(x.dtype)
        for direction, (axis, reverse) in enumerate(DIRECTIONS)
    ]
    return max_tree(a).reshape(B, C, D, H, W)


def sga_sweep_reference(
    x: torch.Tensor, w: torch.Tensor, axis: str, reverse: bool
) -> torch.Tensor:
    """One directional sweep: x (B, D, H, W, C), w (B, H, W, C, 5)."""
    B, D, H, W, C = x.shape
    xn = x.permute(0, 4, 1, 2, 3).reshape(B * C, D, H, W)
    wn = w.permute(0, 3, 4, 1, 2).reshape(B * C, 5, H, W)
    out = sga_sweep_plain(xn, wn, axis, reverse).to(x.dtype)
    return out.reshape(B, C, D, H, W).permute(0, 2, 3, 4, 1)


def sga_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Full SGA: x (B, D, H, W, C), w (B, H, W, C, 4, 5); max over the four
    directional sweeps."""
    if w.shape[-2:] != (4, 5):
        raise ValueError(f"weights must end in (4, 5), got {tuple(w.shape)}")
    out = sga_reference_ncdhw(
        x.permute(0, 4, 1, 2, 3), w.permute(0, 3, 4, 5, 1, 2)
    )
    return out.permute(0, 2, 3, 4, 1)


# ---------------------------------------------------------------------------
# CUDA kernel (csrc/sga_fwd.cu)
# ---------------------------------------------------------------------------


def weight_slot(w: torch.Tensor, x: torch.Tensor, direction: int | None) -> tuple[int, int]:
    """Where one direction's weights lie in w, for a kernel launch on the
    (N, D, H, W) volume x: (offset of the first element, stride between
    consecutive n), in elements.  w is (N, 5, H, W) with `direction` None,
    or (N, 4, 5, H, W) with `direction` selecting the set."""
    N, _, H, W = x.shape
    if direction is None:
        if tuple(w.shape) != (N, 5, H, W):
            raise ValueError(f"weights {tuple(w.shape)} do not match x {tuple(x.shape)}")
        return 0, 5 * H * W
    if tuple(w.shape) != (N, 4, 5, H, W) or not 0 <= direction < 4:
        raise ValueError(f"weights {tuple(w.shape)} do not match x {tuple(x.shape)}")
    return direction * 5 * H * W, 20 * H * W


# The fields of a `*_describe` entry of the SGA kernels' libraries.
DESCRIBE_KEYS = ("vectorised", "registers", "shared_bytes", "local_bytes", "lanes", "bins",
                 "steps", "stages", "warps", "blocks")


def _describe(loader, symbol: str, layout: str, x, w, axis: str, direction, accumulate: bool) -> dict:
    """Call the describe entry `symbol` of a kernel library: each of its
    pointer arguments is x's (`layout` letter "x") or w's at `direction`'s
    weights ("w"), then the shape, axis, accumulate, stride and dtype."""
    if not x.is_cuda:
        raise ValueError(f"{symbol} describes a CUDA launch, got {x.device}")
    if axis not in ("h", "w"):
        raise ValueError(f"axis must be 'h' or 'w', got {axis!r}")
    N, D, H, W = x.shape
    w_offset, w_nstride = weight_slot(w, x, direction)
    ptr = {"x": x.data_ptr(), "w": w.data_ptr() + w_offset * w.element_size()}
    fn = getattr(loader(), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * len(layout) + [ctypes.c_int] * 6
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    info = (ctypes.c_int * 10)()
    status = fn(*(ptr[c] for c in layout), N, D, H, W, int(axis == "w"), int(accumulate),
                w_nstride, _DTYPES[x.dtype], ctypes.addressof(info))
    _build.check(status, symbol)
    return dict(zip(DESCRIBE_KEYS, info))


def _lib() -> ctypes.CDLL:
    lib = _build.load("sga_fwd")
    fn = lib.sga_sweep_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 3
            + [ctypes.c_int] * 7
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        )
        lib.sga_sweep_max_d.restype = ctypes.c_int
        lib.sga_sweep_max_d.argtypes = []
    return lib


def sga_sweep_kernel(
    x: torch.Tensor,
    w: torch.Tensor,
    axis: str,
    reverse: bool,
    *,
    direction: int | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """One launch of the sweep kernel on a CUDA tensor.

    x: (N, D, H, W) contiguous float32 or bfloat16.
    w: (N, 5, H, W), or (N, 4, 5, H, W) with `direction` selecting the set.
    out: when given, the sweep takes max(out, A) in place (the fused
      max over directions); otherwise a new tensor holds A.
    """
    if not x.is_cuda:
        raise ValueError(f"sga_sweep_kernel takes CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"sga kernel takes float32 or bfloat16, got {x.dtype}/{w.dtype}")
    if x.dim() != 4 or not x.is_contiguous() or not w.is_contiguous():
        raise ValueError("sga kernel takes a contiguous (N, D, H, W) volume and weights")
    N, D, H, W = x.shape
    w_offset, w_nstride = weight_slot(w, x, direction)
    if axis not in ("h", "w"):
        raise ValueError(f"axis must be 'h' or 'w', got {axis!r}")
    if w.device != x.device:
        raise ValueError("x and w must be on one device")
    if D > SGA_MAX_D:
        raise ValueError(f"sga kernel takes D <= {SGA_MAX_D}, got {D}")
    lib = _lib()
    accumulate = out is not None
    if accumulate:
        if out.shape != x.shape or out.dtype != x.dtype or not out.is_contiguous():
            raise ValueError("out must match x")
    else:
        out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = lib.sga_sweep_fwd(
            x.data_ptr(),
            w.data_ptr() + w_offset * w.element_size(),
            out.data_ptr(),
            N, D, H, W,
            int(axis == "w"), int(reverse), int(accumulate),
            w_nstride, _DTYPES[x.dtype], stream,
        )
    sga_sweep_kernel.launches += 1
    _build.check(status, "sga_sweep_fwd")
    return out


sga_sweep_kernel.launches = 0


def sga_describe(x: torch.Tensor, w: torch.Tensor, axis: str, direction: int | None = None,
                 accumulate: bool = False) -> dict:
    """What one K1 launch (`sga_sweep_kernel`) on these CUDA tensors runs,
    without launching, from `sga_sweep_fwd_describe`: staging path
    (`vectorised` 1, element-wise 0), registers, shared memory a block,
    local memory a thread (spills), lanes x bins a column, steps a stage,
    stages, warps a block, blocks.  Raises on a CPU tensor."""
    return _describe(_lib, "sga_sweep_fwd_describe", "xwx", x, w, axis, direction, accumulate)


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("sga_bwd")
    fn = lib.sga_sweep_bwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 6
            + [ctypes.c_int] * 7
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        )
        lib.sga_sweep_bwd_max_d.restype = ctypes.c_int
        lib.sga_sweep_bwd_max_d.argtypes = []
    return lib


def sga_sweep_bwd_kernel(
    x: torch.Tensor,
    w: torch.Tensor,
    a: torch.Tensor,
    gbar: torch.Tensor,
    axis: str,
    reverse: bool,
    *,
    direction: int | None = None,
    dx: torch.Tensor | None = None,
    dw: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of the gradient-sweep kernel (K3) on CUDA tensors.

    x, a, gbar: (N, D, H, W) contiguous, one dtype (float32 or bfloat16).
    w: (N, 5, H, W), or (N, 4, 5, H, W) with `direction` selecting the set.
    dx: when given, the launch adds this sweep's dx to it in place (the sum
      over directions); otherwise a new tensor holds it.
    dw: when given (shaped as w), the launch writes this direction's dw
      into it; otherwise a new (N, 5, H, W) tensor holds it.
    Returns (dx, dw).
    """
    if not x.is_cuda:
        raise ValueError(f"sga_sweep_bwd_kernel takes CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (w, a, gbar)):
        raise TypeError(
            f"sga bwd kernel takes float32 or bfloat16, got {x.dtype}/{w.dtype}/{a.dtype}/{gbar.dtype}"
        )
    if x.dim() != 4 or any(not t.is_contiguous() for t in (x, w, a, gbar)):
        raise ValueError("sga bwd kernel takes contiguous (N, D, H, W) volumes and weights")
    if a.shape != x.shape or gbar.shape != x.shape:
        raise ValueError(f"a {tuple(a.shape)} and gbar {tuple(gbar.shape)} must match x {tuple(x.shape)}")
    if any(t.device != x.device for t in (w, a, gbar)):
        raise ValueError("all inputs must be on one device")
    N, D, H, W = x.shape
    w_offset, w_nstride = weight_slot(w, x, direction)
    if axis not in ("h", "w"):
        raise ValueError(f"axis must be 'h' or 'w', got {axis!r}")
    if D > SGA_MAX_D:
        raise ValueError(f"sga bwd kernel takes D <= {SGA_MAX_D}, got {D}")
    lib = _bwd_lib()
    accumulate = dx is not None
    if accumulate:
        if dx.shape != x.shape or dx.dtype != x.dtype or not dx.is_contiguous():
            raise ValueError("dx must match x")
    else:
        dx = torch.empty_like(x)
    if dw is None:
        if direction is not None:
            raise ValueError("with `direction`, pass the (N, 4, 5, H, W) dw to write into")
        dw = torch.empty_like(w)
    elif dw.shape != w.shape or dw.dtype != w.dtype or not dw.is_contiguous():
        raise ValueError("dw must match w")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = lib.sga_sweep_bwd(
            x.data_ptr(),
            w.data_ptr() + w_offset * w.element_size(),
            a.data_ptr(),
            gbar.data_ptr(),
            dx.data_ptr(),
            dw.data_ptr() + w_offset * dw.element_size(),
            N, D, H, W,
            int(axis == "w"), int(reverse), int(accumulate),
            w_nstride, _DTYPES[x.dtype], stream,
        )
    sga_sweep_bwd_kernel.launches += 1
    _build.check(status, "sga_sweep_bwd")
    return dx, dw


sga_sweep_bwd_kernel.launches = 0


def sga_bwd_describe(x: torch.Tensor, w: torch.Tensor, axis: str, direction: int | None = None,
                     accumulate: bool = False) -> dict:
    """What one K3 launch (`sga_sweep_bwd_kernel`) runs, from
    `sga_sweep_bwd_describe`, with `sga_describe`'s fields, for volumes
    (A, gbar, dx) laid out and aligned as x and dw as w.  Raises on a CPU
    tensor."""
    return _describe(_bwd_lib, "sga_sweep_bwd_describe", "xwxxxw", x, w, axis, direction, accumulate)


# ---------------------------------------------------------------------------
# seeded H sweeps of the sharded wavefront (csrc/sga_fwd_seeded.cu, K5, and
# csrc/sga_bwd_seeded.cu, K6)
# ---------------------------------------------------------------------------


def _window(x: torch.Tensor, w: torch.Tensor, direction: int | None, col0: int, cols: int | None):
    """Check a seeded sweep's volume, weights and column window; returns
    (cols, w_offset, w_nstride, this direction's weights as a view)."""
    if x.dim() != 4 or not x.is_contiguous() or not w.is_contiguous():
        raise ValueError("seeded sweep takes a contiguous (N, D, H, W) volume and weights")
    W = x.shape[3]
    w_offset, w_nstride = weight_slot(w, x, direction)
    wd = w if direction is None else w[:, direction]
    cols = W - col0 if cols is None else cols
    if not (0 <= col0 and 0 < cols and col0 + cols <= W):
        raise ValueError(f"column window [{col0}, {col0 + cols}) is not inside W={W}")
    if w.device != x.device or w.dtype != x.dtype:
        raise ValueError("x and w must share a device and a dtype")
    return cols, w_offset, w_nstride, wd


def _row(t: torch.Tensor | None, like: torch.Tensor, cols: int, dtype, name: str) -> None:
    """Check a boundary row (N, D, cols)."""
    N, D = like.shape[:2]
    if t is None:
        return
    if tuple(t.shape) != (N, D, cols) or t.dtype != dtype or not t.is_contiguous() or t.device != like.device:
        raise ValueError(f"{name} must be a contiguous {dtype} ({N}, {D}, {cols}), got "
                         f"{t.dtype} {tuple(t.shape)}")


def sga_sweep_seeded_plain(x, wd, reverse, seed, valid, col0, cols, out):
    """K5's plain version: the seeded sweep along H of x's columns [col0,
    col0 + cols) with this direction's weights wd (N, 5, H, W), written into
    that window of `out`; returns (out, boundary) as
    `sga_sweep_seeded_kernel` does."""
    win = slice(col0, col0 + cols)
    a = sga_sweep_plain(x[..., win], wd[..., win], "h", reverse, seed, valid).to(x.dtype)
    out[..., win] = a
    return out, a[:, :, 0 if reverse else -1].contiguous()


def sga_sweep_bwd_seeded_plain(x, wd, a, gbar, reverse, seed, valid, col0, cols, dboundary, dx, dwd):
    """K6's plain version: adds the gradient of the seeded sweep over the
    window into dx and into dwd (this direction's (N, 5, H, W) slot of dw);
    returns the seed's cotangent, as `sga_sweep_bwd_seeded_kernel` does."""
    N, D = x.shape[:2]
    win = slice(col0, col0 + cols)
    dxk, dwk, dseed = sga_sweep_bwd_plain(
        x[..., win], wd[..., win], a[..., win], gbar[..., win], "h", reverse,
        seed if seed is not None else torch.zeros((N, D, cols), dtype=x.dtype, device=x.device),
        valid, dboundary,
    )
    dx[..., win] += dxk
    dwd[..., win] += dwk
    return dseed


def _fwd_seeded_lib() -> ctypes.CDLL:
    lib = _build.load("sga_fwd_seeded")
    fn = lib.sga_sweep_fwd_seeded
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 5
            + [ctypes.c_int] * 8
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        )
        lib.sga_sweep_fwd_seeded_max_d.restype = ctypes.c_int
        lib.sga_sweep_fwd_seeded_max_d.argtypes = []
    return lib


def sga_sweep_seeded_kernel(
    x: torch.Tensor,
    w: torch.Tensor,
    reverse: bool,
    seed: torch.Tensor | None = None,
    valid: bool = True,
    *,
    direction: int | None = None,
    col0: int = 0,
    cols: int | None = None,
    out: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One seeded sweep along H (K5) over the columns [col0, col0 + cols).

    x: (N, D, H, W) contiguous float32 or bfloat16; w: (N, 5, H, W), or
    (N, 4, 5, H, W) with `direction` selecting the set.  seed: (N, D, cols)
    in x's dtype, the carry entering the first step when `valid`; with
    `valid` False the first step copies x and the seed is not read.
    out: the (N, D, H, W) tensor whose window the sweep writes (a new one
    when None).  Returns (out, boundary): boundary (N, D, cols) in x's
    dtype is A at the sweep's last step, the row the next shard is seeded
    with.  A CUDA tensor launches the kernel; a CPU tensor runs the plain
    version.
    """
    if x.dtype not in _DTYPES and x.is_cuda:
        raise TypeError(f"seeded sga kernel takes float32 or bfloat16, got {x.dtype}")
    cols, w_offset, w_nstride, wd = _window(x, w, direction, col0, cols)
    valid = bool(valid) and seed is not None
    _row(seed if valid else None, x, cols, x.dtype, "seed")
    if out is None:
        out = torch.empty_like(x)
    elif out.shape != x.shape or out.dtype != x.dtype or not out.is_contiguous():
        raise ValueError("out must match x")
    N, D, H, W = x.shape
    if not x.is_cuda:
        return sga_sweep_seeded_plain(x, wd, reverse, seed, valid, col0, cols, out)
    lib = _fwd_seeded_lib()
    if D > lib.sga_sweep_fwd_seeded_max_d():
        raise ValueError(f"seeded sga kernel takes D <= {lib.sga_sweep_fwd_seeded_max_d()}, got {D}")
    boundary = torch.empty((N, D, cols), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = lib.sga_sweep_fwd_seeded(
            x.data_ptr(),
            w.data_ptr() + w_offset * w.element_size(),
            seed.data_ptr() if valid else None,
            out.data_ptr(),
            boundary.data_ptr(),
            N, D, H, W, col0, cols, int(reverse), int(valid),
            w_nstride, _DTYPES[x.dtype], stream,
        )
    sga_sweep_seeded_kernel.launches += 1
    _build.check(status, "sga_sweep_fwd_seeded")
    return out, boundary


sga_sweep_seeded_kernel.launches = 0


def _bwd_seeded_lib() -> ctypes.CDLL:
    lib = _build.load("sga_bwd_seeded")
    fn = lib.sga_sweep_bwd_seeded
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 9
            + [ctypes.c_int] * 8
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        )
        lib.sga_sweep_bwd_seeded_max_d.restype = ctypes.c_int
        lib.sga_sweep_bwd_seeded_max_d.argtypes = []
    return lib


def sga_sweep_bwd_seeded_kernel(
    x: torch.Tensor,
    w: torch.Tensor,
    a: torch.Tensor,
    gbar: torch.Tensor,
    reverse: bool,
    seed: torch.Tensor | None = None,
    valid: bool = True,
    *,
    direction: int | None = None,
    col0: int = 0,
    cols: int | None = None,
    dboundary: torch.Tensor | None = None,
    dx: torch.Tensor | None = None,
    dw: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of one seeded sweep along H (K6) over the columns
    [col0, col0 + cols).

    x, a (K5's output), gbar: (N, D, H, W) contiguous, one dtype; w as for
    `sga_sweep_seeded_kernel`; seed and valid as given to the forward.
    dboundary: (N, D, cols) float32, the cotangent of the boundary row the
    forward sent downstream (none when None).  dx and dw (shaped as x and
    w): the launch adds this sweep's gradient into them in the window
    (new zero tensors when None).  Returns (dx, dw, dseed): dseed
    (N, D, cols) float32 is the cotangent of the seed (0 when not `valid`).
    A CUDA tensor launches the kernel; a CPU tensor runs the plain version.
    """
    if x.is_cuda and (x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in (a, gbar))):
        raise TypeError(f"seeded sga bwd kernel takes float32 or bfloat16, got {x.dtype}/{a.dtype}/{gbar.dtype}")
    cols, w_offset, w_nstride, wd = _window(x, w, direction, col0, cols)
    if a.shape != x.shape or gbar.shape != x.shape or not a.is_contiguous() or not gbar.is_contiguous():
        raise ValueError(f"a {tuple(a.shape)} and gbar {tuple(gbar.shape)} must be contiguous as x {tuple(x.shape)}")
    if any(t.device != x.device for t in (a, gbar)):
        raise ValueError("all inputs must be on one device")
    valid = bool(valid) and seed is not None
    _row(seed if valid else None, x, cols, x.dtype, "seed")
    _row(dboundary, x, cols, torch.promote_types(x.dtype, torch.float32), "dboundary")
    if dx is None:
        dx = torch.zeros_like(x)
    elif dx.shape != x.shape or dx.dtype != x.dtype or not dx.is_contiguous():
        raise ValueError("dx must match x")
    if dw is None:
        dw = torch.zeros_like(w)
    elif dw.shape != w.shape or dw.dtype != w.dtype or not dw.is_contiguous():
        raise ValueError("dw must match w")
    N, D, H, W = x.shape
    if not x.is_cuda:
        dseed = sga_sweep_bwd_seeded_plain(x, wd, a, gbar, reverse, seed, valid, col0, cols,
                                           dboundary, dx, dw if direction is None else dw[:, direction])
        return dx, dw, dseed
    lib = _bwd_seeded_lib()
    if D > lib.sga_sweep_bwd_seeded_max_d():
        raise ValueError(f"seeded sga bwd kernel takes D <= {lib.sga_sweep_bwd_seeded_max_d()}, got {D}")
    dseed = torch.empty((N, D, cols), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = lib.sga_sweep_bwd_seeded(
            x.data_ptr(),
            w.data_ptr() + w_offset * w.element_size(),
            a.data_ptr(),
            seed.data_ptr() if valid else None,
            gbar.data_ptr(),
            dboundary.data_ptr() if dboundary is not None else None,
            dx.data_ptr(),
            dw.data_ptr() + w_offset * dw.element_size(),
            dseed.data_ptr(),
            N, D, H, W, col0, cols, int(reverse), int(valid),
            w_nstride, _DTYPES[x.dtype], stream,
        )
    sga_sweep_bwd_seeded_kernel.launches += 1
    _build.check(status, "sga_sweep_bwd_seeded")
    return dx, dw, dseed


sga_sweep_bwd_seeded_kernel.launches = 0

# The fields of `sga_fwd_seeded_describe` and `sga_bwd_seeded_describe`:
# DESCRIBE_KEYS and the blocks resident an SM.
SEEDED_DESCRIBE_KEYS = DESCRIBE_KEYS + ("blocks_per_sm",)


def _seeded_describe(loader, symbol: str, layout: str, x, w, seed, direction, col0, cols) -> dict:
    """Call the describe entry `symbol` of a seeded kernel's library: each
    of its pointer arguments is x's (`layout` letter "x"), w's at
    `direction`'s weights ("w"), the seed's ("s"; null for None) or null
    ("0"), then the shape, the window, the weights' stride and the dtype."""
    if not x.is_cuda:
        raise ValueError(f"{symbol} describes a CUDA launch, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{symbol}: the kernel takes float32 or bfloat16, got {x.dtype}")
    cols, w_offset, w_nstride, _ = _window(x, w, direction, col0, cols)
    _row(seed, x, cols, x.dtype, "seed")
    N, D, H, W = x.shape
    fn = getattr(loader(), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * len(layout) + [ctypes.c_int] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    ptr = {"x": x.data_ptr(), "w": w.data_ptr() + w_offset * w.element_size(),
           "s": None if seed is None else seed.data_ptr(), "0": None}
    info = (ctypes.c_int * len(SEEDED_DESCRIBE_KEYS))()
    status = fn(*(ptr[c] for c in layout), N, D, H, W, col0, cols, w_nstride, _DTYPES[x.dtype],
                ctypes.addressof(info))
    _build.check(status, symbol)
    return dict(zip(SEEDED_DESCRIBE_KEYS, info))


def sga_fwd_seeded_describe(
    x: torch.Tensor,
    w: torch.Tensor,
    seed: torch.Tensor | None = None,
    *,
    direction: int | None = None,
    col0: int = 0,
    cols: int | None = None,
) -> dict:
    """What one K5 launch (`sga_sweep_seeded_kernel`) on this window runs,
    without launching, from `sga_sweep_fwd_seeded_describe`: the fields of
    `sga_describe` and `blocks_per_sm`, for an output laid out and aligned
    as x, a new boundary row, and the seed given (None: not `valid`).
    Raises on a CPU tensor."""
    return _seeded_describe(_fwd_seeded_lib, "sga_sweep_fwd_seeded_describe", "xwsx0", x, w, seed,
                            direction, col0, cols)


def sga_bwd_seeded_describe(
    x: torch.Tensor,
    w: torch.Tensor,
    seed: torch.Tensor | None = None,
    *,
    direction: int | None = None,
    col0: int = 0,
    cols: int | None = None,
) -> dict:
    """What one K6 launch (`sga_sweep_bwd_seeded_kernel`) on this window
    runs, without launching, from `sga_sweep_bwd_seeded_describe`: the
    fields of `sga_describe` and `blocks_per_sm`, for volumes (A, gbar, dx)
    laid out and aligned as x, dw as w, and the seed given (None: not
    `valid`).  Raises on a CPU tensor."""
    return _seeded_describe(_bwd_seeded_lib, "sga_sweep_bwd_seeded_describe", "xwxsxxw", x, w, seed,
                            direction, col0, cols)


class SeededSweep(torch.autograd.Function):
    """One seeded sweep along H with its gradient: x (N, D, H, W),
    w (N, 5, H, W), seed (N, D, W) -> A.  Forward K5, backward K6 (with
    dseed) on CUDA tensors; their plain versions on CPU tensors.  `valid`
    is a Python bool: False runs the copy-x first step (no upstream shard)."""

    @staticmethod
    def forward(ctx, x, w, seed, reverse: bool, valid: bool):
        out, _ = sga_sweep_seeded_kernel(x, w, reverse, seed, valid)
        ctx.reverse, ctx.valid = reverse, valid
        ctx.save_for_backward(x, w, out, seed)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, a, seed = ctx.saved_tensors
        dx, dw, dseed = sga_sweep_bwd_seeded_kernel(
            x, w, a, g.contiguous(), ctx.reverse, seed, ctx.valid
        )
        return dx, dw, None if seed is None else dseed.to(seed.dtype), None, None


class SGAFunction(torch.autograd.Function):
    """SGA with its gradient, on (N, D, H, W) x and (N, 4, 5, H, W) w.

    Forward: four sweeps kept as residuals A0..A3, fused by `max_tree`.
    Backward: the cotangent through the max tree, then one reverse sweep per
    direction; the four dx are summed, each direction's dw fills its slot.
    CUDA tensors launch K1 (without the in-place max) and K3; CPU tensors
    run their plain versions.
    """

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        cuda = x.is_cuda
        a = []
        for direction, (axis, reverse) in enumerate(DIRECTIONS):
            if cuda:
                a.append(sga_sweep_kernel(x, w, axis, reverse, direction=direction))
            else:
                a.append(sga_sweep_plain(x, w[:, direction], axis, reverse).to(x.dtype))
        ctx.save_for_backward(x, w, *a)
        return max_tree(a)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, w, *a = ctx.saved_tensors
        gs = max_tree_bwd(a, g.contiguous())
        if x.is_cuda:
            dx, dw = None, torch.empty_like(w)
            for direction, (axis, reverse) in enumerate(DIRECTIONS):
                dx, _ = sga_sweep_bwd_kernel(
                    x, w, a[direction], gs[direction], axis, reverse,
                    direction=direction, dx=dx, dw=dw,
                )
            return dx, dw
        dx, dws = None, []
        for direction, (axis, reverse) in enumerate(DIRECTIONS):
            dxk, dwk = sga_sweep_bwd_plain(x, w[:, direction], a[direction], gs[direction], axis, reverse)
            dx = dxk if dx is None else dx + dxk
            dws.append(dwk)
        return dx, torch.stack(dws, dim=1)


def sga_ncdhw(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SGA on the model's layout, x (B, C, D, H, W), w (B, C, 4, 5, H, W).

    Where a gradient is wanted (grad mode on and x or w requiring one):
    `SGAFunction`.  Otherwise, on a CUDA tensor: four launches of the sweep
    kernel, the last three max-accumulating into the first one's output;
    on a CPU tensor: the plain version.
    """
    B, C, D, H, W = x.shape
    if tuple(w.shape) != (B, C, 4, 5, H, W):
        raise ValueError(f"weights {tuple(w.shape)} do not match x {tuple(x.shape)}")
    xn = x.reshape(B * C, D, H, W)
    wn = w.reshape(B * C, 4, 5, H, W)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return SGAFunction.apply(xn, wn).reshape(B, C, D, H, W)
    if x.device.type == "cpu":
        return sga_reference_ncdhw(x, w)
    out = None
    for direction, (axis, reverse) in enumerate(DIRECTIONS):
        out = sga_sweep_kernel(xn, wn, axis, reverse, direction=direction, out=out)
    return out.reshape(B, C, D, H, W)
