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
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ganet_tpu_torch.ops import _build
from ganet_tpu_torch.ops.normalize import at_least_f32

# (axis, reverse) of each direction, in the order above.
DIRECTIONS = (("w", False), ("w", True), ("h", False), ("h", True))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def sga_sweep_plain(x: torch.Tensor, w: torch.Tensor, axis: str, reverse: bool) -> torch.Tensor:
    """Plain version of `sga_sweep_kernel`, on its layout: x (N, D, H, W),
    w (N, 5, H, W) -> float32 (N, D, H, W)."""
    if axis not in ("h", "w"):
        raise ValueError(f"axis must be 'h' or 'w', got {axis!r}")
    dim = 2 if axis == "h" else 3
    xf, wf = at_least_f32(x), at_least_f32(w)
    out = torch.empty_like(xf)
    steps = range(x.shape[dim] - 1, -1, -1) if reverse else range(x.shape[dim])
    prev = None
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
) -> tuple[torch.Tensor, torch.Tensor]:
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
    """
    if axis not in ("h", "w"):
        raise ValueError(f"axis must be 'h' or 'w', got {axis!r}")
    dim = 2 if axis == "h" else 3
    xf, wf, af, gf = (at_least_f32(t) for t in (x, w, a, gbar))
    dx = torch.empty_like(xf)
    dw = torch.zeros_like(wf)
    L = x.shape[dim]
    first = L - 1 if reverse else 0
    back = range(L) if reverse else range(L - 1, -1, -1)  # opposite to the sweep
    c = torch.zeros_like(xf.select(dim, 0))  # (N, D, M)
    for l in back:
        g = gf.select(dim, l) + c
        if l == first:
            dx.select(dim, l).copy_(g)
            break
        wt = wf.select(dim, l)  # (N, 5, M)
        w0, w1, w2, w3, w4 = (wt[:, k : k + 1] for k in range(5))
        ap = af.select(dim, l + 1 if reverse else l - 1)
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
    return dx.to(x.dtype), dw.to(w.dtype)


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
    if direction is None:
        if tuple(w.shape) != (N, 5, H, W):
            raise ValueError(f"weights {tuple(w.shape)} do not match x {tuple(x.shape)}")
        w_offset, w_nstride = 0, 5 * H * W
    else:
        if tuple(w.shape) != (N, 4, 5, H, W) or not 0 <= direction < 4:
            raise ValueError(f"weights {tuple(w.shape)} do not match x {tuple(x.shape)}")
        w_offset, w_nstride = direction * 5 * H * W, 20 * H * W
    if axis not in ("h", "w"):
        raise ValueError(f"axis must be 'h' or 'w', got {axis!r}")
    if w.device != x.device:
        raise ValueError("x and w must be on one device")
    lib = _lib()
    if D > lib.sga_sweep_max_d():
        raise ValueError(f"sga kernel takes D <= {lib.sga_sweep_max_d()}, got {D}")
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
    if direction is None:
        if tuple(w.shape) != (N, 5, H, W):
            raise ValueError(f"weights {tuple(w.shape)} do not match x {tuple(x.shape)}")
        w_offset, w_nstride = 0, 5 * H * W
    else:
        if tuple(w.shape) != (N, 4, 5, H, W) or not 0 <= direction < 4:
            raise ValueError(f"weights {tuple(w.shape)} do not match x {tuple(x.shape)}")
        w_offset, w_nstride = direction * 5 * H * W, 20 * H * W
    if axis not in ("h", "w"):
        raise ValueError(f"axis must be 'h' or 'w', got {axis!r}")
    lib = _bwd_lib()
    if D > lib.sga_sweep_bwd_max_d():
        raise ValueError(f"sga bwd kernel takes D <= {lib.sga_sweep_bwd_max_d()}, got {D}")
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
