"""Local Guided Aggregation: plain PyTorch version and the CUDA kernel's
wrapper (counterparts of `ganet_tpu/ops/lga.py` and `ops/lga_pallas.py`).

    out(p, d) = sum_{q in 5x5(p)} g0(p, q) x(q, d) + g1(p, q) x(q, d-1)
                                + g2(p, q) x(q, d+1)

with zeros outside the image and outside [0, D).  The 3*K*K guidance
channels are in (k, dy, dx) row-major order, k: 0 -> d, 1 -> d-1,
2 -> d+1, and are normalised by the caller.

Layouts: x is (B, D, H, W) everywhere.  The public functions take the
guidance as (B, H, W, 3*K*K), the JAX package's layout; the `*_nchw`
functions take it as (B, 3*K*K, H, W), the layout the model's guidance
conv emits and the kernel reads.  Sums are float32 (float64 for a float64
input); each pass rounds its output to the input dtype.

Gradients.  Where a gradient is wanted, each pass runs `LGAFunction`, whose
backward is K4 (`csrc/lga_bwd.cu`) on CUDA tensors and its plain version
`lga_bwd_plain` on CPU tensors: dx is the transposed stencil and dg sums
over D in float32 before it is rounded to the guidance dtype.

Channel-wise LGA (`lga3d`, the reference's Lga3dFunction): the same stencil
on every channel of a (B, C, D, H, W) volume, with the guidance shared by
the C channels.  The channels fold into the batch, (B*C, D, H, W), and fold
index n reads guidance n // C.  Its forward is K7 (`csrc/lga3d_fwd.cu`),
which reads each guidance tile once for all the channels a block walks; its
backward is K4 on the fold with the guidance repeated, dg summed over C.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ganet_tpu_torch.ops import _build
from ganet_tpu_torch.ops.normalize import at_least_f32

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lga_once_plain(x: torch.Tensor, g75: torch.Tensor, radius: int) -> torch.Tensor:
    """One pass: x (B, D, H, W), g75 (B, 3*K*K, H, W) -> float32."""
    B, D, H, W = x.shape
    K = 2 * radius + 1
    if g75.shape[1] != 3 * K * K:
        raise ValueError(f"guidance must have {3 * K * K} channels, got {tuple(g75.shape)}")
    r = radius
    xp = F.pad(at_least_f32(x), (r, r, r, r, 1, 1))  # zero halo in W, H and D
    gf = at_least_f32(g75)
    acc = torch.zeros((B, D, H, W), dtype=xp.dtype, device=x.device)
    # filter k reads the padded D slice d + dk: k0 -> d, k1 -> d-1, k2 -> d+1.
    for k, dk in ((0, 1), (1, 0), (2, 2)):
        for iy in range(K):
            for ix in range(K):
                gch = gf[:, k * K * K + iy * K + ix, None]
                acc += gch * xp[:, dk : dk + D, iy : iy + H, ix : ix + W]
    return acc


def lga_bwd_plain(
    x: torch.Tensor, g75: torch.Tensor, gbar: torch.Tensor, radius: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of `lga_bwd_kernel`: the gradient of one pass.

    x, gbar (B, D, H, W); g75 (B, 3*K*K, H, W) -> (dx in x's dtype, dg in
    g75's dtype), with offsets o = (dy, dx) in [-R, R]^2:

        dx(q, e)   = sum_o g0(q-o, o) gbar(q-o, e) + g1(q-o, o) gbar(q-o, e+1)
                                                 + g2(q-o, o) gbar(q-o, e-1)
        dg_k(p, o) = sum_d gbar(p, d) x(p+o, d+delta_k),  delta = 0, -1, +1

    with zeros outside the image and outside [0, D).
    """
    B, D, H, W = x.shape
    K = 2 * radius + 1
    if g75.shape[1] != 3 * K * K:
        raise ValueError(f"guidance must have {3 * K * K} channels, got {tuple(g75.shape)}")
    r = radius
    xp = F.pad(at_least_f32(x), (r, r, r, r, 1, 1))
    bp = F.pad(at_least_f32(gbar), (r, r, r, r, 1, 1))
    gp = F.pad(at_least_f32(g75), (r, r, r, r))
    bf = bp[:, 1 : D + 1, r : r + H, r : r + W]
    dx = torch.zeros((B, D, H, W), dtype=xp.dtype, device=x.device)
    dg = torch.empty((B, 3 * K * K, H, W), dtype=xp.dtype, device=x.device)
    # filter k: x slice d + delta_k (padded index dk), gbar slice e - delta_k (db).
    for k, dk, db in ((0, 1, 1), (1, 0, 2), (2, 2, 0)):
        for iy in range(K):
            for ix in range(K):
                ch = k * K * K + iy * K + ix
                xs = xp[:, dk : dk + D, iy : iy + H, ix : ix + W]
                dg[:, ch] = (bf * xs).sum(dim=1)
                # source pixel q - o lies at padded offset (2r - iy, 2r - ix).
                jy, jx = 2 * r - iy, 2 * r - ix
                gsrc = gp[:, ch, None, jy : jy + H, jx : jx + W]
                dx += gsrc * bp[:, db : db + D, jy : jy + H, jx : jx + W]
    return dx.to(x.dtype), dg.to(g75.dtype)


def lga_reference_nchw(
    x: torch.Tensor, g75: torch.Tensor, radius: int = 2, repeats: int = 1
) -> torch.Tensor:
    for _ in range(repeats):
        x = _lga_once_plain(x, g75, radius).to(x.dtype)
    return x


def lga_reference(
    x: torch.Tensor, g: torch.Tensor, radius: int = 2, repeats: int = 1
) -> torch.Tensor:
    """Plain LGA, `repeats` passes: x (B, D, H, W), g (B, H, W, 3*K*K)."""
    return lga_reference_nchw(x, g.permute(0, 3, 1, 2), radius, repeats)


# ---------------------------------------------------------------------------
# CUDA kernel (csrc/lga_fwd.cu)
# ---------------------------------------------------------------------------


def _lib() -> ctypes.CDLL:
    lib = _build.load("lga_fwd")
    fn = lib.lga_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return lib


def lga_kernel(x: torch.Tensor, g75: torch.Tensor, radius: int) -> torch.Tensor:
    """One launch (one LGA pass) on CUDA tensors: x (B, D, H, W) and
    g75 (B, 3*K*K, H, W), contiguous, both float32 or both bfloat16."""
    if not x.is_cuda:
        raise ValueError(f"lga_kernel takes CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPES or g75.dtype != x.dtype:
        raise TypeError(f"lga kernel takes float32 or bfloat16, got {x.dtype}/{g75.dtype}")
    if radius not in (1, 2):
        raise ValueError(f"lga kernel takes radius 1 or 2, got {radius}")
    if x.dim() != 4 or not x.is_contiguous() or not g75.is_contiguous():
        raise ValueError("lga kernel takes a contiguous (B, D, H, W) volume and guidance")
    B, D, H, W = x.shape
    K = 2 * radius + 1
    if tuple(g75.shape) != (B, 3 * K * K, H, W) or g75.device != x.device:
        raise ValueError(f"guidance {tuple(g75.shape)} does not match x {tuple(x.shape)}")
    lib = _lib()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = lib.lga_fwd(
            x.data_ptr(), g75.data_ptr(), out.data_ptr(),
            B, D, H, W, radius, _DTYPES[x.dtype], stream,
        )
    lga_kernel.launches += 1
    _build.check(status, "lga_fwd")
    return out


lga_kernel.launches = 0


# The fields of `lga_describe` (the C entry `lga_fwd_describe`), in the
# order of its info array.
LGA_FWD_DESCRIBE_KEYS = ("registers", "static_shared_bytes", "dynamic_shared_bytes", "local_bytes",
                         "blocks_per_sm", "threads", "tile_h", "tile_w", "chunk", "blocks")


def lga_describe(x: torch.Tensor, radius: int) -> dict:
    """What one K2 launch (`lga_kernel`) on a volume like x (B, D, H, W)
    runs, without launching: the fields of `LGA_FWD_DESCRIBE_KEYS`, as
    `lga_bwd_describe` gives them for K4.  Raises on a CPU tensor."""
    return _describe("lga_describe", _lib, "lga_fwd_describe", x, radius)


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("lga_bwd")
    fn = lib.lga_bwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    return lib


def lga_bwd_kernel(
    x: torch.Tensor, g75: torch.Tensor, gbar: torch.Tensor, radius: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch (one pass's gradient, K4) on CUDA tensors: x and gbar
    (B, D, H, W), g75 (B, 3*K*K, H, W), contiguous, of one dtype (float32
    or bfloat16).  Returns (dx, dg) in that dtype."""
    if not x.is_cuda:
        raise ValueError(f"lga_bwd_kernel takes CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPES or g75.dtype != x.dtype or gbar.dtype != x.dtype:
        raise TypeError(
            f"lga bwd kernel takes float32 or bfloat16, got {x.dtype}/{g75.dtype}/{gbar.dtype}"
        )
    if radius not in (1, 2):
        raise ValueError(f"lga bwd kernel takes radius 1 or 2, got {radius}")
    if x.dim() != 4 or any(not t.is_contiguous() for t in (x, g75, gbar)):
        raise ValueError("lga bwd kernel takes contiguous (B, D, H, W) volumes and guidance")
    B, D, H, W = x.shape
    K = 2 * radius + 1
    if tuple(g75.shape) != (B, 3 * K * K, H, W) or g75.device != x.device:
        raise ValueError(f"guidance {tuple(g75.shape)} does not match x {tuple(x.shape)}")
    if gbar.shape != x.shape or gbar.device != x.device:
        raise ValueError(f"gbar {tuple(gbar.shape)} does not match x {tuple(x.shape)}")
    lib = _bwd_lib()
    dx = torch.empty_like(x)
    dg = torch.empty_like(g75)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = lib.lga_bwd(
            x.data_ptr(), g75.data_ptr(), gbar.data_ptr(), dx.data_ptr(), dg.data_ptr(),
            B, D, H, W, radius, _DTYPES[x.dtype], stream,
        )
    lga_bwd_kernel.launches += 1
    _build.check(status, "lga_bwd")
    return dx, dg


lga_bwd_kernel.launches = 0


# The fields of `lga_bwd_describe`, in the order of its C entry's info array
# (the same as K2's).
LGA_BWD_DESCRIBE_KEYS = LGA_FWD_DESCRIBE_KEYS


def _describe(name: str, lib, entry: str, x: torch.Tensor, radius: int, *extra: int,
              keys: tuple = LGA_FWD_DESCRIBE_KEYS) -> dict:
    """`name`'s work: call the C entry `entry` (B, D, H, W, *extra, radius,
    dtype, info) of the library `lib()` for a launch on a volume like x,
    without launching; the info array holds `keys`.  Raises on a CPU
    tensor."""
    if not x.is_cuda:
        raise ValueError(f"{name} describes a CUDA launch, got {x.device}")
    if x.dtype not in _DTYPES or x.dim() != 4:
        raise ValueError(f"{name} takes a float32 or bfloat16 (B, D, H, W), got {x.dtype}")
    if radius not in (1, 2):
        raise ValueError(f"{name} takes radius 1 or 2, got {radius}")
    fn = getattr(lib(), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * (6 + len(extra)) + [ctypes.c_void_p]
    info = (ctypes.c_int * len(keys))()
    with torch.cuda.device(x.device):
        status = fn(*x.shape, *extra, radius, _DTYPES[x.dtype], ctypes.addressof(info))
    _build.check(status, entry)
    return dict(zip(keys, info))


def lga_bwd_describe(x: torch.Tensor, radius: int) -> dict:
    """What one K4 launch (`lga_bwd_kernel`) on a volume like x (B, D, H, W)
    runs, without launching: its one kernel's registers a thread, static
    and dynamic shared memory a block, local memory a thread (spills),
    blocks an SM from the occupancy calculator, threads a block, the
    tile, the disparity slices a chunk and the blocks of the grid.
    Raises on a CPU tensor."""
    return _describe("lga_bwd_describe", _bwd_lib, "lga_bwd_describe", x, radius)


class LGAFunction(torch.autograd.Function):
    """One LGA pass with its gradient; residuals (x, g75).  CUDA tensors
    launch K2 and K4, CPU tensors run their plain versions."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, g75: torch.Tensor, radius: int) -> torch.Tensor:
        ctx.radius = radius
        ctx.save_for_backward(x, g75)
        if x.is_cuda:
            return lga_kernel(x, g75, radius)
        return _lga_once_plain(x, g75, radius).to(x.dtype)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, g75 = ctx.saved_tensors
        g = g.contiguous()
        if x.is_cuda:
            dx, dg = lga_bwd_kernel(x, g75, g, ctx.radius)
        else:
            dx, dg = lga_bwd_plain(x, g75, g, ctx.radius)
        return dx, dg, None


def lga_nchw(
    x: torch.Tensor, g75: torch.Tensor, radius: int = 2, repeats: int = 1
) -> torch.Tensor:
    """LGA with guidance (B, 3*K*K, H, W).  Where a gradient is wanted: one
    `LGAFunction` per pass.  Otherwise one kernel launch per pass on a CUDA
    tensor, the plain version on a CPU tensor."""
    if torch.is_grad_enabled() and (x.requires_grad or g75.requires_grad):
        for _ in range(repeats):
            x = LGAFunction.apply(x, g75, radius)
        return x
    if x.device.type == "cpu":
        return lga_reference_nchw(x, g75, radius, repeats)
    for _ in range(repeats):
        x = lga_kernel(x, g75, radius)
    return x


# ---------------------------------------------------------------------------
# Channel-wise LGA (lga3d): CUDA kernel K7 (csrc/lga3d_fwd.cu) on the fold
# ---------------------------------------------------------------------------


def lga3d_fwd_plain(
    x: torch.Tensor, g75: torch.Tensor, radius: int, gdiv: int
) -> torch.Tensor:
    """Plain version of `lga3d_kernel`, one pass over the fold: x
    (N, D, H, W), g75 (N // gdiv, 3*K*K, H, W), fold index n reading
    guidance n // gdiv -> float32."""
    return _lga_once_plain(x, g75.repeat_interleave(gdiv, 0), radius)


def lga3d_reference_ncdhw(
    x: torch.Tensor, g75: torch.Tensor, radius: int = 2, repeats: int = 1
) -> torch.Tensor:
    """Plain channel-wise LGA: x (B, C, D, H, W), g75 (B, 3*K*K, H, W)."""
    B, C, D, H, W = x.shape
    xf = x.reshape(B * C, D, H, W)
    for _ in range(repeats):
        xf = lga3d_fwd_plain(xf, g75, radius, C).to(x.dtype)
    return xf.reshape(B, C, D, H, W)


def lga3d_reference(
    x: torch.Tensor, g: torch.Tensor, radius: int = 2, repeats: int = 1
) -> torch.Tensor:
    """Plain channel-wise LGA on the JAX package's layout: x (B, D, H, W, C),
    g (B, H, W, 3*K*K)."""
    out = lga3d_reference_ncdhw(x.permute(0, 4, 1, 2, 3), g.permute(0, 3, 1, 2), radius, repeats)
    return out.permute(0, 2, 3, 4, 1)


def _lga3d_lib() -> ctypes.CDLL:
    lib = _build.load("lga3d_fwd")
    fn = lib.lga3d_fwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    return lib


def lga3d_kernel(x: torch.Tensor, g75: torch.Tensor, radius: int, gdiv: int) -> torch.Tensor:
    """One launch of K7 (one pass) on CUDA tensors: x (N, D, H, W), 4-byte
    aligned, and g75 (N // gdiv, 3*K*K, H, W), contiguous, both float32 or
    both bfloat16; fold index n reads guidance n // gdiv."""
    if not x.is_cuda:
        raise ValueError(f"lga3d_kernel takes CUDA tensors, got {x.device}")
    if x.dtype not in _DTYPES or g75.dtype != x.dtype:
        raise TypeError(f"lga3d kernel takes float32 or bfloat16, got {x.dtype}/{g75.dtype}")
    if radius not in (1, 2):
        raise ValueError(f"lga3d kernel takes radius 1 or 2, got {radius}")
    if x.dim() != 4 or not x.is_contiguous() or not g75.is_contiguous():
        raise ValueError("lga3d kernel takes a contiguous (N, D, H, W) volume and guidance")
    if x.data_ptr() % 4:
        raise ValueError("lga3d kernel takes a volume whose storage is 4-byte aligned")
    N, D, H, W = x.shape
    K = 2 * radius + 1
    if gdiv < 1 or N % gdiv:
        raise ValueError(f"gdiv {gdiv} does not divide the fold's {N} indices")
    if tuple(g75.shape) != (N // gdiv, 3 * K * K, H, W) or g75.device != x.device:
        raise ValueError(f"guidance {tuple(g75.shape)} does not match x {tuple(x.shape)} / {gdiv}")
    lib = _lga3d_lib()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        status = lib.lga3d_fwd(
            x.data_ptr(), g75.data_ptr(), out.data_ptr(),
            N, D, H, W, gdiv, radius, _DTYPES[x.dtype], stream,
        )
    lga3d_kernel.launches += 1
    _build.check(status, "lga3d_fwd")
    return out


lga3d_kernel.launches = 0


# The fields of `lga3d_describe` (the C entry `lga3d_fwd_describe`): K2's,
# then the channels a block walks and the groups a guidance index has.
LGA3D_FWD_DESCRIBE_KEYS = LGA_FWD_DESCRIBE_KEYS + ("group", "groups")


def lga3d_describe(x: torch.Tensor, radius: int, gdiv: int) -> dict:
    """What one K7 launch (`lga3d_kernel`) on a fold like x (N, D, H, W),
    fold index n reading guidance n // gdiv, runs, without launching: the
    fields of `LGA3D_FWD_DESCRIBE_KEYS`.  Raises on a CPU tensor."""
    if gdiv < 1 or x.shape[0] % gdiv:
        raise ValueError(f"gdiv {gdiv} does not divide the fold's {x.shape[0]} indices")
    return _describe("lga3d_describe", _lga3d_lib, "lga3d_fwd_describe", x, radius, gdiv,
                     keys=LGA3D_FWD_DESCRIBE_KEYS)


class LGA3dFunction(torch.autograd.Function):
    """One channel-wise LGA pass over the fold with its gradient; residuals
    (x, g75).  CUDA tensors launch K7 forward and K4 backward, CPU tensors
    run their plain versions.  The backward repeats the guidance over the
    fold and sums dg over the `gdiv` channels of each guidance index (the
    transpose of the repeat), as JAX's `lga3d` does."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, g75: torch.Tensor, radius: int, gdiv: int) -> torch.Tensor:
        ctx.radius, ctx.gdiv = radius, gdiv
        ctx.save_for_backward(x, g75)
        if x.is_cuda:
            return lga3d_kernel(x, g75, radius, gdiv)
        return lga3d_fwd_plain(x, g75, radius, gdiv).to(x.dtype)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, g75 = ctx.saved_tensors
        g = g.contiguous()
        gf = g75.repeat_interleave(ctx.gdiv, 0)
        if x.is_cuda:
            dx, dgf = lga_bwd_kernel(x, gf, g, ctx.radius)
        else:
            dx, dgf = lga_bwd_plain(x, gf, g, ctx.radius)
        dg = dgf.view(g75.shape[0], ctx.gdiv, *g75.shape[1:]).sum(1)
        return dx, dg, None, None


def lga3d_ncdhw(
    x: torch.Tensor, g75: torch.Tensor, radius: int = 2, repeats: int = 1
) -> torch.Tensor:
    """Channel-wise LGA: x (B, C, D, H, W), g75 (B, 3*K*K, H, W).  The
    channels fold into the batch (a view of a contiguous x).  Where a
    gradient is wanted: one `LGA3dFunction` per pass.  Otherwise one K7
    launch per pass on a CUDA tensor, the plain version on a CPU tensor.
    Each pass rounds to x's dtype."""
    B, C, D, H, W = x.shape
    xf = x.contiguous().view(B * C, D, H, W)
    g75 = g75.contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or g75.requires_grad):
        for _ in range(repeats):
            xf = LGA3dFunction.apply(xf, g75, radius, C)
    elif x.device.type == "cpu":
        return lga3d_reference_ncdhw(x, g75, radius, repeats)
    else:
        for _ in range(repeats):
            xf = lga3d_kernel(xf, g75, radius, C)
    return xf.view(B, C, D, H, W)


def lga3d(
    x: torch.Tensor, g: torch.Tensor, radius: int = 2, repeats: int = 1
) -> torch.Tensor:
    """`lga3d_ncdhw` on the JAX package's layout: x (B, D, H, W, C),
    g (B, H, W, 3*K*K) -> (B, D, H, W, C)."""
    out = lga3d_ncdhw(x.permute(0, 4, 1, 2, 3), g.permute(0, 3, 1, 2), radius, repeats)
    return out.permute(0, 2, 3, 4, 1)
