"""The port's CUDA kernels against their plain PyTorch versions, on the GPU.

Marked `gpu`: without a CUDA device each test skips.  This file imports no
JAX, so it also runs where only PyTorch is installed:

    python3 -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Tolerances: float32 within 1e-5 abs + 1e-5 rel (the kernels sum the same
terms in another order, with FMA contraction); the gradient kernels, whose
sums over D (dw, dg) and float32 carry run up to a few hundred terms,
within 1e-5 max|ref| + 1e-5 rel.  bfloat16 against the plain version on
the same bf16 inputs, which sums in float32 and rounds where the kernel
rounds: within one bf16 ulp of the value (2^-7 |ref|) plus 2^-9 max|ref|
for a rounding difference that an earlier pass hands on.
"""

import pytest
import torch

from ganet_tpu_torch.ops import lga as G
from ganet_tpu_torch.ops import sga as S
from ganet_tpu_torch.ops.normalize import l1_normalize

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, ref, summed=False):
    assert got.dtype == ref.dtype and got.shape == ref.shape
    g, r = got.float(), ref.float()
    err = (g - r).abs()
    if got.dtype == torch.float32:
        bound = 1e-5 * (r.abs().max() if summed else 1.0) + 1e-5 * r.abs()
    else:
        bound = 2.0**-7 * r.abs() + 2.0**-9 * r.abs().max()
    assert bool((err <= bound).all()), f"max err {err.max().item():.3e}"


# (N, D, H, W): odd sizes leave partial lane tiles and thread rows idle.
SGA_SHAPES = [(2, 4, 6, 10), (3, 13, 33, 37), (1, 64, 20, 70), (2, 100, 9, 40)]


@pytest.mark.parametrize("shape", SGA_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sga_sweeps_and_fused(cuda, shape, dtype):
    N, D, H, W = shape
    x = torch.randn(shape, device="cuda", generator=cuda).to(dtype)
    w = l1_normalize(torch.randn((N, 4, 5, H, W), device="cuda", generator=cuda), dim=2).to(dtype)
    for direction, (axis, reverse) in enumerate(S.DIRECTIONS):
        got = S.sga_sweep_kernel(x, w, axis, reverse, direction=direction)
        _close(got, S.sga_sweep_plain(x, w[:, direction], axis, reverse).to(dtype))
        one = S.sga_sweep_kernel(x, w[:, direction].contiguous(), axis, reverse)
        assert torch.equal(one, got)
    x5, w5 = x.view(1, N, D, H, W), w.view(1, N, 4, 5, H, W)
    _close(S.sga_ncdhw(x5, w5), S.sga_reference_ncdhw(x5, w5))


# K1's staging: D across the splits of its bins over lanes (1, 2, 16, 33, 64,
# 65, 128, the rung of 8 lanes' 129, 192 and 256, and the top rung's 257,
# 384 and SGA_MAX_D = 512), sweep lengths below, at and one past the H-sweep
# ring (4 steps) and a W-sweep stage (32 steps in float32, 64 in bfloat16;
# 16 and 32 at the top rung), and a prime.  Along H, W = 40 (whole
# copies: vectorised staging) and W = 37 (odd: element-wise staging, with
# the direction's weight offset); along W, the staging is vectorised (4-byte
# units) unless a bfloat16 row is odd.
K1_LENGTHS = (1, 4, 5, 13, 32, 33, 64, 65)
SGA_DS = [1, 2, 16, 33, 64, 65, 128, 129, 192, 256, 257, 384, 512]


def _vectorised(axis, D, W, elem):
    """Whether K1, K3, K5 and K6 stage a sweep by whole copies: 4-byte units
    along W; along H copies of 16 bytes, or of a whole row of a warp's 32/G
    columns where that is less: G lanes a column, 2 up to D = 64, 4 to 128,
    8 to 256 (8-byte bfloat16 rows) and 16 to 512 (8-byte float32 rows,
    4-byte bfloat16)."""
    if axis == "w":
        return (W * elem) % 4 == 0
    lanes = 1 if D <= 8 else 2 if D <= 64 else 4 if D <= 128 else 8 if D <= 256 else 16
    return (W * elem) % min(16, 32 // lanes * elem) == 0


def test_sga_max_d_is_the_kernels(cuda):
    """The Python limit is what the libraries of K1, K3, K5 and K6 report, and
    the wrappers refuse one bin more."""
    assert S._lib().sga_sweep_max_d() == S.SGA_MAX_D
    assert S._bwd_lib().sga_sweep_bwd_max_d() == S.SGA_MAX_D
    assert S._fwd_seeded_lib().sga_sweep_fwd_seeded_max_d() == S.SGA_MAX_D
    assert S._bwd_seeded_lib().sga_sweep_bwd_seeded_max_d() == S.SGA_MAX_D
    D = S.SGA_MAX_D + 1
    x = torch.zeros((1, D, 2, 8), device="cuda")
    w = torch.zeros((1, 5, 2, 8), device="cuda")
    with pytest.raises(ValueError, match=str(S.SGA_MAX_D)):
        S.sga_sweep_kernel(x, w, "h", False)
    with pytest.raises(ValueError, match=str(S.SGA_MAX_D)):
        S.sga_sweep_bwd_kernel(x, w, x, x, "h", False)


@pytest.mark.parametrize("D", SGA_DS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sga_sweep_kernel_staging(cuda, D, dtype):
    N = 2
    for axis in ("h", "w"):
        for L in K1_LENGTHS:
            for across in (40, 37):
                H, W = (L, across) if axis == "h" else (across, L)
                x = torch.randn((N, D, H, W), device="cuda", generator=cuda).to(dtype)
                w = l1_normalize(torch.randn((N, 4, 5, H, W), device="cuda", generator=cuda), dim=2).to(dtype)
                prev = torch.randn((N, D, H, W), device="cuda", generator=cuda).to(dtype)
                vec = _vectorised(axis, D, W, x.element_size())
                for direction, (ax, reverse) in enumerate(S.DIRECTIONS):
                    if ax != axis:
                        continue
                    for accumulate in (False, True):
                        info = S.sga_describe(x, w, axis, direction, accumulate)
                        assert info["vectorised"] == int(vec) and info["local_bytes"] == 0, info
                    ref = S.sga_sweep_plain(x, w[:, direction], axis, reverse).to(dtype)
                    got = S.sga_sweep_kernel(x, w, axis, reverse, direction=direction)
                    _close(got, ref)
                    assert torch.equal(S.sga_sweep_kernel(x, w[:, direction].contiguous(), axis, reverse), got)
                    acc = S.sga_sweep_kernel(x, w, axis, reverse, direction=direction, out=prev.clone())
                    _close(acc, torch.maximum(prev, ref))


@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("repeats", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lga(cuda, radius, repeats, dtype):
    B, D, H, W = 2, 11, 19, 45  # ragged 8x32 tiles, D not a multiple of anything
    K = 2 * radius + 1
    x = torch.randn((B, D, H, W), device="cuda", generator=cuda).to(dtype)
    g = l1_normalize(torch.randn((B, 3 * K * K, H, W), device="cuda", generator=cuda), dim=1).to(dtype)
    _close(G.lga_nchw(x, g, radius, repeats), G.lga_reference_nchw(x, g, radius, repeats))


def test_lga_single_bin(cuda):
    x = torch.randn((1, 1, 8, 8), device="cuda", generator=cuda)
    g = l1_normalize(torch.randn((1, 75, 8, 8), device="cuda", generator=cuda), dim=1)
    _close(G.lga_kernel(x, g, 2), G.lga_reference_nchw(x, g, 2, 1))


# K2 walks D in chunks of 4 slices: D below, at and past one and two chunks.
@pytest.mark.parametrize("D", [1, 2, 3, 4, 5, 7, 8, 9, 13])
@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lga_kernel_across_chunk_edges(cuda, D, radius, dtype):
    """Ragged 8x32 tiles with an odd H*W (19x45, B = 2), and H below the
    stencil with an odd W (3x37)."""
    for B, H, W in ((2, 19, 45), (1, 3, 37)):
        x, g, _ = _lga_bwd_inputs(cuda, (B, D, H, W), radius, dtype)
        _close(G.lga_kernel(x, g, radius), G.lga_reference_nchw(x, g, radius, 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lga_kernel_on_offset_views(cuda, dtype):
    """x as a contiguous view one element into its storage, with an odd
    H*W: in bfloat16 every other slice starts in the high half of a
    4-byte word.  The result equals the aligned launch bit for bit."""
    shape = (2, 9, 15, 37)
    for radius in (1, 2):
        x0, g, _ = _lga_bwd_inputs(cuda, shape, radius, dtype)
        x = torch.empty(x0.numel() + 1, device="cuda", dtype=dtype)[1:].view(shape).copy_(x0)
        got = G.lga_kernel(x, g, radius)
        assert torch.equal(got, G.lga_kernel(x0, g, radius))
        _close(got, G.lga_reference_nchw(x0, g, radius, 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lga_kernel_is_deterministic(cuda, dtype):
    """K2 sums in a fixed order with no atomics: two launches agree bit for bit."""
    for radius in (1, 2):
        x, g, _ = _lga_bwd_inputs(cuda, (2, 37, 21, 70), radius, dtype)
        assert torch.equal(G.lga_kernel(x, g, radius), G.lga_kernel(x, g, radius))


def test_lga_describe_at_the_path_shapes(cuda):
    """K2 at the eval head (1, 192, 576, 960) and the training head
    (2, 192, 240, 528): no local memory, and the two blocks an SM that
    its register budget aims at."""
    for shape in ((1, 192, 576, 960), (2, 192, 240, 528)):
        for dtype in (torch.float32, torch.bfloat16):
            for radius in (1, 2):
                info = G.lga_describe(torch.empty(shape, device="cuda", dtype=dtype), radius)
                assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 2, (shape, info)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.randn((2, 4, 6, 8), device="cuda")
    w = torch.randn((2, 5, 6, 8), device="cuda")
    with pytest.raises(TypeError):
        S.sga_sweep_kernel(x.half(), w.half(), "h", False)
    with pytest.raises(ValueError):
        S.sga_sweep_kernel(x.transpose(2, 3), w, "h", False)
    with pytest.raises(ValueError):
        S.sga_sweep_kernel(x, w[:, :4], "h", False)
    with pytest.raises(ValueError):
        D = S.SGA_MAX_D + 1
        S.sga_sweep_kernel(torch.randn((1, D, 4, 4), device="cuda"), torch.randn((1, 5, 4, 4), device="cuda"), "w", False)
    g = torch.randn((2, 75, 6, 8), device="cuda")
    with pytest.raises(TypeError):
        G.lga_kernel(x, g.bfloat16(), 2)
    with pytest.raises(ValueError):
        G.lga_kernel(x, g, 3)


def test_launch_counts(cuda):
    x = torch.randn((1, 2, 4, 6, 8), device="cuda")
    w = torch.randn((1, 2, 4, 5, 6, 8), device="cuda")
    before = S.sga_sweep_kernel.launches
    S.sga_ncdhw(x, w)
    assert S.sga_sweep_kernel.launches == before + 4
    before = G.lga_kernel.launches
    G.lga_nchw(torch.randn((1, 4, 6, 8), device="cuda"), torch.randn((1, 75, 6, 8), device="cuda"), 2, 2)
    assert G.lga_kernel.launches == before + 2


def test_model_kernels_match_plain(cuda):
    from ganet_tpu_torch import ganet_small
    from ganet_tpu_torch.entry import build_model, predict

    left = torch.rand((1, 48, 96, 3), device="cuda", generator=cuda)
    right = torch.rand((1, 48, 96, 3), device="cuda", generator=cuda)
    outs = [
        predict(build_model(ganet_small(24, impl=impl), device="cuda"), left, right)
        for impl in ("kernel", "torch")
    ]
    assert torch.isfinite(outs[0]).all()
    # float32 noise of the whole forward (about 4e-4 px at this shape on the
    # CPU); the kernels and cuDNN sum in other orders.
    assert (outs[0] - outs[1]).abs().max().item() <= 5e-3


def test_predict_does_not_depend_on_the_input_strides(cuda):
    """A numpy image[None] has a batch stride of 0; the disparity is the
    same bits as for the same values stacked."""
    import numpy as np

    from ganet_tpu_torch import ganet_small
    from ganet_tpu_torch.entry import build_model, predict

    image = np.random.default_rng(0).random((2, 96, 192, 3), dtype=np.float32)
    model = build_model(ganet_small(24, compute_dtype="bfloat16"), device="cuda")
    assert torch.equal(predict(model, image[0][None], image[1][None]),
                       predict(model, np.stack([image[0]]), np.stack([image[1]])))


# (N, D, H, W) of the gradient kernels: D not a multiple of 32 (or of the
# 8 or 16 rows of d), H and W not multiples of the 32 or 16 lanes nor of
# the 8-step chunk of the W sweeps, and the first step of a sweep alone.
SGA_BWD_SHAPES = [(2, 4, 6, 10), (3, 13, 33, 37), (1, 64, 20, 70), (2, 37, 17, 9), (1, 5, 1, 12)]


def _tie_volume(gen, shape, dtype):
    """Values on a coarse grid, so that the argmax over d ties often."""
    return (torch.randint(-3, 4, shape, device="cuda", generator=gen) / 2.0).to(dtype)


@pytest.mark.parametrize("shape", SGA_BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sga_bwd_kernel(cuda, shape, dtype):
    N, D, H, W = shape
    x = _tie_volume(cuda, shape, dtype)
    w = l1_normalize(torch.randn((N, 4, 5, H, W), device="cuda", generator=cuda), dim=2).to(dtype)
    gbar = torch.randn(shape, device="cuda", generator=cuda).to(dtype)
    dw = torch.empty_like(w)
    dx_sum = None
    want_sum = torch.zeros(shape, device="cuda")
    for direction, (axis, reverse) in enumerate(S.DIRECTIONS):
        a = S.sga_sweep_kernel(x, w, axis, reverse, direction=direction)
        wk = w[:, direction].contiguous()
        want_dx, want_dw = S.sga_sweep_bwd_plain(x, wk, a, gbar, axis, reverse)
        got_dx, got_dw = S.sga_sweep_bwd_kernel(x, wk, a, gbar, axis, reverse)
        _close(got_dx, want_dx, summed=True)
        _close(got_dw, want_dw, summed=True)
        dx_sum, _ = S.sga_sweep_bwd_kernel(
            x, w, a, gbar, axis, reverse, direction=direction, dx=dx_sum, dw=dw
        )
        assert torch.equal(dw[:, direction], got_dw)
        want_sum += want_dx.float()
    if dtype == torch.float32:  # in bf16 each in-place add rounds once more
        _close(dx_sum, want_sum, summed=True)


def _bwd_refs(x, w, a, gbar, axis, reverse):
    """The plain gradient sweep on the inputs widened to float32: dx and dw
    before the rounding to x's dtype."""
    return S.sga_sweep_bwd_plain(x.float(), w.float(), a.float(), gbar.float(), axis, reverse)


# K3's staging: D across the splits of its bins over lanes (SGA_DS), sweep lengths
# below, at and past the H-sweep ring and the W-sweep stages (16 to 64
# steps), and a prime; W = 40 and 37 across H sweeps (vectorised and, odd,
# element-wise staging, with the direction's weight offset), H = 40 and 37
# across W sweeps (vectorised unless a bfloat16 row is odd).  Storing with
# the direction's own weights and with the (N, 4, 5, H, W) set, and
# accumulating into a random dx, which the kernel adds in float32 and
# rounds once.
@pytest.mark.parametrize("D", SGA_DS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sga_bwd_kernel_staging(cuda, D, dtype):
    N = 2
    for axis in ("h", "w"):
        for L in K1_LENGTHS:
            for across in (40, 37):
                H, W = (L, across) if axis == "h" else (across, L)
                x = _tie_volume(cuda, (N, D, H, W), dtype)
                w = l1_normalize(torch.randn((N, 4, 5, H, W), device="cuda", generator=cuda), dim=2).to(dtype)
                gbar = torch.randn((N, D, H, W), device="cuda", generator=cuda).to(dtype)
                prev = torch.randn((N, D, H, W), device="cuda", generator=cuda).to(dtype)
                vec = _vectorised(axis, D, W, x.element_size())
                for direction, (ax, reverse) in enumerate(S.DIRECTIONS):
                    if ax != axis:
                        continue
                    for accumulate in (False, True):
                        info = S.sga_bwd_describe(x, w, axis, direction, accumulate)
                        assert info["vectorised"] == int(vec) and info["local_bytes"] == 0, info
                    a = S.sga_sweep_kernel(x, w, axis, reverse, direction=direction)
                    ref_dx, ref_dw = _bwd_refs(x, w[:, direction], a, gbar, axis, reverse)
                    wk = w[:, direction].contiguous()
                    got_dx, got_dw = S.sga_sweep_bwd_kernel(x, wk, a, gbar, axis, reverse)
                    _close(got_dx, ref_dx.to(dtype), summed=True)
                    _close(got_dw, ref_dw.to(dtype), summed=True)
                    dw = torch.zeros_like(w)
                    acc, _ = S.sga_sweep_bwd_kernel(
                        x, w, a, gbar, axis, reverse, direction=direction, dx=prev.clone(), dw=dw)
                    _close(acc, (prev.float() + ref_dx).to(dtype), summed=True)
                    assert torch.equal(dw[:, direction], got_dw)
                    assert not dw[:, [k for k in range(4) if k != direction]].any()


def test_sga_bwd_describe_at_the_training_blocks(cuda):
    """K3 at GANet_deep's training blocks (240x528, batch 2): vectorised
    staging in all 4 directions, storing and accumulating, no local
    memory."""
    for N, D, H, W in ((64, 64, 80, 176), (96, 32, 40, 88)):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.empty((N, D, H, W), device="cuda", dtype=dtype)
            w = torch.empty((N, 4, 5, H, W), device="cuda", dtype=dtype)
            for direction, (axis, _) in enumerate(S.DIRECTIONS):
                for accumulate in (False, True):
                    info = S.sga_bwd_describe(x, w, axis, direction, accumulate)
                    assert info["vectorised"] == 1 and info["local_bytes"] == 0, (N, D, H, W, info)


# (B, D, H, W) of K4: ragged tiles, D = 1 and 2, D not a multiple of the
# 4-slice chunk (13) and a multiple of it (4), H below the stencil (3), W
# = 1 and W = 33 (one column past a tile), odd W (bfloat16 rows start
# unaligned), B = 3, and a 192-slice slab.
LGA_BWD_SHAPES = [(2, 11, 19, 45), (1, 1, 9, 37), (2, 2, 8, 33), (1, 13, 3, 40), (1, 5, 6, 1),
                  (3, 4, 9, 33), (1, 192, 12, 70)]


def _lga_bwd_inputs(gen, shape, radius, dtype):
    B, D, H, W = shape
    K = 2 * radius + 1
    x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    g = l1_normalize(torch.randn((B, 3 * K * K, H, W), device="cuda", generator=gen), dim=1).to(dtype)
    gbar = torch.randn(shape, device="cuda", generator=gen).to(dtype)
    return x, g, gbar


@pytest.mark.parametrize("shape", LGA_BWD_SHAPES)
@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lga_bwd_kernel(cuda, shape, radius, dtype):
    x, g, gbar = _lga_bwd_inputs(cuda, shape, radius, dtype)
    got_dx, got_dg = G.lga_bwd_kernel(x, g, gbar, radius)
    want_dx, want_dg = G.lga_bwd_plain(x, g, gbar, radius)
    _close(got_dx, want_dx, summed=True)
    _close(got_dg, want_dg, summed=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lga_bwd_kernel_on_offset_views(cuda, dtype):
    """x and gbar as contiguous views one element into their storage, with
    an odd H*W: in bfloat16 the rows of every other slice start in the
    high half of a 4-byte word, which K4's copies must find."""
    shape = (2, 9, 15, 37)
    for radius in (1, 2):
        x0, g, gbar0 = _lga_bwd_inputs(cuda, shape, radius, dtype)
        n = x0.numel()
        x = torch.empty(n + 1, device="cuda", dtype=dtype)[1:].view(shape).copy_(x0)
        gbar = torch.empty(n + 1, device="cuda", dtype=dtype)[1:].view(shape).copy_(gbar0)
        got_dx, got_dg = G.lga_bwd_kernel(x, g, gbar, radius)
        want_dx, want_dg = G.lga_bwd_kernel(x0, g, gbar0, radius)
        assert torch.equal(got_dx, want_dx) and torch.equal(got_dg, want_dg)
        _close(got_dx, G.lga_bwd_plain(x0, g, gbar0, radius)[0], summed=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lga_bwd_kernel_is_deterministic(cuda, dtype):
    """K4 sums in a fixed order with no atomics: two launches agree bit for bit."""
    for radius in (1, 2):
        x, g, gbar = _lga_bwd_inputs(cuda, (2, 37, 21, 70), radius, dtype)
        dx1, dg1 = G.lga_bwd_kernel(x, g, gbar, radius)
        dx2, dg2 = G.lga_bwd_kernel(x, g, gbar, radius)
        assert torch.equal(dx1, dx2) and torch.equal(dg1, dg2)


def test_lga_bwd_describe_at_the_path_shapes(cuda):
    """K4 at the training head (2, 192, 240, 528) and the `lga3d` fold
    (64, 64, 80, 176): no local memory, and at least one block an SM."""
    for shape in ((2, 192, 240, 528), (64, 64, 80, 176)):
        for dtype in (torch.float32, torch.bfloat16):
            for radius in (1, 2):
                info = G.lga_bwd_describe(torch.empty(shape, device="cuda", dtype=dtype), radius)
                assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 1, (shape, info)


@pytest.mark.parametrize("op", ["sga", "lga"])
def test_gradient_flows_through_the_kernels(cuda, op):
    """A CUDA input that requires grad gets, through `dispatch` on the
    kernel route, the gradient of the plain version (autograd of the plain
    forward); the kernel route once returned a tensor with no grad_fn."""
    from ganet_tpu_torch.ops import dispatch

    if op == "sga":
        x = _tie_volume(cuda, (1, 3, 9, 12, 20), torch.float32)
        w = l1_normalize(torch.randn((1, 3, 4, 5, 12, 20), device="cuda", generator=cuda), dim=3)
        fn = dispatch.sga_ncdhw
        args = ()
    else:
        x = torch.randn((2, 7, 12, 40), device="cuda", generator=cuda)
        w = l1_normalize(torch.randn((2, 75, 12, 40), device="cuda", generator=cuda), dim=1)
        fn = dispatch.lga_nchw
        args = (2, 2)
    gout = torch.randn(x.shape, device="cuda", generator=cuda)
    grads = {}
    for impl in ("auto", "torch"):
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        out = fn(xr, wr, *args, impl=impl)
        assert out.grad_fn is not None
        out.backward(gout)
        grads[impl] = (xr.grad, wr.grad)
    for got, want in zip(grads["auto"], grads["torch"]):
        assert got.abs().max() > 0
        _close(got, want, summed=True)


def test_eval_route_fuses_in_place(cuda):
    """Without a gradient, `sga` is four K1 launches max-accumulating into
    one output: no K3 launch and no directional volume kept."""
    x = torch.randn((1, 4, 16, 24, 40), device="cuda", generator=cuda)
    w = torch.randn((1, 4, 4, 5, 24, 40), device="cuda", generator=cuda)
    fwd, bwd = S.sga_sweep_kernel.launches, S.sga_sweep_bwd_kernel.launches
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        out = S.sga_ncdhw(x, w.requires_grad_())
    torch.cuda.synchronize()
    assert out.grad_fn is None
    assert S.sga_sweep_kernel.launches == fwd + 4
    assert S.sga_sweep_bwd_kernel.launches == bwd
    assert torch.cuda.max_memory_allocated() - before <= out.numel() * out.element_size() + 4096


# (N, D, H, W, col0, cols): ragged windows inside wider rows; a walk of one
# step (H = 1); windows of whole copies whose cols is not a multiple of 16,
# and one of 37 columns at an odd col0 (element-wise staging); the upper
# rungs of D (above 128 and above 256), with whole copies and element-wise
# (23 columns at an odd col0, a ragged last tile); at D = 64 a grid of 264
# warps of 16 columns,
# where K5 leaves 4 lanes x 16 bins for 2 x 32.
SEEDED_SHAPES = [(2, 4, 6, 10, 3, 5), (3, 13, 9, 70, 0, 37), (1, 100, 5, 40, 8, 32),
                 (2, 64, 1, 24, 4, 16), (2, 64, 5, 64, 8, 40), (2, 64, 7, 60, 5, 37),
                 (2, 129, 4, 40, 8, 24), (1, 192, 3, 40, 8, 24), (1, 256, 3, 40, 8, 24),
                 (1, 129, 3, 40, 5, 23), (1, 256, 3, 40, 5, 23), (24, 64, 3, 184, 8, 176),
                 (1, 257, 3, 40, 8, 24), (1, 384, 3, 40, 8, 24), (1, 512, 3, 40, 8, 24),
                 (1, 512, 3, 40, 5, 23)]


@pytest.mark.parametrize("shape", SEEDED_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_seeded_sweep_kernels(cuda, shape, dtype):
    """K5 and K6 against their plain versions on a column window, seeded and
    not, forward and reverse; K5's staging path and no local memory; dx and
    dw are added into, dseed is 0 without a seed, and nothing outside the
    window or the direction's slot is written."""
    N, D, H, W, col0, cols = shape
    win = slice(col0, col0 + cols)
    x = torch.randn((N, D, H, W), device="cuda", generator=cuda).to(dtype)
    w = l1_normalize(torch.randn((N, 4, 5, H, W), device="cuda", generator=cuda), dim=2).to(dtype)
    seed = torch.randn((N, D, cols), device="cuda", generator=cuda).to(dtype)
    gbar = torch.randn((N, D, H, W), device="cuda", generator=cuda).to(dtype)
    dbound = torch.randn((N, D, cols), device="cuda", generator=cuda)
    dx0 = torch.randn((N, D, H, W), device="cuda", generator=cuda).to(dtype)
    dw0 = torch.randn((N, 4, 5, H, W), device="cuda", generator=cuda).to(dtype)
    outside = torch.ones((N, 1, H, W), dtype=torch.bool, device="cuda")
    outside[..., win] = False
    # K1's and K3's staging rule along H, and col0 and cols whole copies too.
    vec = all(_vectorised("h", D, n, x.element_size()) for n in (W, col0, cols))
    for direction, reverse in ((2, False), (3, True)):
        for valid in (True, False):
            ref = S.sga_sweep_plain(x[..., win], w[:, direction, ..., win], "h", reverse, seed, valid).to(dtype)
            out, bnd = S.sga_sweep_seeded_kernel(
                x, w, reverse, seed, valid, direction=direction, col0=col0, cols=cols,
                out=torch.zeros_like(x))
            _close(out[..., win].contiguous(), ref)
            _close(bnd, ref[:, :, 0 if reverse else -1].contiguous())
            assert not out[..., :col0].any() and not out[..., col0 + cols:].any()
            for describe in (S.sga_fwd_seeded_describe, S.sga_bwd_seeded_describe):
                info = describe(x, w, seed if valid else None, direction=direction, col0=col0, cols=cols)
                assert info["local_bytes"] == 0, info
                assert info["vectorised"] == int(vec), info
            dx, dw, dseed = S.sga_sweep_bwd_seeded_kernel(
                x, w, out, gbar, reverse, seed, valid, direction=direction, col0=col0, cols=cols,
                dboundary=dbound, dx=dx0.clone(), dw=dw0.clone())
            # The plain version in f32: the kernel adds into the old dx and dw
            # in f32 and rounds once.
            rdx, rdw, rds = S.sga_sweep_bwd_plain(
                x[..., win].float(), w[:, direction, ..., win].float(), out[..., win].float(),
                gbar[..., win].float(), "h", reverse, seed.float(), valid, dbound)
            _close(dx[..., win].contiguous(), (dx0[..., win].float() + rdx).to(dtype), summed=True)
            _close(dw[:, direction, ..., win].contiguous(),
                   (dw0[:, direction, ..., win].float() + rdw).to(dtype), summed=True)
            _close(dseed, rds, summed=True)
            if not valid:
                assert not dseed.any()
            others = [k for k in range(4) if k != direction]
            assert torch.equal(dx.masked_select(outside), dx0.masked_select(outside))
            assert torch.equal(dw[:, direction].masked_select(outside), dw0[:, direction].masked_select(outside))
            assert torch.equal(dw[:, others], dw0[:, others])


@pytest.mark.parametrize("D", [8, 64, 129, 256, 384, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_seeded_sweep_equals_k1_over_the_whole_width(cuda, D, dtype):
    """K5 unseeded over the columns [0, W) runs K1's arithmetic: its output
    equals K1's H sweep bit for bit, in both directions, with whole copies
    (W = 40) and element-wise (W = 37)."""
    for W in (40, 37):
        N, H = 2, 9
        x = torch.randn((N, D, H, W), device="cuda", generator=cuda).to(dtype)
        w = l1_normalize(torch.randn((N, 4, 5, H, W), device="cuda", generator=cuda), dim=2).to(dtype)
        for direction, reverse in ((2, False), (3, True)):
            k1 = S.sga_sweep_kernel(x, w, "h", reverse, direction=direction)
            k5, bnd = S.sga_sweep_seeded_kernel(x, w, reverse, None, False, direction=direction)
            assert torch.equal(k5, k1)
            assert torch.equal(bnd, k1[:, :, 0 if reverse else -1])


def test_seeded_launch_counts(cuda):
    x = torch.randn((2, 4, 6, 10), device="cuda", generator=cuda)
    w = l1_normalize(torch.randn((2, 5, 6, 10), device="cuda", generator=cuda), dim=1)
    S.sga_sweep_seeded_kernel.launches = S.sga_sweep_bwd_seeded_kernel.launches = 0
    a, _ = S.sga_sweep_seeded_kernel(x, w, False)
    S.sga_sweep_bwd_seeded_kernel(x, w, a, torch.ones_like(x), False)
    assert (S.sga_sweep_seeded_kernel.launches, S.sga_sweep_bwd_seeded_kernel.launches) == (1, 1)
    # The plain versions, on CPU tensors, are not counted.
    S.sga_sweep_seeded_kernel(x.cpu(), w.cpu(), False)
    assert S.sga_sweep_seeded_kernel.launches == 1


@pytest.mark.parametrize("C", [1, 2, 5])
@pytest.mark.parametrize("D", [1, 2, 5, 7, 9, 64])
@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lga3d_kernel(cuda, C, D, radius, dtype):
    """K7 on a fold of B*C indices, C reading each guidance: ragged 8x32
    tiles with an odd W and H*W; D = 1 and 2 (no interior chunk of 4
    slices), 5 (one chunk and a ragged end), 7 and 9 (ragged ends) and
    `lga3d`'s 64."""
    B, H, W = 2, 19, 45
    K = 2 * radius + 1
    x = torch.randn((B * C, D, H, W), device="cuda", generator=cuda).to(dtype)
    g = l1_normalize(torch.randn((B, 3 * K * K, H, W), device="cuda", generator=cuda), dim=1).to(dtype)
    _close(G.lga3d_kernel(x, g, radius, C), G.lga3d_fwd_plain(x, g, radius, C).to(dtype))


# (C, H, W): 132 pixel tiles, for which the launch gives each block a group
# of 3 channels, 5 = 3 + 2 leaving a ragged last group and 6 = 3 + 3 not.
WALK_CASES = [(5, 83, 381), (6, 83, 381)]


@pytest.mark.parametrize("case", WALK_CASES)
@pytest.mark.parametrize("D", [1, 3, 4, 6, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lga3d_kernel_walks_channels(cuda, case, D, dtype):
    """The launch gives each block several channels (the describe entry
    says how many), so a block's walk crosses from slice D-1 of one channel
    to slice 0 of the next, at D below one chunk, at a ragged and a whole
    chunk's end; channels of very different scales must each equal K7 run
    on that channel alone and K2 on that channel, bit for bit (K7 sums in
    K2's order)."""
    C, H, W = case
    scales = torch.tensor([1e4, 1e-3, 1.0, 1e2, 3.0, 0.5][:C], device="cuda").view(C, 1, 1, 1)
    x = (torch.randn((C, D, H, W), device="cuda", generator=cuda) * scales).to(dtype)
    g = l1_normalize(torch.randn((1, 75, H, W), device="cuda", generator=cuda), dim=1).to(dtype)
    info = G.lga3d_describe(x, 2, C)
    assert info["group"] > 1 and info["groups"] == -(-C // info["group"]), info
    assert (C % info["group"] != 0) == (C == 5), info
    got = G.lga3d_kernel(x, g, 2, C)
    _close(got, G.lga3d_fwd_plain(x, g, 2, C).to(dtype), summed=True)
    for c in range(C):
        alone = x[c : c + 1].clone()  # its own storage, 4-byte aligned for K7
        assert torch.equal(got[c : c + 1], G.lga3d_kernel(alone, g, 2, 1)), c
        assert torch.equal(got[c : c + 1], G.lga_kernel(alone, g, 2)), c


@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lga3d_kernel_at_gdiv_1_is_k2(cuda, radius, dtype):
    K = 2 * radius + 1
    x = torch.randn((2, 11, 19, 45), device="cuda", generator=cuda).to(dtype)
    g = l1_normalize(torch.randn((2, 3 * K * K, 19, 45), device="cuda", generator=cuda), dim=1).to(dtype)
    assert torch.equal(G.lga3d_kernel(x, g, radius, 1), G.lga_kernel(x, g, radius))


def test_lga3d_describe_at_the_path_shapes(cuda):
    """K7 at `lga3d`'s full-res fold (32, 64, 192, 320) and the training
    crop's (64, 64, 80, 176), 32 channels a guidance: no local memory, the
    two blocks an SM that its register budget aims at, and a grid of
    `groups` groups of at most `group` channels a tile."""
    for shape in ((32, 64, 192, 320), (64, 64, 80, 176)):
        N, _, H, W = shape
        tiles = -(-H // 8) * -(-W // 32) * (N // 32)
        for dtype in (torch.float32, torch.bfloat16):
            for radius in (1, 2):
                info = G.lga3d_describe(torch.empty(shape, device="cuda", dtype=dtype), radius, 32)
                assert info["local_bytes"] == 0 and info["blocks_per_sm"] == 2, (shape, info)
                assert info["groups"] == -(-32 // info["group"]), (shape, info)
                assert info["blocks"] == tiles * info["groups"], (shape, info)


def test_lga3d_gradient_through_dispatch(cuda):
    """`dispatch.lga3d_ncdhw` on CUDA: K7 forward and K4 backward, one each
    per pass and no K2, with the gradient of autograd through the plain
    forward."""
    from ganet_tpu_torch.ops import dispatch

    x = torch.randn((2, 3, 7, 12, 40), device="cuda", generator=cuda)
    g = l1_normalize(torch.randn((2, 75, 12, 40), device="cuda", generator=cuda), dim=1)
    gout = torch.randn(x.shape, device="cuda", generator=cuda)
    grads = {}
    for impl in ("auto", "torch"):
        counts = (G.lga3d_kernel.launches, G.lga_bwd_kernel.launches, G.lga_kernel.launches)
        xr, gr = x.clone().requires_grad_(), g.clone().requires_grad_()
        out = dispatch.lga3d_ncdhw(xr, gr, 2, 2, impl=impl)
        out.backward(gout)
        grads[impl] = (out.detach(), xr.grad, gr.grad)
        now = (G.lga3d_kernel.launches, G.lga_bwd_kernel.launches, G.lga_kernel.launches)
        assert tuple(b - a for a, b in zip(counts, now)) == ((2, 2, 0) if impl == "auto" else (0, 0, 0))
    _close(grads["auto"][0], grads["torch"][0])
    for got, want in zip(grads["auto"][1:], grads["torch"][1:]):
        assert got.abs().max() > 0
        _close(got, want, summed=True)


def test_lga3d_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.randn((4, 3, 6, 8), device="cuda")
    g = torch.randn((2, 75, 6, 8), device="cuda")
    with pytest.raises(TypeError):
        G.lga3d_kernel(x.half(), g.half(), 2, 2)
    with pytest.raises(TypeError):
        G.lga3d_kernel(x, g.bfloat16(), 2, 2)
    with pytest.raises(ValueError):
        G.lga3d_kernel(x, g, 3, 2)
    with pytest.raises(ValueError):
        G.lga3d_kernel(x, g, 2, 3)  # 3 does not divide 4
    with pytest.raises(ValueError):
        G.lga3d_kernel(x, g[:, :27], 2, 2)
    with pytest.raises(ValueError):
        G.lga3d_kernel(x.transpose(2, 3), g, 2, 2)
    odd = torch.randn(x.numel() + 1, device="cuda").bfloat16()[1:].view(x.shape)
    with pytest.raises(ValueError):
        G.lga3d_kernel(odd, g.bfloat16(), 2, 2)


def test_sharded_path_on_one_card(cuda, tmp_path):
    """Sharded SGA (K1, K5 / K3, K6) and LGA (K2 / K4) on 2 ranks that share
    the card over gloo, against the unsharded kernels."""
    from ganet_tpu_torch.parallel import cases as K
    from ganet_tpu_torch.parallel.launch import launch

    cases = [
        dict(name="sga", op="sga", shape=(1, 2, 8, 12, 40), seed=0, chunks=3, grad=True),
        dict(name="lga", op="lga", shape=(1, 8, 12, 20), seed=1, repeats=2, grad=True),
    ]
    launch(K.run_cases, 2, (cases, str(tmp_path), "cuda"), backend="gloo", device="cuda")
    for case in cases:
        res = K.gather(case, str(tmp_path), 2)
        inp = {k: torch.from_numpy(v).cuda() for k, v in K.make_inputs(case).items()}
        x = inp["x"].requires_grad_()
        other = inp["w" if case["op"] == "sga" else "g"].requires_grad_()
        ref = S.sga_ncdhw(x, other) if case["op"] == "sga" else G.lga_nchw(x, other, 2, 2)
        ref.backward(inp["gbar"])
        _close(res["out"].cuda(), ref.detach())
        _close(res["dx"].cuda(), x.grad, summed=True)
        _close(res["dw" if case["op"] == "sga" else "dg"].cuda(), other.grad, summed=True)
        if case["op"] == "sga":
            assert all(c["sga_fwd_seeded"] == 6 and c["sga_bwd_seeded"] == 6 for c in res["launches"])
