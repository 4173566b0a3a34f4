"""The port's channel-wise LGA (`lga3d`) against the JAX package's, on the CPU
in float32.

K7's plain version (`lga3d_fwd_plain`, one pass over the channel fold) is
held against the function K7 replaces, JAX's `lga_pallas._lga_once_v1`, run
in interpret mode as the JAX package's own Pallas tests run it, and the
port's `lga3d` routes (plain, and the autograd Function that the CUDA route
takes, here with the plain versions) against JAX's `ops.lga.lga3d` (scan)
and `dispatch.lga3d(impl="pallas")`, forward and gradients (`jax.vjp`).
Guidance is l1-normalised over its 3*K*K channels, as the model feeds it.
Tolerance 1e-5 (rtol and atol): both sides sum 75 float32 terms per output,
in other orders.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganet_tpu.ops import dispatch as j_dispatch
from ganet_tpu.ops import lga_pallas
from ganet_tpu_torch.ops import dispatch
from ganet_tpu_torch.ops import lga as t_lga
from tests.torch_parity import two_torch_threads  # noqa: F401

j_lga = importlib.import_module("ganet_tpu.ops.lga")

TOL = dict(rtol=1e-5, atol=1e-5)
LGA3D_ORACLES = {
    "scan": j_lga.lga3d,
    "pallas": lambda x, g, r, n: j_dispatch.lga3d(x, g, r, n, impl="pallas"),
}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _guidance(rng, shape, axis):
    g = rng.standard_normal(shape).astype(np.float32)
    return g / np.abs(g).sum(axis, keepdims=True)


@pytest.mark.parametrize(
    "shape,radius",
    [((1, 4, 20, 40), 2), ((2, 1, 9, 13), 2), ((1, 3, 33, 130), 2), ((1, 4, 20, 40), 1)],
)
def test_plain_matches_v1_kernel(rng, shape, radius):
    """One pass at gdiv = 1 is the function of `_lga_once_v1` (K7's body
    `_make_fwd_kernel`); the shapes leave ragged 32 x 512 tiles, D = 1, and
    W across a 128-lane halo."""
    B, D, H, W = shape
    K = 2 * radius + 1
    x = rng.standard_normal(shape).astype(np.float32)
    g75 = _guidance(rng, (B, 3 * K * K, H, W), 1)
    want = np.asarray(lga_pallas._lga_once_v1(jnp.asarray(x), jnp.asarray(g75), radius))
    got = t_lga.lga3d_fwd_plain(_t(x), _t(g75), radius, 1)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_plain_fold_matches_v1_on_repeated_guidance(rng):
    """gdiv > 1: fold index n reads guidance n // gdiv, which is v1 on the
    guidance repeated as `dispatch.lga3d` repeats it (`jnp.repeat`)."""
    B, C, D, H, W, radius = 2, 3, 3, 10, 21, 2
    x = rng.standard_normal((B * C, D, H, W)).astype(np.float32)
    g75 = _guidance(rng, (B, 75, H, W), 1)
    want = np.asarray(
        lga_pallas._lga_once_v1(jnp.asarray(x), jnp.repeat(jnp.asarray(g75), C, axis=0), radius)
    )
    got = t_lga.lga3d_fwd_plain(_t(x), _t(g75), radius, C)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# (oracle, C, repeats).  A Pallas-interpret call costs seconds whatever its
# size, so the Pallas oracle (K2 forward, K4 backward on the fold) runs one
# case, with channels; it agrees with the scan in the JAX package's tests.
LGA3D_CASES = [("scan", 1, 1), ("scan", 1, 2), ("scan", 3, 1), ("scan", 3, 2), ("pallas", 3, 1)]


@pytest.mark.parametrize("oracle,C,repeats", LGA3D_CASES)
def test_lga3d_matches_jax(rng, oracle, C, repeats):
    B, D, H, W, radius = 1, 3, 6, 7, 2
    x = rng.standard_normal((B, D, H, W, C)).astype(np.float32)
    g = _guidance(rng, (B, H, W, 75), -1)
    gbar = rng.standard_normal((B, D, H, W, C)).astype(np.float32)
    out, vjp = jax.vjp(
        lambda x_, g_: LGA3D_ORACLES[oracle](x_, g_, radius, repeats), jnp.asarray(x), jnp.asarray(g)
    )
    want_dx, want_dg = (np.asarray(v) for v in vjp(jnp.asarray(gbar)))
    plain = t_lga.lga3d_reference(_t(x), _t(g), radius, repeats)
    np.testing.assert_allclose(plain.numpy(), np.asarray(out), **TOL)
    for impl in ("kernel", "torch"):
        xr, gr = _t(x).requires_grad_(), _t(g).requires_grad_()
        got = dispatch.lga3d(xr, gr, radius, repeats, impl=impl)
        assert got.grad_fn is not None
        got.backward(_t(gbar))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL)
        np.testing.assert_allclose(xr.grad.numpy(), want_dx, **TOL)
        np.testing.assert_allclose(gr.grad.numpy(), want_dg, **TOL)


@pytest.mark.parametrize("radius", [1, 2])
def test_autograd_function_matches_k4_plain_on_the_repeated_guidance(rng, radius):
    """`LGA3dFunction`'s backward is K4 on the fold with the guidance
    repeated, dg summed over each guidance index's channels."""
    B, C, D, H, W = 2, 3, 4, 5, 9
    K = 2 * radius + 1
    x = _t(rng.standard_normal((B * C, D, H, W)))
    g75 = _t(_guidance(rng, (B, 3 * K * K, H, W), 1))
    gbar = _t(rng.standard_normal((B * C, D, H, W)))
    xr, gr = x.clone().requires_grad_(), g75.clone().requires_grad_()
    t_lga.LGA3dFunction.apply(xr, gr, radius, C).backward(gbar)
    dx, dgf = t_lga.lga_bwd_plain(x, g75.repeat_interleave(C, 0), gbar, radius)
    np.testing.assert_allclose(xr.grad.numpy(), dx.numpy(), **TOL)
    want_dg = dgf.view(B, C, 3 * K * K, H, W).sum(1)
    np.testing.assert_allclose(gr.grad.numpy(), want_dg.numpy(), **TOL)


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_fold_boundary_keeps_channels_apart(rng, impl):
    """Channels of very different scales side by side in the fold: slice
    D-1 of one channel and slice 0 of the next are adjacent in memory, and
    `lga3d` must still equal the per-channel `lga`."""
    B, C, D, H, W, radius = 2, 4, 3, 7, 11, 2
    scales = np.array([1e4, 1e-3, 1.0, 1e2], np.float32)
    x = rng.standard_normal((B, C, D, H, W)).astype(np.float32) * scales[None, :, None, None, None]
    g75 = _guidance(rng, (B, 75, H, W), 1)
    got = dispatch.lga3d_ncdhw(_t(x), _t(g75), radius, 2, impl=impl)
    for c in range(C):
        want = dispatch.lga_nchw(_t(x[:, c]), _t(g75), radius, 2, impl=impl)
        np.testing.assert_allclose(got[:, c].numpy(), want.numpy(), rtol=1e-5, atol=1e-5 * scales[c])


def test_layouts_agree(rng):
    """`lga3d` on (B, D, H, W, C) is `lga3d_ncdhw` on (B, C, D, H, W)."""
    B, C, D, H, W = 1, 2, 3, 5, 6
    x = _t(rng.standard_normal((B, D, H, W, C)))
    g = _t(_guidance(rng, (B, H, W, 75), -1))
    want = t_lga.lga3d_ncdhw(x.permute(0, 4, 1, 2, 3), g.permute(0, 3, 1, 2), 2, 2)
    np.testing.assert_allclose(
        t_lga.lga3d(x, g, 2, 2).numpy(), want.permute(0, 2, 3, 4, 1).numpy(), **TOL
    )


def test_kernel_wrapper_refuses_cpu_tensors():
    before = t_lga.lga3d_kernel.launches
    with pytest.raises(ValueError, match="CUDA"):
        t_lga.lga3d_kernel(torch.zeros((2, 4, 6, 8)), torch.zeros((1, 75, 6, 8)), 2, 2)
    assert t_lga.lga3d_kernel.launches == before
