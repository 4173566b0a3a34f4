"""The seeded SGA sweep of the H-sharded wavefront (the plain versions of K5
and K6, and `SeededSweep`) against the JAX package, on the CPU in float32.

The JAX side is `ganet_tpu.ops.sga.sga_sweep` (the scan oracle) and
`sga_pallas.sga_sweep` (the seeded Pallas kernels in interpret mode), with
`initial` and `initial_valid`, differentiated by `jax.vjp` for dx, dw and
the seed's cotangent.  Inputs are quantised to a grid of 1/2 so that maxima
over d tie, and the seed's maximum ties four ways at every column, so the
first step's argmax splits the gradient four ways.  Tolerance 1e-5 (rtol
and atol): both sides sum in float32, in other orders.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganet_tpu.ops import sga_pallas
from ganet_tpu_torch.ops import sga as t_sga
from tests.torch_parity import two_torch_threads  # noqa: F401

j_sga = importlib.import_module("ganet_tpu.ops.sga")

TOL = dict(rtol=1e-5, atol=1e-5)
ORACLES = {"scan": j_sga.sga_sweep, "pallas": sga_pallas.sga_sweep}
B, D, H, W, C = 1, 5, 6, 7, 2


def _inputs(rng):
    x = (rng.integers(-3, 4, (B, D, H, W, C)) / 2.0).astype(np.float32)
    w = rng.standard_normal((B, H, W, C, 5)).astype(np.float32)
    w /= np.abs(w).sum(-1, keepdims=True)
    seed = (rng.integers(-3, 1, (B, D, W, C)) / 2.0).astype(np.float32)
    seed[:, :4] = 1.0  # four tied maxima over d at every column
    gbar = rng.standard_normal((B, D, H, W, C)).astype(np.float32)
    return x, w, seed, gbar


def _n(a) -> torch.Tensor:
    """(B, D, H, W, C) -> the kernels' (N = B*C, D, H, W)."""
    return torch.from_numpy(np.array(a)).permute(0, 4, 1, 2, 3).reshape(B * C, D, H, W).contiguous()


def _nw(a) -> torch.Tensor:
    """(B, H, W, C, 5) -> (N, 5, H, W)."""
    return torch.from_numpy(np.array(a)).permute(0, 3, 4, 1, 2).reshape(B * C, 5, H, W).contiguous()


def _ns(a) -> torch.Tensor:
    """seed (B, D, W, C) -> (N, D, W)."""
    return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2).reshape(B * C, D, W).contiguous()


@pytest.mark.parametrize("valid", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("oracle", sorted(ORACLES))
def test_seeded_sweep_matches_jax(rng, oracle, reverse, valid):
    x, w, seed, gbar = _inputs(rng)
    sweep = ORACLES[oracle]
    out, vjp = jax.vjp(
        lambda a, b, s: sweep(a, b, "h", reverse, initial=s, initial_valid=jnp.asarray(valid)),
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(seed),
    )
    want_dx, want_dw, want_ds = vjp(jnp.asarray(gbar))

    # Plain versions of K5 and K6.
    got = t_sga.sga_sweep_plain(_n(x), _nw(w), "h", reverse, _ns(seed), valid)
    np.testing.assert_allclose(got.numpy(), _n(out).numpy(), **TOL)
    dx, dw, dseed = t_sga.sga_sweep_bwd_plain(
        _n(x), _nw(w), _n(out), _n(gbar), "h", reverse, _ns(seed), valid
    )
    np.testing.assert_allclose(dx.numpy(), _n(want_dx).numpy(), **TOL)
    np.testing.assert_allclose(dw.numpy(), _nw(want_dw).numpy(), **TOL)
    np.testing.assert_allclose(dseed.numpy(), _ns(want_ds).numpy(), **TOL)
    if not valid:
        assert not dseed.any()

    # The autograd route (K5 forward, K6 backward; their plain versions here).
    xt, wt, st = (t.requires_grad_() for t in (_n(x), _nw(w), _ns(seed)))
    a = t_sga.SeededSweep.apply(xt, wt, st, reverse, valid)
    a.backward(_n(gbar))
    np.testing.assert_allclose(a.detach().numpy(), _n(out).numpy(), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), _n(want_dx).numpy(), **TOL)
    np.testing.assert_allclose(wt.grad.numpy(), _nw(want_dw).numpy(), **TOL)
    np.testing.assert_allclose(st.grad.numpy(), _ns(want_ds).numpy(), **TOL)


def test_unseeded_sweep_is_unchanged(rng):
    """Without a seed, and with an invalid one, the sweep and its gradient
    are the unseeded ones."""
    x, w, seed, gbar = _inputs(rng)
    xn, wn, gn = _n(x), _nw(w), _n(gbar)
    for axis in ("h", "w"):
        a = t_sga.sga_sweep_plain(xn, wn, axis, False)
        if axis == "h":
            torch.testing.assert_close(t_sga.sga_sweep_plain(xn, wn, "h", False, _ns(seed), False), a)
        dx, dw = t_sga.sga_sweep_bwd_plain(xn, wn, a, gn, axis, False)
        if axis == "h":
            dx2, dw2, _ = t_sga.sga_sweep_bwd_plain(xn, wn, a, gn, "h", False, _ns(seed), False)
            torch.testing.assert_close(dx2, dx)
            torch.testing.assert_close(dw2, dw)


@pytest.mark.parametrize("reverse", [False, True])
def test_wrappers_on_a_column_window(rng, reverse):
    """The kernel wrappers on a CPU tensor (their plain versions) work on
    the window [col0, col0 + cols) of a wider row: out, dx and dw change
    only there, the boundary row is the sweep's last row, dx and dw are
    added into, and `dboundary` adds to gbar at the last row."""
    N, Dn, Hn, Wn, col0, cols = 2, 4, 5, 9, 3, 4
    x = torch.from_numpy(rng.standard_normal((N, Dn, Hn, Wn)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((N, 4, 5, Hn, Wn)).astype(np.float32))
    w = w / w.abs().sum(2, keepdim=True)
    seed = torch.from_numpy(rng.standard_normal((N, Dn, cols)).astype(np.float32))
    gbar = torch.from_numpy(rng.standard_normal((N, Dn, Hn, Wn)).astype(np.float32))
    dbound = torch.from_numpy(rng.standard_normal((N, Dn, cols)).astype(np.float32))
    win = slice(col0, col0 + cols)
    direction = 3 if reverse else 2

    out = torch.full_like(x, 7.0)
    out, boundary = t_sga.sga_sweep_seeded_kernel(
        x, w, reverse, seed, True, direction=direction, col0=col0, cols=cols, out=out)
    want = t_sga.sga_sweep_plain(x[..., win], w[:, direction, ..., win], "h", reverse, seed, True)
    torch.testing.assert_close(out[..., win], want)
    assert (out[..., :col0] == 7).all() and (out[..., col0 + cols:] == 7).all()
    torch.testing.assert_close(boundary, want[:, :, 0 if reverse else -1])

    dx0, dw0 = torch.ones_like(x), torch.ones_like(w)
    dx, dw, dseed = t_sga.sga_sweep_bwd_seeded_kernel(
        x, w, out, gbar, reverse, seed, True, direction=direction, col0=col0, cols=cols,
        dboundary=dbound, dx=dx0.clone(), dw=dw0.clone())
    g = gbar[..., win].clone()
    g[:, :, 0 if reverse else -1] += dbound
    rdx, rdw, rds = t_sga.sga_sweep_bwd_plain(
        x[..., win], w[:, direction, ..., win], out[..., win].contiguous(), g, "h", reverse, seed, True)
    torch.testing.assert_close(dx[..., win], 1 + rdx)
    torch.testing.assert_close(dw[:, direction, ..., win], 1 + rdw)
    torch.testing.assert_close(dseed, rds)
    outside = torch.ones(Wn, dtype=torch.bool)
    outside[win] = False
    assert (dx[..., outside] == 1).all() and (dw[..., outside] == 1).all()
    assert (dw[:, [k for k in range(4) if k != direction]] == 1).all()


def test_wrappers_reject_a_window_outside_the_row(rng):
    x = torch.zeros((1, 2, 3, 4))
    w = torch.zeros((1, 5, 3, 4))
    with pytest.raises(ValueError, match="window"):
        t_sga.sga_sweep_seeded_kernel(x, w, False, col0=2, cols=3)
    with pytest.raises(ValueError, match="seed"):
        t_sga.sga_sweep_seeded_kernel(x, w, False, torch.zeros((1, 2, 3)), True, cols=4)
