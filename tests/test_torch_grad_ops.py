"""Gradients of the port's SGA and LGA against the JAX package's, on the CPU
in float32.

The plain versions of the backward kernels (`sga_sweep_bwd_plain` for K3,
`lga_bwd_plain` for K4) and the autograd routes that the model takes
(`dispatch` with impl "kernel", which on a CPU tensor runs the Functions
with the plain versions, and impl "torch", autograd through the plain
forward) are held against `jax.vjp` of the scan oracles
(`ganet_tpu.ops.sga`, `ganet_tpu.ops.lga`) and of the Pallas kernels in
interpret mode (`sga_pallas`, `lga_pallas`, which run the bodies of K3 and
K4), at tiny shapes.  Inputs are quantised so that maxima tie: inside a
sweep (the argmax over d of the carry) and across the four directions,
which the max tree max(max(A0, A1), max(A2, A3)) splits evenly.
Tolerance 1e-5 (rtol and atol), as the forward op tests: both sides sum in
float32, in other orders.
"""

import importlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganet_tpu.ops import lga_pallas, sga_pallas
from ganet_tpu_torch.ops import dispatch
from ganet_tpu_torch.ops import lga as t_lga
from ganet_tpu_torch.ops import sga as t_sga

j_sga = importlib.import_module("ganet_tpu.ops.sga")
j_lga = importlib.import_module("ganet_tpu.ops.lga")

TOL = dict(rtol=1e-5, atol=1e-5)
SWEEPS = [("w", False), ("w", True), ("h", False), ("h", True)]
SGA_ORACLES = {"scan": (j_sga.sga_sweep, j_sga.sga), "pallas": (sga_pallas.sga_sweep, sga_pallas.sga)}
LGA_ORACLES = {"scan": j_lga.lga, "pallas": lga_pallas.lga}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _quantised(rng, shape):
    """Values on a grid of 1/2: maxima over d tie often."""
    return (rng.integers(-3, 4, shape) / 2.0).astype(np.float32)


def _weights(rng, shape, copy_frac=0.0):
    """L1-normalised weight sets over the last axis; a `copy_frac` share of
    them is (1, 0, 0, 0, 0), where every direction's output copies x and
    the four directions tie."""
    w = rng.standard_normal(shape).astype(np.float32)
    w /= np.abs(w).sum(-1, keepdims=True)
    if copy_frac:
        onehot = np.zeros(shape[-1], np.float32)
        onehot[0] = 1.0
        w[rng.random(shape[:-2] + (1,) * (len(shape) - len(shape[:-2]) - 1))[..., 0] < copy_frac] = onehot
    return w


# (B, D, H, W, C) of the gradient sweep's parity: a small volume, in all
# four sweeps; then, one sweep along each axis each, sweeps of length 1
# (only the copy step), D = 1 (every bin is the maximum) and D = 33 with odd
# H and W; and a W sweep of 70 steps, past one 64-step stage of the
# kernel's bfloat16 W sweep, with a ragged tail.
SGA_BWD_SHAPES = {"base": (1, 5, 6, 10, 2), "length1": (1, 4, 1, 1, 2), "d1": (1, 1, 5, 7, 2),
                  "d33": (1, 33, 5, 7, 1), "w70": (1, 4, 2, 70, 1)}
SGA_BWD_CASES = [("base", *sweep) for sweep in SWEEPS] + [
    ("length1", "w", False), ("length1", "h", True), ("d1", "w", True), ("d1", "h", False),
    ("d33", "w", False), ("d33", "h", True), ("w70", "w", False),
]


@pytest.mark.parametrize("oracle", sorted(SGA_ORACLES))
@pytest.mark.parametrize("shape,axis,reverse", SGA_BWD_CASES)
def test_sga_sweep_bwd_plain_matches_jax_vjp(rng, oracle, axis, reverse, shape):
    B, D, H, W, C = SGA_BWD_SHAPES[shape]
    x = _quantised(rng, (B, D, H, W, C))
    w = _weights(rng, (B, H, W, C, 5))
    gbar = rng.standard_normal((B, D, H, W, C)).astype(np.float32)
    sweep = SGA_ORACLES[oracle][0]
    a, vjp = jax.vjp(lambda x_, w_: sweep(x_, w_, axis, reverse), jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(gbar))
    # The kernel's layout: (N = B*C, D, H, W) and (N, 5, H, W).
    to_n = lambda v: _t(v).permute(0, 4, 1, 2, 3).reshape(B * C, D, H, W)  # noqa: E731
    wn = _t(w).permute(0, 3, 4, 1, 2).reshape(B * C, 5, H, W)
    an = to_n(a)
    dx, dw = t_sga.sga_sweep_bwd_plain(to_n(x), wn, an, to_n(gbar), axis, reverse)
    np.testing.assert_allclose(
        dx.reshape(B, C, D, H, W).permute(0, 2, 3, 4, 1).numpy(), np.asarray(want_dx), **TOL
    )
    np.testing.assert_allclose(
        dw.reshape(B, C, 5, H, W).permute(0, 3, 4, 1, 2).numpy(), np.asarray(want_dw), **TOL
    )
    # ... and against autograd of the plain forward.
    xr, wr = to_n(x).requires_grad_(), wn.clone().requires_grad_()
    t_sga.sga_sweep_plain(xr, wr, axis, reverse).backward(to_n(gbar))
    np.testing.assert_allclose(dx.numpy(), xr.grad.numpy(), **TOL)
    # A sweep of length 1 copies x and leaves w out of the graph: dw is 0.
    want_w = wr.grad if wr.grad is not None else torch.zeros_like(wr)
    np.testing.assert_allclose(dw.numpy(), want_w.numpy(), **TOL)


@pytest.mark.parametrize("oracle", sorted(SGA_ORACLES))
def test_sga_routes_match_jax_vjp_with_ties(rng, oracle):
    B, D, H, W, C = 1, 4, 7, 9, 2
    x = _quantised(rng, (B, D, H, W, C))
    w = _weights(rng, (B, H, W, C, 4, 5), copy_frac=0.4)
    gbar = rng.standard_normal((B, D, H, W, C)).astype(np.float32)
    # Ties across directions: where every set is a copy, and at the corners.
    sweeps = [t_sga.sga_sweep_reference(_t(x), _t(w[..., k, :]), *SWEEPS[k]) for k in range(4)]
    assert int(((sweeps[0] == sweeps[1]) & (sweeps[1] == sweeps[2]) & (sweeps[2] == sweeps[3])).sum()) > 20
    out, vjp = jax.vjp(SGA_ORACLES[oracle][1], jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(gbar))
    for impl in ("kernel", "torch"):
        xr, wr = _t(x).requires_grad_(), _t(w).requires_grad_()
        got = dispatch.sga(xr, wr, impl=impl)
        assert got.grad_fn is not None
        got.backward(_t(gbar))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL)
        np.testing.assert_allclose(xr.grad.numpy(), np.asarray(want_dx), **TOL)
        np.testing.assert_allclose(wr.grad.numpy(), np.asarray(want_dw), **TOL)


def test_max_tree_splits_ties_as_jax(rng):
    a = [_quantised(rng, (3, 50)) for _ in range(4)]
    g = rng.standard_normal((3, 50)).astype(np.float32)
    tree = lambda *v: jnp.maximum(jnp.maximum(v[0], v[1]), jnp.maximum(v[2], v[3]))  # noqa: E731
    _, vjp = jax.vjp(tree, *(jnp.asarray(v) for v in a))
    want = vjp(jnp.asarray(g))
    got = t_sga.max_tree_bwd([_t(v) for v in a], _t(g))
    for gv, wv in zip(got, want):
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def _check_lga_bwd(rng, oracle, shape, radius, repeats):
    """`lga_bwd_plain` (one pass) and the autograd routes against jax.vjp
    of `repeats` passes of the oracle."""
    B, D, H, W = shape
    K = 2 * radius + 1
    x = rng.standard_normal((B, D, H, W)).astype(np.float32)
    g = _weights(rng, (B, H, W, 3 * K * K))
    gbar = rng.standard_normal((B, D, H, W)).astype(np.float32)
    out, vjp = jax.vjp(
        lambda x_, g_: LGA_ORACLES[oracle](x_, g_, radius, repeats), jnp.asarray(x), jnp.asarray(g)
    )
    want_dx, want_dg = (np.asarray(v) for v in vjp(jnp.asarray(gbar)))
    g75 = _t(g).permute(0, 3, 1, 2).contiguous()
    if repeats == 1:
        dx, dg = t_lga.lga_bwd_plain(_t(x), g75, _t(gbar), radius)
        np.testing.assert_allclose(dx.numpy(), want_dx, **TOL)
        np.testing.assert_allclose(dg.permute(0, 2, 3, 1).numpy(), want_dg, **TOL)
    for impl in ("kernel", "torch"):
        xr, gr = _t(x).requires_grad_(), _t(g).requires_grad_()
        got = dispatch.lga(xr, gr, radius, repeats, impl=impl)
        got.backward(_t(gbar))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **TOL)
        np.testing.assert_allclose(xr.grad.numpy(), want_dx, **TOL)
        np.testing.assert_allclose(gr.grad.numpy(), want_dg, **TOL)


@pytest.mark.parametrize("oracle", sorted(LGA_ORACLES))
@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("repeats", [1, 2])
def test_lga_bwd_matches_jax_vjp(rng, oracle, radius, repeats):
    _check_lga_bwd(rng, oracle, (1, 3, 8, 16), radius, repeats)


# The edges K4's card tests take, as the yardstick they use: D = 1, H below
# the 5x5 stencil, an odd W past a 32-pixel tile, and B = 2.
@pytest.mark.parametrize("oracle", sorted(LGA_ORACLES))
@pytest.mark.parametrize("shape", [(1, 1, 8, 16), (1, 3, 3, 16), (1, 3, 6, 37), (2, 3, 5, 12)])
def test_lga_bwd_matches_jax_vjp_at_edges(rng, oracle, shape):
    _check_lga_bwd(rng, oracle, shape, 2, 1)


def test_lga_bwd_describe_raises_on_a_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        t_lga.lga_bwd_describe(torch.zeros((1, 3, 8, 16)), 2)


def test_lga_bwd_kernel_has_no_atomics():
    """K4 sums in a fixed order, so its result is the same from run to run."""
    text = (Path(t_lga.__file__).resolve().parent.parent / "csrc" / "lga_bwd.cu").read_text()
    assert not re.search(r"atomic\w*\s*\(|\batom\.|\bred\.", text)


def test_lga_describe_raises_on_a_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        t_lga.lga_describe(torch.zeros((1, 3, 8, 16)), 2)


def test_lga_fwd_kernel_has_no_atomics():
    """K2 sums in a fixed order, so its result is the same from run to run."""
    text = (Path(t_lga.__file__).resolve().parent.parent / "csrc" / "lga_fwd.cu").read_text()
    assert not re.search(r"atomic\w*\s*\(|\batom\.|\bred\.", text)


def test_lga3d_describe_raises_on_a_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        t_lga.lga3d_describe(torch.zeros((4, 3, 8, 16)), 2, 2)
    with pytest.raises(ValueError, match="divide"):
        t_lga.lga3d_describe(torch.zeros((4, 3, 8, 16)), 2, 3)


def test_lga3d_fwd_kernel_has_no_atomics():
    """K7 sums in K2's fixed order, so its result is the same from run to run."""
    text = (Path(t_lga.__file__).resolve().parent.parent / "csrc" / "lga3d_fwd.cu").read_text()
    assert not re.search(r"atomic\w*\s*\(|\batom\.|\bred\.", text)
