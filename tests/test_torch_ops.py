"""The port's plain ops against the JAX package's ops, on the CPU in float32.

Tolerance 1e-5 (rtol and atol), as the JAX package's own kernel tests use:
both sides compute in float32 and differ only in summation order.  SGA and
LGA are also held against the Pallas kernels in interpret mode at tiny
shapes, as tests/test_pallas.py and tests/test_lga_pallas.py run them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganet_tpu.ops import cost_volume as j_cv
from ganet_tpu.ops import disparity as j_disp
from ganet_tpu.ops.lga import lga as j_lga
from ganet_tpu.ops import lga_pallas
from ganet_tpu.ops import normalize as j_norm
from ganet_tpu.ops.sga import sga as j_sga, sga_sweep as j_sga_sweep
from ganet_tpu.ops import sga_pallas
from ganet_tpu_torch.ops import (
    build_cost_volume,
    disparity_regression,
    dispatch,
    l1_normalize,
    lga_reference,
    normalize_weights,
    sga_reference,
    sga_sweep_reference,
    trilinear_upsample,
)
from ganet_tpu_torch.ops import lga as t_lga
from ganet_tpu_torch.ops import sga as t_sga
from tests.torch_parity import two_torch_threads  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
SWEEPS = [("w", False), ("w", True), ("h", False), ("h", True)]
# (B, D, H, W, C): partial shapes as tests/test_pallas.py uses.
SGA_SHAPES = [(1, 4, 6, 10, 2), (2, 8, 5, 7, 1), (1, 16, 130, 9, 1)]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _sga_weights(rng, shape):
    return np.asarray(j_norm.l1_normalize(jnp.asarray(rng.standard_normal(shape).astype(np.float32))))


def _lga_guidance(rng, B, H, W, radius):
    K = 2 * radius + 1
    g = rng.standard_normal((B, H, W, 3 * K * K)).astype(np.float32)
    return np.asarray(j_norm.l1_normalize(jnp.asarray(g)))


@pytest.mark.parametrize("axis", [-1, 1])
def test_l1_normalize(rng, axis):
    x = rng.standard_normal((3, 5, 7)).astype(np.float32)
    x[0] = 0.0  # an all-zero set exercises the 1e-8 eps
    want = np.asarray(j_norm.l1_normalize(jnp.asarray(x), axis=axis))
    np.testing.assert_allclose(l1_normalize(_t(x), dim=axis).numpy(), want, **TOL)


@pytest.mark.parametrize("method", ["l1", "softmax"])
def test_normalize_weights(rng, method):
    x = rng.standard_normal((2, 4, 4, 3, 4, 5)).astype(np.float32)
    want = np.asarray(j_norm.normalize_weights(jnp.asarray(x), method))
    np.testing.assert_allclose(normalize_weights(_t(x), method).numpy(), want, **TOL)


@pytest.mark.parametrize("num_disp", [1, 4, 12])
def test_build_cost_volume(rng, num_disp):
    left = rng.standard_normal((2, 6, 10, 3)).astype(np.float32)
    right = rng.standard_normal((2, 6, 10, 3)).astype(np.float32)
    want = np.asarray(j_cv.build_cost_volume(jnp.asarray(left), jnp.asarray(right), num_disp))
    got = build_cost_volume(_t(left), _t(right), num_disp).numpy()
    np.testing.assert_array_equal(got, want)


def test_trilinear_upsample(rng):
    x = rng.standard_normal((2, 4, 6, 8)).astype(np.float32)
    want = np.asarray(j_disp.trilinear_upsample(jnp.asarray(x), (12, 18, 24)))
    np.testing.assert_allclose(trilinear_upsample(_t(x), (12, 18, 24)).numpy(), want, **TOL)


def test_disparity_regression(rng):
    logits = rng.standard_normal((2, 12, 5, 7)).astype(np.float32)
    prob = np.asarray(jnp.asarray(np.exp(logits) / np.exp(logits).sum(1, keepdims=True)))
    want = np.asarray(j_disp.disparity_regression(jnp.asarray(prob), 12))
    np.testing.assert_allclose(disparity_regression(_t(prob), 12).numpy(), want, **TOL)


@pytest.mark.parametrize("shape", SGA_SHAPES)
@pytest.mark.parametrize("axis,reverse", SWEEPS)
def test_sga_sweep_reference_matches_scan(rng, shape, axis, reverse):
    B, D, H, W, C = shape
    x = rng.standard_normal(shape).astype(np.float32)
    w = _sga_weights(rng, (B, H, W, C, 5))
    want = np.asarray(j_sga_sweep(jnp.asarray(x), jnp.asarray(w), axis, reverse))
    got = sga_sweep_reference(_t(x), _t(w), axis, reverse).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("axis,reverse", SWEEPS)
def test_sga_sweep_reference_matches_pallas(rng, axis, reverse):
    shape = (1, 4, 6, 10, 2)
    B, D, H, W, C = shape
    x = rng.standard_normal(shape).astype(np.float32)
    w = _sga_weights(rng, (B, H, W, C, 5))
    want = np.asarray(sga_pallas.sga_sweep(jnp.asarray(x), jnp.asarray(w), axis, reverse))
    got = sga_sweep_reference(_t(x), _t(w), axis, reverse).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("oracle", ["scan", "pallas"])
def test_sga_reference(rng, oracle):
    shape = (1, 6, 10, 12, 2)
    x = rng.standard_normal(shape).astype(np.float32)
    w = _sga_weights(rng, (1, 10, 12, 2, 4, 5))
    fn = j_sga if oracle == "scan" else sga_pallas.sga
    want = np.asarray(fn(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(sga_reference(_t(x), _t(w)).numpy(), want, **TOL)
    # The model's entry (NCDHW) routes CPU tensors to the same plain version.
    got = dispatch.sga(_t(x), _t(w), impl="kernel").numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("radius", [1, 2])
@pytest.mark.parametrize("repeats", [1, 2])
def test_lga_reference_matches_scan(rng, radius, repeats):
    B, D, H, W = 2, 5, 9, 11
    x = rng.standard_normal((B, D, H, W)).astype(np.float32)
    g = _lga_guidance(rng, B, H, W, radius)
    want = np.asarray(j_lga(jnp.asarray(x), jnp.asarray(g), radius, repeats))
    got = lga_reference(_t(x), _t(g), radius, repeats).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("radius", [1, 2])
def test_lga_reference_matches_pallas(rng, radius):
    B, D, H, W = 1, 4, 8, 16
    x = rng.standard_normal((B, D, H, W)).astype(np.float32)
    g = _lga_guidance(rng, B, H, W, radius)
    want = np.asarray(lga_pallas.lga(jnp.asarray(x), jnp.asarray(g), radius=radius, repeats=2))
    got = lga_reference(_t(x), _t(g), radius, 2).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    got = dispatch.lga(_t(x), _t(g), radius, 2, impl="kernel").numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_resolve_impl():
    cpu = torch.zeros(1)
    assert dispatch.resolve_impl("auto", cpu) == "torch"
    assert dispatch.resolve_impl("kernel", cpu) == "kernel"
    with pytest.raises(ValueError):
        dispatch.resolve_impl("scan", cpu)


def test_kernel_wrappers_refuse_cpu_tensors():
    """A kernel launch never falls back: a CPU tensor handed to the launch
    itself raises before anything is built."""
    x = torch.zeros((2, 4, 6, 8))
    with pytest.raises(ValueError):
        t_sga.sga_sweep_kernel(x, torch.zeros((2, 5, 6, 8)), "h", False)
    with pytest.raises(ValueError):
        t_lga.lga_kernel(torch.zeros((1, 4, 6, 8)), torch.zeros((1, 75, 6, 8)), 2)
    assert t_sga.sga_sweep_kernel.launches == 0
    assert t_lga.lga_kernel.launches == 0
