"""Helpers for the parity tests of the PyTorch port against the JAX package.

Inputs and weights are made with numpy from a seed and passed to both
frameworks as numpy arrays.  Freshly initialised BatchNorm is close to the
identity (mean 0, var 1, scale 1, bias 0), which would hide a BatchNorm
mapping fault, so every BatchNorm leaf is overwritten with seeded values
before conversion: mean ~ N(0, 0.1), var ~ U(0.5, 1.5), scale ~ U(0.5, 1.5),
bias ~ N(0, 0.1).
"""

from __future__ import annotations

from typing import Any, Mapping

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganet_tpu.models.ganet import GANet as JGANet
from ganet_tpu_torch.entry import build_model, predict
from ganet_tpu_torch.convert import convert_flax_variables


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two PyTorch intra-op threads for a module's tests (autouse where a
    test module imports it).  The suite runs several workers on the
    machine's cores, and PyTorch's OpenMP threads, one a core in each
    worker, then spin against each other: four processes' GANet_small train
    steps took 524 s at 8 threads each and 22 s at 2."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _seed_leaves(tree: Mapping[str, Any], rng, in_bn: bool = False) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out[k] = _seed_leaves(v, rng, in_bn or k.startswith("BatchNorm"))
            continue
        v = np.asarray(v, dtype=np.float32)
        if k == "mean":
            v = rng.normal(0.0, 0.1, v.shape)
        elif k == "var":
            v = rng.uniform(0.5, 1.5, v.shape)
        elif in_bn and k == "scale":
            v = rng.uniform(0.5, 1.5, v.shape)
        elif in_bn and k == "bias":
            v = rng.normal(0.0, 0.1, v.shape)
        out[k] = np.asarray(v, dtype=np.float32)
    return out


def seeded_variables(variables: Mapping[str, Any], seed: int = 0) -> dict:
    """numpy copy of flax variables with every BatchNorm leaf seeded."""
    rng = np.random.default_rng(seed)
    host = jax.device_get(variables)
    return {col: _seed_leaves(host[col], rng) for col in host}


def he_normal_draw(shapes: Mapping[str, Any], seed: int = 0) -> dict:
    """A tree of flax variables (or of their shapes) filled from a seed:
    kernels truncated He-normal as flax's `he_normal`, every other leaf 0.
    Pass the result through `seeded_variables` to seed the BatchNorm leaves."""
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        if path[-1].key != "kernel":
            return np.zeros(leaf.shape, np.float32)
        z = rng.standard_normal(leaf.shape)  # a unit normal truncated at +-2
        while (np.abs(z) > 2).any():
            z = np.where(np.abs(z) > 2, rng.standard_normal(leaf.shape), z)
        std = np.sqrt(2.0 / np.prod(leaf.shape[:-1])) / 0.87962566103423978
        return (z * std).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def load_converted(module: torch.nn.Module, variables: Mapping[str, Any]) -> torch.nn.Module:
    """Load converted flax variables into `module` (strict) and set eval."""
    module.load_state_dict(convert_flax_variables(variables), strict=True)
    return module.eval()


def nhwc(t: torch.Tensor) -> np.ndarray:
    """A channels-first port tensor as the JAX package's channels-last array."""
    return t.detach().movedim(1, -1).numpy()


def nchw(a) -> torch.Tensor:
    """A channels-last array as a channels-first torch tensor."""
    return torch.from_numpy(np.array(a, dtype=np.float32)).movedim(-1, 1).contiguous()


def ganet_parity(jcfg, tcfg, seed: int = 0) -> float:
    """Max |disparity| difference of the whole eval forward at 48x96."""
    rng = np.random.default_rng(seed)
    H, W = 48, 96
    dummy = jnp.zeros((1, H, W, 3), jnp.float32)
    jmodel = JGANet(jcfg)
    variables = seeded_variables(
        jax.jit(lambda k: jmodel.init(k, dummy, dummy, train=True))(jax.random.PRNGKey(0)), seed
    )
    left = rng.random((1, H, W, 3), dtype=np.float32)
    right = rng.random((1, H, W, 3), dtype=np.float32)
    want = np.asarray(jax.jit(lambda v, a, b: jmodel.apply(v, a, b, train=False))(variables, left, right))
    model = build_model(tcfg, device="cpu", state_dict=convert_flax_variables(variables))
    got = predict(model, left, right).numpy()
    assert got.shape == want.shape == (1, H, W)
    assert np.isfinite(got).all()
    return float(np.abs(got - want).max())
