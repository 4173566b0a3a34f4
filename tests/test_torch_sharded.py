"""The port's H-sharded SGA wavefront and halo LGA (`ganet_tpu_torch/
parallel/`) on 4 ranks of `torch.distributed` over gloo, on the CPU,
against the JAX package's `sharded_sga` and `sharded_lga` on
`make_mesh(MeshConfig(space=4))` over the 8 faked CPU devices of
conftest (the counterpart of tests/test_sharding.py).

The ranks are started once for the module (`parallel/launch.py`, spawn)
and run every case at once (`parallel/cases.py`, which lives in the port
so that the children import neither this module nor JAX); each rank saves
its block of the output and of the gradients, and each case is then its
own test here.  The ranks' plain versions of K1/K3 and K5/K6 sum in
float32 as the JAX scan does, in other orders: forward within 1e-5,
gradients within 1e-4, as tests/test_sharding.py holds JAX's own sharded
op against its unsharded one.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganet_tpu.config import MeshConfig as JMeshConfig
from ganet_tpu.parallel.mesh import make_mesh as j_make_mesh
from ganet_tpu.parallel.sharded_lga import sharded_lga as j_sharded_lga
from ganet_tpu_torch.parallel import cases as K
from ganet_tpu_torch.parallel.launch import launch
from ganet_tpu_torch.parallel.sharded_lga import sharded_lga
from tests.torch_parity import two_torch_threads  # noqa: F401

j_ssga = importlib.import_module("ganet_tpu.parallel.sharded_sga")
t_ssga = importlib.import_module("ganet_tpu_torch.parallel.sharded_sga")

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
RANKS = 4

SGA_CASES = {
    "auto": dict(shape=(1, 2, 5, 8, 12), chunks=0),
    "chunks2": dict(shape=(1, 2, 5, 8, 12), chunks=2),
    "chunks5": dict(shape=(1, 2, 5, 8, 12), chunks=5),
    # W=10, chunks=3: width 4, starts (0, 4, 6); the last chunk overlaps.
    "overlap": dict(shape=(1, 2, 4, 8, 10), chunks=3),
    # data=2 x space=2: the batch over `data`, H over the `space` groups.
    "mesh": dict(shape=(2, 2, 5, 8, 12), chunks=2, mesh=(2, 2, 1)),
}
LGA_CASES = {
    "repeats1": dict(shape=(1, 6, 16, 12), repeats=1),
    "repeats2": dict(shape=(1, 6, 16, 12), repeats=2),
    "mesh": dict(shape=(2, 6, 8, 12), repeats=2, mesh=(2, 2, 1)),
}


def _cases():
    out = []
    for seed, (name, c) in enumerate(SGA_CASES.items()):
        out.append(dict(name=f"sga_{name}", op="sga", seed=seed, grad=True, **c))
    for seed, (name, c) in enumerate(LGA_CASES.items(), start=10):
        out.append(dict(name=f"lga_{name}", op="lga", seed=seed, grad=True, **c))
    return {c["name"]: c for c in out}


CASES = _cases()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case run once on 4 gloo ranks on the CPU; name -> gathered results."""
    out_dir = str(tmp_path_factory.mktemp("sharded"))
    launch(K.run_cases, RANKS, (list(CASES.values()), out_dir, "cpu"), backend="gloo", device="cpu")
    return {name: K.gather(c, out_dir, RANKS) for name, c in CASES.items()}


@functools.lru_cache(maxsize=None)
def _jax_mesh(shape):
    return j_make_mesh(JMeshConfig(*shape))


def _jit_vjp(fn, a, b, gbar):
    """fn(a, b) and its cotangents for gbar, under one jit (the eager
    shard_map with its fori_loop takes ten times as long on the CPU)."""
    def both(a, b, gbar):
        out, vjp = jax.vjp(fn, a, b)
        return (out, *vjp(gbar))

    return jax.jit(both)(a, b, gbar)


@functools.lru_cache(maxsize=None)
def _jax_result(name):
    """(out, dx, dw or dg) of JAX's sharded op on the case's inputs, on the
    port's layouts."""
    case = CASES[name]
    inp = K.make_inputs(case)
    mesh_shape = case.get("mesh", (1, RANKS, 1))
    mesh = _jax_mesh(mesh_shape)
    batch_axis = "data" if mesh_shape[0] > 1 else None
    if case["op"] == "sga":
        x = jnp.asarray(inp["x"].transpose(0, 2, 3, 4, 1))  # (B, D, H, W, C)
        w = jnp.asarray(inp["w"].transpose(0, 4, 5, 1, 2, 3))  # (B, H, W, C, 4, 5)
        gbar = jnp.asarray(inp["gbar"].transpose(0, 2, 3, 4, 1))
        out, dx, dw = _jit_vjp(
            lambda a, b: j_ssga.sharded_sga(a, b, mesh, chunks=case["chunks"], batch_axis=batch_axis),
            x, w, gbar)
        return (np.asarray(out).transpose(0, 4, 1, 2, 3), np.asarray(dx).transpose(0, 4, 1, 2, 3),
                np.asarray(dw).transpose(0, 3, 4, 5, 1, 2))
    g = jnp.asarray(inp["g"].transpose(0, 2, 3, 1))  # (B, H, W, 75)
    out, dx, dg = _jit_vjp(
        lambda a, b: j_sharded_lga(a, b, mesh, radius=2, repeats=case["repeats"], batch_axis=batch_axis),
        jnp.asarray(inp["x"]), g, jnp.asarray(inp["gbar"]))
    return np.asarray(out), np.asarray(dx), np.asarray(dg).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("name", [f"sga_{n}" for n in SGA_CASES] + [f"lga_{n}" for n in LGA_CASES])
def test_forward_matches_jax_sharded(ranks, name):
    want, _, _ = _jax_result(name)
    np.testing.assert_allclose(ranks[name]["out"].numpy(), want, **FWD)


@pytest.mark.parametrize("name", [f"sga_{n}" for n in SGA_CASES] + [f"lga_{n}" for n in LGA_CASES])
def test_gradients_match_jax_sharded(ranks, name):
    _, want_dx, want_dother = _jax_result(name)
    got = ranks[name]
    np.testing.assert_allclose(got["dx"].numpy(), want_dx, **GRAD)
    np.testing.assert_allclose(got["dw" if name.startswith("sga") else "dg"].numpy(), want_dother, **GRAD)


def test_every_rank_ran_the_plain_versions(ranks):
    """On CPU tensors the wrappers run the plain versions: no kernel launch
    is counted on any rank."""
    for res in ranks.values():
        assert len(res["launches"]) == RANKS
        assert all(not any(c.values()) for c in res["launches"])


@pytest.mark.parametrize("W,chunks", [(10, 3), (12, 5), (12, 2), (320, 0), (176, 0), (96, 0), (320, 8)])
def test_chunk_layout_matches_jax(W, chunks):
    assert t_ssga.chunk_layout(W, chunks) == j_ssga.chunk_layout(W, chunks)


def test_overlapping_tail_layout():
    assert t_ssga.chunk_layout(10, 3) == (4, [0, 4, 6])


@pytest.mark.parametrize("S,chunks", [(4, 3), (4, 1), (2, 5), (4, 64), (1, 3)])
def test_pipeline_stats_match_jax(S, chunks):
    assert t_ssga.pipeline_stats(S, chunks) == j_ssga.pipeline_stats(S, chunks)


def _one_shard_inputs(rng):
    B, C, D, H, W = 1, 2, 6, 12, 10
    x = rng.standard_normal((B, C, D, H, W)).astype(np.float32)
    w = rng.standard_normal((B, C, 4, 5, H, W)).astype(np.float32)
    w /= np.abs(w).sum(3, keepdims=True)
    gbar = rng.standard_normal((B, C, D, H, W)).astype(np.float32)
    return x, w, gbar


@pytest.mark.parametrize("force_pipeline", [True, False])
def test_single_shard_matches_jax(rng, force_pipeline):
    """One shard without torch.distributed: with `force_pipeline` the chunked
    wavefront runs anyway (bench_wavefront --single_shard) and must give
    the same op, forward and gradients, as JAX's at S=1."""
    x, w, gbar = _one_shard_inputs(rng)
    mesh = _jax_mesh((1, 1, 1))
    out, want_dx, want_dw = _jit_vjp(
        lambda a, b: j_ssga.sharded_sga(a, b, mesh, chunks=3, force_pipeline=force_pipeline),
        jnp.asarray(x.transpose(0, 2, 3, 4, 1)), jnp.asarray(w.transpose(0, 4, 5, 1, 2, 3)),
        jnp.asarray(gbar.transpose(0, 2, 3, 4, 1)))
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    got = t_ssga.sharded_sga(xt, wt, chunks=3, force_pipeline=force_pipeline)
    got.backward(torch.from_numpy(gbar))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out).transpose(0, 4, 1, 2, 3), **FWD)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx).transpose(0, 4, 1, 2, 3), **GRAD)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want_dw).transpose(0, 3, 4, 5, 1, 2), **GRAD)


def test_channels_last_wrapper(rng):
    x, w, _ = _one_shard_inputs(rng)
    got = t_ssga.sharded_sga_channels_last(
        torch.from_numpy(x.transpose(0, 2, 3, 4, 1)), torch.from_numpy(w.transpose(0, 4, 5, 1, 2, 3)),
        chunks=2, force_pipeline=True)
    want = t_ssga.sharded_sga(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want.permute(0, 2, 3, 4, 1).numpy(), **FWD)


def test_sharded_lga_rejects_blocks_thinner_than_radius():
    with pytest.raises(ValueError, match="row blocks"):
        sharded_lga(torch.zeros((1, 4, 1, 8)), torch.zeros((1, 75, 1, 8)), radius=2)


def test_sharded_sga_rejects_bad_weights():
    with pytest.raises(ValueError, match="do not match"):
        t_ssga.sharded_sga(torch.zeros((1, 1, 4, 8, 6)), torch.zeros((1, 1, 5, 4, 8, 6)))
