"""Configurations the JAX package runs that the port's other CPU tests do
not reach: GANet11 (its eval forward and one train step against JAX's, the
2-head loss taking the last two weights), the plain SGA and its gradient
past the CUDA kernels' old 256 bins (D = 300 and 512), `soft_argmin`, and
`python -m ganet_tpu_torch.bench_wavefront`'s flags and `--impl` route.

Tolerances are those of the tests they follow: the eval forward within
1e-3 px (`tests/test_torch_models.py`), the train step at
`tests/test_torch_train.py`'s (loss 1e-6, epe 1e-4, gradients 3e-4 per
parameter and 1e-4 over all, norm-relative; BatchNorm statistics 1e-5),
here in float64 (the test says why), SGA 1e-5 as
`tests/test_torch_grad_ops.py`, `soft_argmin` 1e-6 (one softmax in
float32).
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganet_tpu import config as J
from ganet_tpu.models.ganet import GANet as JGANet
from ganet_tpu.ops import soft_argmin as j_soft_argmin
from ganet_tpu.ops.sga import sga as j_sga
from ganet_tpu.parallel.mesh import make_mesh
from ganet_tpu.train.state import TrainState as JTrainState
from ganet_tpu.train.trainer import BATCH_KEYS
from ganet_tpu.train.trainer import make_train_step as j_make_train_step
from ganet_tpu_torch import bench_wavefront
from ganet_tpu_torch import config as C
from ganet_tpu_torch.convert import convert_flax_variables
from ganet_tpu_torch.data import SyntheticStereoDataset, stack
from ganet_tpu_torch.ops import dispatch, soft_argmin
from ganet_tpu_torch.ops.sga import sga_reference_ncdhw
from ganet_tpu_torch.parallel.sharded_sga import sharded_sga
from ganet_tpu_torch.train.cli import JAX_IMPLS
from tests.test_torch_train import _grad_capture, _port_step, _rel
from tests.test_torch_train_bench import _jax_parser
from tests.torch_parity import (  # noqa: F401
    ganet_parity, he_normal_draw, seeded_variables, two_torch_threads,
)

H, W, D = 48, 96, 24


def test_ganet11_eval_forward_matches_jax():
    assert ganet_parity(J.ganet11(24, sga_impl="scan"), C.ganet11(24)) <= 1e-3


def test_ganet11_train_step_matches_jax():
    """One GANet11 train step against JAX's `make_train_step`: two heads,
    so the loss weighs them by the last two of (0.2, 0.6, 1.0).  Both run
    in float64 (JAX under `jax.enable_x64`): GANet11's BatchNorm layers make
    some of its gradients cancel nearly, and in float32 the port's own
    noise floor (float32 against float64) read 1.7e-4 to 9.1e-3 per
    parameter over the draws of seeds 0-5, above the tolerances; in float64
    the two packages agree to about 1e-5 per parameter at seed 0, where
    parts of each still round to float32."""
    jmodel = JGANet(J.ganet11(D, sga_impl="scan"))
    dummy = jax.ShapeDtypeStruct((1, H, W, 3), jnp.float32)
    shapes = jax.eval_shape(lambda k, a: jmodel.init(k, a, a, train=True), jax.random.PRNGKey(0), dummy)
    variables = seeded_variables(he_normal_draw(shapes))
    data = dict(crop_height=H, crop_width=W, kind="synthetic")
    tcfg = C.TrainConfig(model=C.ganet11(D), data=C.DataConfig(**data), batch_size=1)
    batch = stack(SyntheticStereoDataset(H, W, D), [0])
    with jax.enable_x64():
        jcfg = J.TrainConfig(model=J.ganet11(D, sga_impl="scan", compute_dtype="float64"),
                             data=J.DataConfig(**data), batch_size=1)
        assert tcfg.model.num_outputs == 2 and tcfg.loss_weights == tuple(jcfg.loss_weights)
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
        state = JTrainState.create(apply_fn=JGANet(jcfg.model).apply, params=v64["params"],
                                   batch_stats=v64["batch_stats"], tx=_grad_capture())
        b64 = {k: np.asarray(batch[k], np.float64) for k in BATCH_KEYS}
        with make_mesh(jcfg.mesh) as mesh:
            new_state, jm = j_make_train_step(jcfg, mesh, BATCH_KEYS)(state, b64)
        want_grads = convert_flax_variables({"params": jax.device_get(new_state.opt_state)})
        want_stats = convert_flax_variables({"batch_stats": jax.device_get(new_state.batch_stats)})
    want_stats = {k: v for k, v in want_stats.items() if "num_batches" not in k}

    metrics, model = _port_step(tcfg, variables, batch, "float64")
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(grads) == sorted(want_grads)
    np.testing.assert_allclose(metrics["loss"].item(), float(jm["loss"]), rtol=1e-6)
    np.testing.assert_allclose(metrics["epe"].item(), float(jm["epe"]), rtol=1e-4)
    worst = max((_rel(grads[n], want_grads[n].double()), n) for n in grads)
    assert worst[0] <= 3e-4, worst
    flat = lambda d: torch.cat([d[n].double().flatten() for n in sorted(grads)])  # noqa: E731
    assert _rel(flat(grads), flat(want_grads)) <= 1e-4
    got_stats = {k: v for k, v in model.state_dict().items() if k in want_stats}
    assert len(got_stats) == len(want_stats)
    worst = max((_rel(v.double(), want_stats[k].double()), k) for k, v in got_stats.items())
    assert worst[0] <= 1e-5, worst


@pytest.mark.parametrize("bins", [300, 512])
def test_sga_past_256_bins_matches_jax(bins):
    """The port's sga and its gradient on both routes ("kernel": the autograd
    Function over the plain sweeps on the CPU; "torch": autograd of the
    plain forward) at D = 300 and 512 against JAX's scan version, with
    ties in the maxima over d."""
    rng = np.random.default_rng(bins)
    B, Hs, Ws, Cs = 1, 3, 4, 2
    x = (rng.integers(-3, 4, (B, bins, Hs, Ws, Cs)) / 2.0).astype(np.float32)
    w = rng.standard_normal((B, Hs, Ws, Cs, 4, 5)).astype(np.float32)
    w /= np.abs(w).sum(-1, keepdims=True)
    gbar = rng.standard_normal(x.shape).astype(np.float32)
    out, vjp = jax.vjp(j_sga, jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(gbar))
    tol = dict(rtol=1e-5, atol=1e-5)
    for impl in ("kernel", "torch"):
        xr = torch.from_numpy(x).requires_grad_()
        wr = torch.from_numpy(w).requires_grad_()
        got = dispatch.sga(xr, wr, impl=impl)
        got.backward(torch.from_numpy(gbar))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **tol)
        np.testing.assert_allclose(xr.grad.numpy(), np.asarray(want_dx), **tol)
        np.testing.assert_allclose(wr.grad.numpy(), np.asarray(want_dw), **tol)


def test_soft_argmin_matches_jax():
    rng = np.random.default_rng(0)
    cost = rng.standard_normal((2, 24, 5, 7)).astype(np.float32) * 4
    for axis in (1, -1):
        want = np.asarray(j_soft_argmin(jnp.asarray(cost), axis=axis))
        got = soft_argmin(torch.from_numpy(cost), dim=axis).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.sum(axis), 1.0, atol=1e-6)


def test_bench_wavefront_flags_are_the_jax_scripts(monkeypatch):
    """Every flag of `scripts/bench_wavefront.py` is the port's; `--impl`
    has JAX's default and takes JAX's values, mapped as the train CLI maps
    them."""
    ref = _jax_parser("bench_wavefront", monkeypatch)
    mine = bench_wavefront.parse_args(["--device", "cpu"])
    theirs = vars(ref.parse_args([]))
    assert set(theirs) <= set(vars(mine))
    assert mine.impl == theirs["impl"] == "scan"
    for value in ("scan", "pallas", "auto"):
        args = bench_wavefront.parse_args(["--impl", value])
        assert bench_wavefront._impl(args) == JAX_IMPLS.get(value, value) in C.IMPLS
    with pytest.raises(SystemExit):
        bench_wavefront.parse_args(["--impl", "triton"])


@pytest.mark.parametrize("impl", ["scan", "pallas"])
def test_bench_wavefront_routes_by_impl(impl, capsys):
    bench_wavefront.main(["--device", "cpu", "--single_shard", "--height", "8", "--width", "20",
                          "--channels", "2", "--disp", "6", "--dtype", "float32", "--reps", "1",
                          "--chunks", "1,2", "--impl", impl])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["mode"] for r in rows] == ["plain_sga", "sharded_S1", "pipeline_S1_chunks2"]
    assert all(r["impl"] == impl and r["wall_ms"] > 0 for r in rows)


def test_sharded_sga_plain_route_is_the_plain_sga():
    """`sharded_sga(impl="torch")`, the wavefront forced on at one shard,
    against the plain SGA: forward and gradients."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((1, 2, 5, 6, 20)).astype(np.float32))
    w = torch.from_numpy(np.abs(rng.standard_normal((1, 2, 4, 5, 6, 20))).astype(np.float32))
    w = w / w.sum(3, keepdim=True)
    g = torch.from_numpy(rng.standard_normal(tuple(x.shape)).astype(np.float32))
    outs = []
    for fn in (lambda a, b: sharded_sga(a, b, chunks=2, force_pipeline=True, impl="torch"),
               sga_reference_ncdhw):
        xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = fn(xr, wr)
        y.backward(g)
        outs.append((y.detach(), xr.grad, wr.grad))
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="impl"):
        sharded_sga(x, w, impl="scan")

