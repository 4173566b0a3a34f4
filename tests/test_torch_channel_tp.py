"""The port's channel tensor parallelism in eval mode (`ModelConfig.channel_tp`:
the mesh's `disp` axis splits the channels of the aggregation's volumes,
`parallel/channels.py`, the boundary ops `comm.column_gather` and
`comm.row_reduce`, the channel-parallel convolutions of
`parallel/spatial.py`, `models/ganet.py` with a mesh) on ranks of
`torch.distributed` over gloo, on the CPU, against the unsharded ops, the
port's one-device forward and JAX's `GANet(cfg with channel_tp, mesh)`
over `MeshConfig(disp=2)` on 2 of the faked CPU devices of conftest.

The ranks are started once for the module (`parallel/launch.py`, spawn):
2 for the mesh (data, space, disp) = (1, 1, 2), 4 for (1, 2, 2); they run
every case of `parallel/spatial_cases.py` (which lives in the port, so
that the children import neither this module nor JAX).

  * A channel-parallel 3D conv (stride 1 with a folded BatchNorm scale,
    stride 2, and the deconvolution with a bias): each rank's block of the
    input's channels gathered by `column_gather`, its block of the
    output's made; on `disp` 2 and on `space` 2 x `disp` 2 (H halos on
    the gathered input), against the whole conv, forward and the gradient
    with respect to the input, float64 within 1e-9.
  * `column_gather` and `row_reduce` on `disp` 2 against their
    definitions, forward and gradient, float64 and bfloat16 (2-byte
    floats travel as bytes and sum in float32).
  * The cost volume's block of channels against the whole volume's slice.
  * GANet_small (JAX's weights, every BatchNorm leaf seeded, converted)
    at 48x96, max_disp 24, batch 1, over (1, 1, 2) and (1, 2, 2): every
    rank returns the whole disparity, the same bits; in float64 it is the
    port's one-device forward within 1e-9 px, in float32 within 1e-3 px
    at the worst pixel and 1e-5 on average (the bounds of
    `tests/test_torch_disp.py`); and over (1, 1, 2) in float32 JAX's
    channel-TP forward within JAX's own rtol = atol = 2e-4
    (`tests/test_sharding.py`, `TestChannelTP`).
  * Every 3D convolution of a rank is the one-device convolution with a
    block of its output channels (the heads' C -> 1 convs: of its input
    channels) at every bin, the counterpart of the JAX test's sharding
    annotation.
  * The channel rule (`check_channel_shape`) names the sizes that pass.
  * A model built with `channel_tp` and without a mesh, run on each of 2
    ranks of an initialised world on other inputs, is each input's
    single-process model (eval disparity and train-mode gradients within
    1e-9 in float64).
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganet_tpu import config as J
from ganet_tpu.models.ganet import GANet as JGANet
from ganet_tpu.parallel.mesh import make_mesh as j_make_mesh
from ganet_tpu.train.trainer import InferenceState, make_predict_fn
from ganet_tpu_torch.config import ganet_deep, ganet_small
from ganet_tpu_torch.convert import convert_flax_variables
from ganet_tpu_torch.entry import build_model, predict
from ganet_tpu_torch.ops.cost_volume import build_cost_volume_ncdhw
from ganet_tpu_torch.parallel import spatial_cases as K
from ganet_tpu_torch.parallel.channels import check_channel_shape
from ganet_tpu_torch.parallel.launch import launch
from tests.torch_parity import he_normal_draw, seeded_variables, two_torch_threads  # noqa: F401

H, W = 48, 96
CONV_SHAPES = {"conv": (1, 4, 4, 16, 6), "conv_s2": (1, 4, 4, 16, 6), "deconv": (1, 4, 2, 8, 3)}
CONV_MESHES = {"tp2": (1, 1, 2), "space2_tp2": (1, 2, 2)}
BOUNDARY_OPS = ("column_gather", "row_reduce")
BOUNDARY_DTYPES = ("float64", "bfloat16")
BOUNDARY_SHAPE = (2, 4, 3, 4, 5)
MODEL_MESHES = {"tp2": (1, 1, 2), "space2_tp2": (1, 2, 2)}
MODEL_DTYPES = ("float64", "float32")
F64_TOL = 1e-9
F32_TOL = (1e-3, 1e-5)
JAX_TOL = 2e-4


def _size(mesh) -> int:
    return int(np.prod(mesh))


def _cases(weights_path):
    cases = []
    for op, shape in CONV_SHAPES.items():
        for mname, mesh in CONV_MESHES.items():
            cases.append(dict(name=f"conv_{op}_{mname}", kind="halo", op=op, shape=shape, seed=1,
                              mesh=mesh, channels=True, cout=6, dtype="float64"))
    for op in BOUNDARY_OPS:
        for dt in BOUNDARY_DTYPES:
            cases.append(dict(name=f"boundary_{op}_{dt}", kind="boundary", op=op,
                              shape=BOUNDARY_SHAPE, seed=2, mesh=(1, 1, 2), dtype=dt))
    for mname, mesh in MODEL_MESHES.items():
        for dt in MODEL_DTYPES:
            cases.append(dict(name=f"small_{mname}_{dt}", kind="model", model="GANet_small",
                              mesh=mesh, batch=1, size=(H, W), max_disp=24, dtype=dt, seed=9,
                              channel_tp=True, weights=weights_path))
    cases.append(dict(name="meshless", kind="meshless", model="GANet_small", mesh=(2,), batch=1,
                      size=(H, W), max_disp=24, dtype="float64", seed=11, channel_tp=True))
    return {c["name"]: c for c in cases}


@pytest.fixture(scope="module")
def jax_variables():
    """GANet_small's variables at 48x96, max_disp 24: kernels truncated
    He-normal, every BatchNorm leaf seeded (no JAX init to compile)."""
    jmodel = JGANet(J.ganet_small(24, sga_impl="scan"))
    dummy = jax.ShapeDtypeStruct((1, H, W, 3), jnp.float32)
    shapes = jax.eval_shape(lambda k, a: jmodel.init(k, a, a, train=True), jax.random.PRNGKey(0), dummy)
    return seeded_variables(he_normal_draw(shapes, seed=5), seed=5)


@pytest.fixture(scope="module")
def run(tmp_path_factory, jax_variables):
    """Every case run once, on 2 gloo ranks and on 4: (cases, out_dir)."""
    out_dir = str(tmp_path_factory.mktemp("channel_tp"))
    weights = os.path.join(out_dir, "small.pt")
    torch.save(convert_flax_variables(jax_variables), weights)
    cases = _cases(weights)
    for n in (2, 4):
        todo = [c for c in cases.values() if _size(c["mesh"]) == n]
        launch(K.run_cases, n, (todo, out_dir, "cpu"), backend="gloo", device="cpu")
    return cases, out_dir


CONV_CASES = [f"conv_{op}_{m}" for op in CONV_SHAPES for m in CONV_MESHES]


@pytest.mark.parametrize("name", CONV_CASES)
def test_channel_parallel_conv_matches_the_whole_conv(run, name):
    cases, out_dir = run
    case = cases[name]
    params = {k: torch.from_numpy(v).double() for k, v in K.halo_inputs(case).items()}
    x = params.pop("x").requires_grad_()
    want = K.halo_op(case, x, params)
    want.backward(K.halo_cotangent(case, want.shape).double())
    n = _size(case["mesh"])
    got = K.gather(case, out_dir, n)
    assert got.shape == want.shape and got.dtype == torch.float64
    torch.testing.assert_close(got, want.detach(), rtol=F64_TOL, atol=F64_TOL)
    # column_gather's backward: the ranks' cotangents of the gathered input
    # summed, each rank's block of channels handed back (and the H halos'
    # rows sent back to their owners).
    got_dx = K.gather(case, out_dir, n, "dx")
    torch.testing.assert_close(got_dx, x.grad, rtol=F64_TOL, atol=F64_TOL)


@pytest.mark.parametrize("dtype", BOUNDARY_DTYPES)
@pytest.mark.parametrize("op", BOUNDARY_OPS)
def test_channel_boundary_op_matches_its_definition(run, op, dtype):
    """column_gather: the blocks joined along the channels, and the
    backward this rank's block of the sum of the ranks' cotangents;
    row_reduce: the sum of the ranks' partials on every rank, and the
    backward the (replicated) cotangent itself.  bfloat16 sums in float32,
    rounded once."""
    cases, out_dir = run
    case = cases[f"boundary_{op}_{dtype}"]
    P = 2
    inputs = K.boundary_inputs(case, P)
    dt = getattr(torch, dtype)
    acc = torch.promote_types(dt, torch.float32)
    x = torch.from_numpy(inputs["x"]).to(dt)
    cot = [torch.from_numpy(c).to(dt) for c in inputs["cot"]]
    for p, r in enumerate(K.load(case, out_dir, P)):
        if op == "column_gather":
            n = x.shape[1] // P
            want_out = x
            want_dx = sum(c.to(acc) for c in cot).to(dt)[:, n * p : n * (p + 1)]
        else:
            parts = [torch.from_numpy(v).to(dt) for v in inputs["parts"]]
            want_out, want_dx = sum(v.to(acc) for v in parts).to(dt), cot[p]
        assert r["out"].dtype == r["dx"].dtype == dt
        torch.testing.assert_close(r["out"], want_out, rtol=0, atol=0)
        torch.testing.assert_close(r["dx"], want_dx, rtol=1e-15, atol=1e-15)


@pytest.mark.parametrize("P", [2, 4, 8])
def test_cost_volume_block_of_channels_is_the_whole_volumes_slice(P):
    """The left features are channels [0, C), the shifted right ones
    [C, 2C): a block may hold either or both; with a block of bins too."""
    rng = np.random.default_rng(3)
    left, right = (torch.from_numpy(rng.standard_normal((2, 8, 4, 12))) for _ in range(2))
    D = 8
    whole = build_cost_volume_ncdhw(left, right, D)
    for p in range(P):
        c = (p * 16 // P, (p + 1) * 16 // P)
        assert torch.equal(build_cost_volume_ncdhw(left, right, D, channels=c), whole[:, c[0] : c[1]])
        got = build_cost_volume_ncdhw(left, right, D, 2, 6, channels=c)
        assert torch.equal(got, whole[:, c[0] : c[1], 2:6])


def _ranks_agree(case, out_dir):
    outs = [r["out"].numpy() for r in K.load(case, out_dir, _size(case["mesh"]))]
    assert outs[0].shape == (case["batch"], H, W) and np.isfinite(outs[0]).all()
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    return outs[0]


def _one_device(case, depths=None, widths=None):
    """The one-device forward of the case's weights (`channel_tp` without a
    mesh), recording its 3D convolutions' depths and widths when given
    lists."""
    state = torch.load(case["weights"], weights_only=True)
    model = build_model(K.case_config(case), "cpu", state_dict=state)
    if depths is None:
        return predict(model, *K.model_inputs(case)).numpy()
    with K._Depths(depths, widths):
        return predict(model, *K.model_inputs(case)).numpy()


MODEL_CASES = [f"small_{m}_{dt}" for m in MODEL_MESHES for dt in MODEL_DTYPES]


@pytest.mark.parametrize("name", MODEL_CASES)
def test_channel_tp_forward_matches_one_device(run, name):
    cases, out_dir = run
    case = cases[name]
    got = _ranks_agree(case, out_dir)
    diff = np.abs(got - _one_device(case))
    print(f"{name}: channel TP vs one device max {diff.max():.3e} mean {diff.mean():.3e} px")
    if case["dtype"] == "float64":
        assert diff.max() <= F64_TOL, diff.max()
    else:
        assert diff.max() <= F32_TOL[0] and diff.mean() <= F32_TOL[1], (diff.max(), diff.mean())


def test_channel_tp_forward_matches_jax(run, jax_variables):
    """JAX's channel-TP model over MeshConfig(disp=2), jitted with its
    volumes constrained to C over 'disp', at TestChannelTP's tolerance."""
    cases, out_dir = run
    case = cases["small_tp2_float32"]
    got = _ranks_agree(case, out_dir)
    jcfg = J.TrainConfig(model=J.ganet_small(24, sga_impl="scan", channel_tp=True))
    state = InferenceState(params=jax_variables["params"], batch_stats=jax_variables["batch_stats"])
    want = np.asarray(make_predict_fn(jcfg, j_make_mesh(J.MeshConfig(disp=2)))(
        state, *K.model_inputs(case)))
    diff = np.abs(got - want)
    print(f"small tp2: channel TP vs JAX channel TP max {diff.max():.3e} mean {diff.mean():.3e} px")
    np.testing.assert_allclose(got, want, rtol=JAX_TOL, atol=JAX_TOL)


@pytest.mark.parametrize("name", [f"small_{m}_float64" for m in MODEL_MESHES])
def test_channel_tp_actually_partitions(run, name):
    """In the one device's order, each 3D convolution of each rank makes a
    1/P block of the one device's output channels from all its input
    channels, at every bin; each head's C -> 1 conv reads a 1/P block of
    its input channels."""
    cases, out_dir = run
    case = cases[name]
    P = case["mesh"][2]
    depths, widths = [], []
    _one_device(case, depths, widths)
    heads = 0
    for rank, res in enumerate(K.load(case, out_dir, _size(case["mesh"]))):
        assert res["depths"] == depths, rank
        assert len(res["widths"]) == len(widths) >= 8, rank
        for (cin, cout), (win, wout) in zip(res["widths"], widths):
            if wout == 1:
                heads += 1
                assert (cin, cout) == (win // P, 1), (rank, cin, cout, win)
            else:
                assert (cin, cout) == (win, wout // P), (rank, cin, cout, win, wout)
    assert heads == _size(case["mesh"])  # eval: the final head only


@pytest.mark.parametrize("preset, max_disp, fits", [(ganet_deep, 192, [1, 2, 4, 8, 16]),
                                                    (ganet_small, 24, [1, 2, 4])])
def test_channel_rule(preset, max_disp, fits):
    """Every width of the volumes (GANet_deep: 64, 32, 48, 64, 96;
    GANet_small: 16, 8, 12) splits evenly; max_disp plays no part."""
    cfg = preset(max_disp)
    for tp in range(1, 18):
        if tp in fits:
            check_channel_shape(cfg, tp)
        else:
            with pytest.raises(ValueError, match=re.escape(f"disp may be {fits}")):
                check_channel_shape(cfg, tp)


def test_channel_rule_names_the_sizes_that_pass():
    with pytest.raises(ValueError) as err:
        check_channel_shape(ganet_deep(), 3)
    msg = str(err.value)
    assert "channel_tp over disp 3 cannot split GANet_deep's volumes" in msg
    assert "widths [64, 32, 48, 64, 96]" in msg and "disp may be [1, 2, 4, 8, 16]" in msg


@pytest.mark.parametrize("rank", [0, 1])
def test_model_with_channel_tp_and_no_mesh_ignores_the_world(run, rank):
    cases, out_dir = run
    case = cases["meshless"]
    got = K.load(case, out_dir, 2)[rank]
    want = K.meshless_run(case, rank, "cpu")
    diff = np.abs(got["out"].numpy() - want["out"].numpy())
    assert got["out"].shape == (1, H, W) and diff.max() <= F64_TOL, diff.max()
    assert got["grads"].keys() == want["grads"].keys()
    for name, g in want["grads"].items():
        torch.testing.assert_close(got["grads"][name], g, rtol=1e-9, atol=1e-9 * float(g.abs().max()),
                                   msg=name)
