"""The port's disparity-sharded inference (the cost volume's bins split over
the mesh's `disp` axis: `parallel/disparity.py`, the D halos of
`parallel/spatial.py`, the boundary ops of `parallel/comm.py`,
`models/ganet.py` with a mesh) on ranks of `torch.distributed` over gloo,
on the CPU, against the unsharded ops, the port's one-device forward and
JAX's `make_predict_fn(cfg, mesh)` over the same `MeshConfig` on the
faked CPU devices of conftest.

The ranks are started once for the module (`parallel/launch.py`, spawn):
2 for the meshes (data, space, disp) = (1, 1, 2), 4 for (1, 1, 4) and
(1, 2, 2); they run every case of `parallel/spatial_cases.py` (which
lives in the port, so that the children import neither this module nor
JAX).

  * The halo convolutions, 3D at stride 1 with a folded BatchNorm scale
    (the eval BN of a 3D BasicConv), at stride 2, and the deconvolution,
    on `disp` 2 and 4 and on `space` 2 x `disp` 2 (D halos, H halos and
    their corners), against the whole op, forward and the gradient with
    respect to the input: within 1e-5 (float32).
  * `gather_blocks`, `take_block` and `copy_in` on `disp` 2 and 4 against
    their definitions, forward and gradient (float64, exact).
  * The cost volume's block of bins against the whole volume's slice,
    and against JAX's whole volume.
  * GANet_small (JAX's weights, every BatchNorm leaf seeded, converted)
    at 48x96, max_disp 24, and GANet_deep (the port's seeded init) at
    48x96, max_disp 48 (its 16 bins split into blocks of 8, the least
    that its three levels take), over (1, 1, 2) and (1, 2, 2), batch 1;
    every rank returns the whole disparity, the same bits.  In float64
    the sharded forward is the one-device forward within 1e-9 px (it
    reads 0 to 4e-13: the sharded path sums in other orders only in the
    wavefront, the upsample's coordinates and the D-haloed convs' operand
    shapes), which any halo fault would break by whole px.  GANet_small in
    float32 is within 1e-3 px at the worst pixel and 1e-5 px on average
    of the one-device forward, and within 2e-3 px and 1e-4 px of JAX's
    sharded forward: the bounds and the reasons of
    `tests/test_torch_spatial.py`, the float32 noise of the two
    frameworks (`-s` prints the numbers).
  * On every rank every 3D convolution's input holds at most D3 / disp + 2
    bins (the block and its halo), the counterpart of the JAX package's
    `test_disp_axis_actually_partitions`.
  * The disparity rule (`check_disp_shape`) names the sizes that pass.
  * A model built without a mesh (`GANet(cfg)`), run on each of 2 ranks
    of an initialised world on other inputs (as under a DDP wrap), is
    each input's single-process model: its eval disparity and its
    train-mode gradients within 1e-9 in float64.  The boundary ops take
    no group for "not sharded" and never act on the default world.
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
from ganet_tpu.ops.cost_volume import build_cost_volume as j_build_cost_volume
from ganet_tpu.parallel.mesh import make_mesh as j_make_mesh
from ganet_tpu.train.trainer import InferenceState, make_predict_fn
from ganet_tpu_torch.config import ganet_deep, ganet_small
from ganet_tpu_torch.convert import convert_flax_variables
from ganet_tpu_torch.entry import build_model, predict
from ganet_tpu_torch.ops.cost_volume import build_cost_volume_ncdhw
from ganet_tpu_torch.parallel import spatial_cases as K
from ganet_tpu_torch.parallel.disparity import check_disp_shape
from ganet_tpu_torch.parallel.launch import launch
from tests.torch_parity import he_normal_draw, seeded_variables, two_torch_threads  # noqa: F401

H, W = 48, 96
HALO_SHAPES = {"conv": (1, 3, 8, 16, 6), "conv_s2": (1, 3, 8, 16, 6), "deconv": (1, 3, 4, 16, 3)}
HALO_MESHES = {"disp2": (1, 1, 2), "disp4": (1, 1, 4), "space2_disp2": (1, 2, 2)}
HALO_TOL = dict(rtol=1e-5, atol=1e-5)
BOUNDARY_OPS = ("gather", "take", "copy_in")
BOUNDARY_MESHES = {"disp2": (1, 1, 2), "disp4": (1, 1, 4)}
# float64, and bfloat16, the card's dtype, whose blocks travel as bytes.
BOUNDARY_DTYPES = ("float64", "bfloat16")
BOUNDARY_SHAPE = (2, 3, 8, 4, 5)
MODEL_MESHES = {"disp2": (1, 1, 2), "space2_disp2": (1, 2, 2)}
# name -> (preset, max_disp, weights: "jax" or the port's seeded init, dtypes)
MODELS = {"small": ("GANet_small", 24, "jax", ("float64", "float32")),
          "deep": ("GANet_deep", 48, "init", ("float64",))}
# float64: worst pixel; float32: (worst pixel, mean) in px.
F64_TOL = 1e-9
F32_TOL = (1e-3, 1e-5)
JAX_TOL = (2e-3, 1e-4)


def _size(mesh) -> int:
    return int(np.prod(mesh))


def _cases(weights_path):
    cases = []
    for op, shape in HALO_SHAPES.items():
        for mname, mesh in HALO_MESHES.items():
            cases.append(dict(name=f"halo_{op}_{mname}", kind="halo", op=op, shape=shape, seed=1,
                              mesh=mesh))
    for op in BOUNDARY_OPS:
        for mname, mesh in BOUNDARY_MESHES.items():
            for dt in BOUNDARY_DTYPES:
                cases.append(dict(name=f"boundary_{op}_{mname}_{dt}", kind="boundary", op=op,
                                  shape=BOUNDARY_SHAPE, seed=2, mesh=mesh, dtype=dt))
    for name, (model, max_disp, weights, dtypes) in MODELS.items():
        for mname, mesh in MODEL_MESHES.items():
            for dt in dtypes:
                case = dict(name=f"{name}_{mname}_{dt}", kind="model", model=model, mesh=mesh,
                            batch=1, size=(H, W), max_disp=max_disp, dtype=dt, seed=9)
                if weights == "jax":
                    case["weights"] = weights_path
                cases.append(case)
    cases.append(dict(name="meshless", kind="meshless", model="GANet_small", mesh=(2,), batch=1,
                      size=(H, W), max_disp=24, dtype="float64", seed=11))
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
    """Every case run once, on 2 gloo ranks (the meshes of 2) and on 4:
    (cases, out_dir)."""
    out_dir = str(tmp_path_factory.mktemp("disp"))
    weights = os.path.join(out_dir, "small.pt")
    torch.save(convert_flax_variables(jax_variables), weights)
    cases = _cases(weights)
    for n in (2, 4):
        todo = [c for c in cases.values() if _size(c["mesh"]) == n]
        launch(K.run_cases, n, (todo, out_dir, "cpu"), backend="gloo", device="cpu")
    return cases, out_dir


def _whole_op(case):
    """The unsharded op's output and the gradient of <output, cotangent>."""
    params = {k: torch.from_numpy(v) for k, v in K.halo_inputs(case).items()}
    x = params.pop("x").requires_grad_()
    out = K.halo_op(case, x, params)
    out.backward(K.halo_cotangent(case, out.shape))
    return out.detach(), x.grad


@pytest.mark.parametrize("mesh", list(HALO_MESHES))
@pytest.mark.parametrize("op", list(HALO_SHAPES))
def test_d_halo_op_matches_the_whole_op(run, op, mesh):
    cases, out_dir = run
    case = cases[f"halo_{op}_{mesh}"]
    n = _size(case["mesh"])
    want, want_dx = _whole_op(case)
    got = K.gather(case, out_dir, n)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, **HALO_TOL)
    # The exchanges' backward: each halo bin's and row's cotangent sent back
    # to its owner, the corners' over both exchanges.
    got_dx = K.gather(case, out_dir, n, "dx")
    assert got_dx.shape == want_dx.shape
    torch.testing.assert_close(got_dx, want_dx, **HALO_TOL)


@pytest.mark.parametrize("dtype", BOUNDARY_DTYPES)
@pytest.mark.parametrize("mesh", list(BOUNDARY_MESHES))
@pytest.mark.parametrize("op", BOUNDARY_OPS)
def test_boundary_op_matches_its_definition(run, op, mesh, dtype):
    """gather: the blocks joined, and the backward this rank's block of the
    replicated cotangent; take: this rank's block, and the backward every
    block's cotangent joined, on every rank; copy_in: the identity, and the
    backward the sum of the ranks' cotangents (bfloat16 ones summed in
    float32 and rounded once)."""
    cases, out_dir = run
    case = cases[f"boundary_{op}_{mesh}_{dtype}"]
    P = case["mesh"][2]
    inputs = K.boundary_inputs(case, P)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(inputs["x"]).to(dt)
    cot = [torch.from_numpy(c).to(dt) for c in inputs["cot"]]
    res = K.load(case, out_dir, P)
    for p, r in enumerate(res):
        n = x.shape[2] // P
        a, b = n * p, n * (p + 1)
        if op == "gather":
            want_out, want_dx = x, cot[p][:, :, a:b]
        elif op == "take":
            want_out, want_dx = x[:, :, a:b], torch.cat(cot, dim=2)
        else:
            acc = torch.promote_types(dt, torch.float32)
            want_out, want_dx = x, sum(c.to(acc) for c in cot).to(dt)
        assert r["out"].dtype == r["dx"].dtype == dt
        torch.testing.assert_close(r["out"], want_out, rtol=0, atol=0)
        torch.testing.assert_close(r["dx"], want_dx, rtol=1e-15, atol=1e-15)


@pytest.mark.parametrize("P", [2, 4, 8])
def test_cost_volume_block_is_the_whole_volumes_slice(P):
    rng = np.random.default_rng(3)
    left, right = (rng.standard_normal((2, 16, 4, 12), dtype=np.float32) for _ in range(2))
    D = 16
    whole = build_cost_volume_ncdhw(torch.from_numpy(left), torch.from_numpy(right), D)
    jax_whole = np.asarray(j_build_cost_volume(left.transpose(0, 2, 3, 1),
                                               right.transpose(0, 2, 3, 1), D))
    np.testing.assert_array_equal(whole.permute(0, 2, 3, 4, 1).numpy(), jax_whole)
    for p in range(P):
        a, b = p * D // P, (p + 1) * D // P
        block = build_cost_volume_ncdhw(torch.from_numpy(left), torch.from_numpy(right), D, a, b)
        assert torch.equal(block, whole[:, :, a:b])


def _ranks_agree(case, out_dir):
    outs = [r["out"].numpy() for r in K.load(case, out_dir, _size(case["mesh"]))]
    assert outs[0].shape == (case["batch"], H, W) and np.isfinite(outs[0]).all()
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    return outs[0]


def _one_device(case):
    state = torch.load(case["weights"], weights_only=True) if case.get("weights") else None
    model = build_model(K.case_config(case), "cpu", state_dict=state)
    return predict(model, *K.model_inputs(case)).numpy()


MODEL_CASES = [f"{n}_{m}_{dt}" for n, spec in MODELS.items() for m in MODEL_MESHES for dt in spec[3]]


@pytest.mark.parametrize("name", MODEL_CASES)
def test_sharded_forward_matches_one_device(run, name):
    cases, out_dir = run
    case = cases[name]
    got = _ranks_agree(case, out_dir)
    diff = np.abs(got - _one_device(case))
    print(f"{name}: disp-sharded vs one device max {diff.max():.3e} mean {diff.mean():.3e} px")
    if case["dtype"] == "float64":
        assert diff.max() <= F64_TOL, diff.max()
    else:
        assert diff.max() <= F32_TOL[0] and diff.mean() <= F32_TOL[1], (diff.max(), diff.mean())


@pytest.mark.parametrize("rank", [0, 1])
def test_model_without_a_mesh_ignores_the_world(run, rank):
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


@pytest.mark.parametrize("mesh", list(MODEL_MESHES))
def test_sharded_forward_matches_jax_make_predict_fn(run, jax_variables, mesh):
    cases, out_dir = run
    case = cases[f"small_{mesh}_float32"]
    got = _ranks_agree(case, out_dir)
    data, space, disp = case["mesh"]
    jcfg = J.TrainConfig(model=J.ganet_small(24, sga_impl="scan"))
    state = InferenceState(params=jax_variables["params"], batch_stats=jax_variables["batch_stats"])
    fn = make_predict_fn(jcfg, j_make_mesh(J.MeshConfig(data=data, space=space, disp=disp)))
    want = np.asarray(fn(state, *K.model_inputs(case)))
    diff = np.abs(got - want)
    print(f"small {mesh}: disp-sharded vs JAX sharded max {diff.max():.3e} mean {diff.mean():.3e} px")
    assert diff.max() <= JAX_TOL[0] and diff.mean() <= JAX_TOL[1], (diff.max(), diff.mean())


@pytest.mark.parametrize("name", MODEL_CASES)
def test_disp_axis_actually_partitions(run, name):
    """Every 3D convolution and deconvolution on every rank sees at most
    its block of D3 / disp bins and a halo of 2; the head's C -> 1 conv
    too, though the heads then run whole in D."""
    cases, out_dir = run
    case = cases[name]
    cfg = K.case_config(case)
    bound = cfg.disp_channels // case["mesh"][2] + 2
    for rank, res in enumerate(K.load(case, out_dir, _size(case["mesh"]))):
        depths = res["depths"]
        n_convs = 2 * cfg.num_sga_full + 2 * cfg.num_sga_half  # at least the SGA blocks' convs
        assert len(depths) > n_convs, (rank, depths)
        assert max(depths) <= bound < cfg.disp_channels, (rank, sorted(set(depths)), bound)


@pytest.mark.parametrize("preset, max_disp, fits", [(ganet_deep, 192, [1, 2, 4, 8]),
                                                    (ganet_small, 24, [1, 2, 4]),
                                                    (ganet_deep, 48, [1, 2])])
def test_disp_rule(preset, max_disp, fits):
    """max_disp / 3 in blocks of a multiple of 2**agg_levels bins."""
    cfg = preset(max_disp)
    for disp in range(1, 10):
        if disp in fits:
            check_disp_shape(cfg, disp)
        else:
            with pytest.raises(ValueError, match=re.escape(f"disp may be {fits}")):
                check_disp_shape(cfg, disp)


def test_disp_rule_names_the_sizes_that_pass():
    with pytest.raises(ValueError) as err:
        check_disp_shape(ganet_deep(), 3)
    msg = str(err.value)
    assert "disp 3 cannot share max_disp 192" in msg and "multiple of 3 * 8 * 3 = 72" in msg
    assert "disp may be [1, 2, 4, 8]" in msg and "may be 144 or 216" in msg
