"""The port's H-sharded inference (`parallel/spatial.py`, `models/ganet.py`
with a mesh, `entry.predict`) on 4 ranks of `torch.distributed` over gloo,
on the CPU, against the unsharded ops, the port's one-device forward and
the JAX package's `make_predict_fn(cfg, mesh)` on 4 of the 8 faked CPU
devices of conftest.

The ranks are started once for the module (`parallel/launch.py`, spawn)
and run every case (`parallel/spatial_cases.py`, which lives in the port so
that the children import neither this module nor JAX) on the meshes
(data, space) = (1, 4) and (2, 2): `space` 4, and `space` 2 on each of two
`data` lines.

  * The halo ops (3D conv at stride 1 and 2 with a folded BatchNorm scale,
    a 2D conv, the deconvolution, the trilinear x3 upsample) against the
    whole-volume op, forward and the gradient with respect to the input
    (the exchanges' backward): within 1e-5.
  * GANet_small at 48x96, max_disp 24, with JAX's weights (kernels
    truncated He-normal, every BatchNorm leaf seeded) converted: `space` 4
    at batch 1 and `data` 2 x `space` 2 at batch 2; GANet_deep at 48x96,
    max_disp 24, `space` 2 at batch 1 (the batch replicated over `data`),
    the only case whose three hourglass levels and deconvolutions cross
    the shards; every rank returns the whole disparity, the same bits.
    In float64 the sharded forward is the one-device forward within 1e-9
    px (it reads 6e-14 to 2.2e-13: the sharded path sums in other orders
    only in the SGA sweeps and the upsample's coordinates), which any halo
    fault would break by whole px.  In float32 it is within 1e-3 px at the
    worst pixel and 1e-5 px on average of the one-device forward (it reads
    6.3e-5 to 9.3e-5 and 1.4e-6 to 1.9e-6), and within 2e-3 px and 1e-4 px
    of JAX's sharded forward (4.2e-4 and 5.3e-4; 5.9e-6 and 6.3e-6 on
    average): the float32 noise of the forward, which the softmax over 24
    bins amplifies.  JAX's own sharded forward reads 4.8e-5 to 1.1e-4 px
    from its one-device forward at these shapes, and the port's one-device
    forward 5.1e-4 to 9.6e-4 px from JAX's (tests/test_torch_models.py
    holds that at 1e-3 px), so no float32 bound below about 1e-3 px at the
    worst pixel holds across the two frameworks (`-s` prints the numbers).
  * The shape rule (`check_spatial_shape`) names the sizes that pass.
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
from ganet_tpu_torch.parallel import spatial_cases as K
from ganet_tpu_torch.parallel.launch import launch
from ganet_tpu_torch.parallel.spatial import check_spatial_shape
from tests.torch_parity import he_normal_draw, seeded_variables, two_torch_threads  # noqa: F401

RANKS = 4
H, W, D = 48, 96, 24
MESHES = {"space4": (1, 4), "space2": (2, 2)}
HALO_SHAPES = {
    "conv": (1, 3, 4, 16, 6),
    "conv_s2": (1, 3, 4, 16, 6),
    "conv2d": (2, 3, 16, 5),
    "deconv": (1, 3, 2, 16, 3),
    "upsample": (1, 2, 8, 4),
}
HALO_TOL = dict(rtol=1e-5, atol=1e-5)
# name -> (model, mesh, batch, weights: "jax" or the port's seeded init)
MODELS = {
    "small_space4": ("GANet_small", (1, 4), 1, "jax"),
    "small_data2_space2": ("GANet_small", (2, 2), 2, "jax"),
    "deep_space2": ("GANet_deep", (2, 2), 1, "init"),
}
DTYPES = ("float32", "float64")
# float32: (worst pixel, mean) in px; float64: worst pixel.
ONE_DEVICE_TOL = {"float32": (1e-3, 1e-5), "float64": (1e-9, 1e-9)}
JAX_TOL = (2e-3, 1e-4)


def _cases(weights_path):
    cases = []
    for op, shape in HALO_SHAPES.items():
        for mname, mesh in MESHES.items():
            cases.append(dict(name=f"halo_{op}_{mname}", kind="halo", op=op, shape=shape, seed=1,
                              mesh=mesh))
    for name, (model, mesh, batch, weights) in MODELS.items():
        for dt in DTYPES:
            case = dict(name=f"{name}_{dt}", kind="model", model=model, mesh=mesh, batch=batch,
                        size=(H, W), max_disp=D, dtype=dt, seed=7)
            if weights == "jax":
                case["weights"] = weights_path
            cases.append(case)
    return {c["name"]: c for c in cases}


@pytest.fixture(scope="module")
def jax_variables():
    """GANet_small's variables at 48x96, max_disp 24: kernels truncated
    He-normal, every BatchNorm leaf seeded (no JAX init to compile)."""
    jmodel = JGANet(J.ganet_small(D, sga_impl="scan"))
    dummy = jax.ShapeDtypeStruct((1, H, W, 3), jnp.float32)
    shapes = jax.eval_shape(lambda k, a: jmodel.init(k, a, a, train=True), jax.random.PRNGKey(0), dummy)
    return seeded_variables(he_normal_draw(shapes, seed=3), seed=3)


@pytest.fixture(scope="module")
def run(tmp_path_factory, jax_variables):
    """Every case run once on 4 gloo ranks on the CPU: (cases, out_dir)."""
    out_dir = str(tmp_path_factory.mktemp("spatial"))
    weights = os.path.join(out_dir, "small.pt")
    torch.save(convert_flax_variables(jax_variables), weights)
    cases = _cases(weights)
    launch(K.run_cases, RANKS, (list(cases.values()), out_dir, "cpu"), backend="gloo", device="cpu")
    return cases, out_dir


def _whole_op(case):
    """The unsharded op's output and the gradient of <output, cotangent>."""
    params = {k: torch.from_numpy(v) for k, v in K.halo_inputs(case).items()}
    x = params.pop("x").requires_grad_()
    out = K.halo_op(case, x, params)
    out.backward(K.halo_cotangent(case, out.shape))
    return out.detach(), x.grad


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("op", list(HALO_SHAPES))
def test_halo_op_matches_the_whole_op(run, op, mesh):
    cases, out_dir = run
    case = cases[f"halo_{op}_{mesh}"]
    got = K.gather(case, out_dir, RANKS)
    want, _ = _whole_op(case)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, **HALO_TOL)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("op", list(HALO_SHAPES))
def test_halo_op_gradient_matches_the_whole_op(run, op, mesh):
    """The exchanges' backward: halo cotangents sent back to their rows'
    owners; at the image's edges zeros dropped, or (the upsample) summed
    into the repeated edge row."""
    cases, out_dir = run
    case = cases[f"halo_{op}_{mesh}"]
    got = K.gather(case, out_dir, RANKS, "dx")
    _, want = _whole_op(case)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, **HALO_TOL)


def _one_device(case, weights=None):
    state = None if weights is None else torch.load(weights, weights_only=True)
    model = build_model(K.case_config(case), "cpu", state_dict=state)
    return predict(model, *K.model_inputs(case)).numpy()


def _ranks_agree(case, out_dir):
    outs = [r["out"].numpy() for r in K.load(case, out_dir, RANKS)]
    assert outs[0].shape == (case["batch"], H, W) and np.isfinite(outs[0]).all()
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    return outs[0]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", list(MODELS))
def test_sharded_forward_matches_one_device(run, name, dtype):
    cases, out_dir = run
    case = cases[f"{name}_{dtype}"]
    got = _ranks_agree(case, out_dir)
    diff = np.abs(got - _one_device(case, case.get("weights")))
    worst, mean = ONE_DEVICE_TOL[dtype]
    print(f"{name} {dtype}: sharded vs one device max {diff.max():.3e} mean {diff.mean():.3e} px")
    assert diff.max() <= worst and diff.mean() <= mean, (diff.max(), diff.mean())


@pytest.mark.parametrize("name", [n for n, m in MODELS.items() if m[3] == "jax"])
def test_sharded_forward_matches_jax_make_predict_fn(run, jax_variables, name):
    cases, out_dir = run
    case = cases[f"{name}_float32"]
    got = _ranks_agree(case, out_dir)
    data, space = case["mesh"]
    jcfg = J.TrainConfig(model=J.ganet_small(D, sga_impl="scan"))
    state = InferenceState(params=jax_variables["params"], batch_stats=jax_variables["batch_stats"])
    fn = make_predict_fn(jcfg, j_make_mesh(J.MeshConfig(data=data, space=space, disp=1)))
    want = np.asarray(fn(state, *K.model_inputs(case)))
    diff = np.abs(got - want)
    print(f"{name}: sharded vs JAX sharded max {diff.max():.3e} mean {diff.mean():.3e} px")
    assert diff.max() <= JAX_TOL[0] and diff.mean() <= JAX_TOL[1], (diff.max(), diff.mean())


@pytest.mark.parametrize("height, fits", [(576, [1, 2, 3, 4, 6, 8, 12, 24]), (384, [1, 2, 4, 8, 16]),
                                          (48, [1, 2])])
def test_shape_rule_of_ganet_deep(height, fits):
    """H/3 in blocks of a multiple of 8 rows: space divides H/24."""
    cfg = ganet_deep()
    for space in range(1, 26):
        if space in fits:
            check_spatial_shape(cfg, height, space)
        else:
            with pytest.raises(ValueError, match=re.escape(f"space may be {fits}")):
                check_spatial_shape(cfg, height, space)


def test_shape_rule_names_the_sizes_that_pass():
    with pytest.raises(ValueError) as err:
        check_spatial_shape(ganet_deep(), 576, 5)
    msg = str(err.value)
    assert "multiple of 3 * 8 * 5 = 120" in msg and "space may be [1, 2, 3, 4, 6, 8, 12, 24]" in msg
    assert "may be 480 or 720" in msg  # multiples of 240 = lcm(48, 120) around 576
    check_spatial_shape(ganet_small(), 48, 4)  # GANet_small has one level: 48 % 24 == 0
    with pytest.raises(ValueError, match="multiple of 3 \\* 2 \\* 3 = 18"):
        check_spatial_shape(ganet_small(), 48, 3)
