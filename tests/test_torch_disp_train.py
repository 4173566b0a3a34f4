"""Disparity-sharded training of the port (the cost volume's bins split over
the mesh's `disp` axis, alone and with `space`) on ranks of
`torch.distributed` over gloo, on the CPU, against the port's one-process
step on the same global batch and against JAX's `make_train_step(cfg,
mesh)` over `MeshConfig(disp=2)` on 2 of the 8 faked CPU devices of
conftest; and `dryrun_multichip(8)`, whose mesh is (2, 2, 2).

The ranks are started once for the module (`parallel/launch.py`, spawn),
2 for the mesh (1, 1, 2) and 4 for (1, 2, 2) and (2, 1, 2), and run every
case (`parallel/dp_cases.py`, in the port so that the children import
neither this module nor JAX).  GANet_small at 48x96, max_disp 12 (4 bins
in blocks of 2), global batch 2, two steps in float64, under remat none
and sga, with valid masks that differ between the row blocks (the second
pair loses the valid pixels of its top 16 rows, `dp_cases.batches`), one
case with `left_right`.  One
reference per seed serves both policies (remat changes no bit,
tests/test_torch_remat.py).

Tolerances.  In float64 the sharded step is the one-process step within
1e-9, norm-relative for tensors (it reads 0 to 4e-14 after two steps:
the sharded path sums in other orders only in the wavefront, the
all-reduces and the D-haloed convs' operand shapes).  A sum over the
wrong group moves a figure by far more, checked on mutated copies: the
aggregation's BatchNorm over `volume_group` alone, the 2D part's
gradient not divided by `disp`, a head conv's gradient not summed over
`disp`, `take_block`'s backward keeping only the local cotangent.  After
the step every rank holds the same bits.  Against JAX (one float32 step,
global batch 2, JAX's weight draw as `tests/test_torch_ddp.py` makes it):
the bounds `tests/test_torch_spatial_train.py` states, JAX's own float32
noise floor (the loss within 1e-6, the parameters within 3e-4 per
parameter and 1e-4 over all, the running statistics within 1e-5).
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ganet_tpu import config as J
from ganet_tpu.models.ganet import GANet as JGANet
from ganet_tpu.parallel.mesh import make_mesh as j_make_mesh
from ganet_tpu.train.state import TrainState as JTrainState
from ganet_tpu.train.state import make_optimizer as j_make_optimizer
from ganet_tpu.train.trainer import BATCH_KEYS
from ganet_tpu.train.trainer import make_train_step as j_make_train_step
from ganet_tpu_torch import config as C
from ganet_tpu_torch import dryrun
from ganet_tpu_torch.convert import convert_flax_variables
from ganet_tpu_torch.parallel import dp_cases as K
from ganet_tpu_torch.parallel.launch import launch
from ganet_tpu_torch.train import Trainer
from tests.torch_parity import he_normal_draw, seeded_variables, two_torch_threads  # noqa: F401

H, W, D = 48, 96, 12
TOL = 1e-9
SMALL = dict(kind="step", model="GANet_small", size=(H, W), max_disp=D, batch=2, dtype="float64",
             steps=2)
UNEQUAL = dict(SMALL, valid="unequal", seed=1)
LEFT_RIGHT = dict(SMALL, valid="unequal", left_right=True, seed=2)
CASES = {
    "disp2_none": dict(UNEQUAL, mesh=(1, 1, 2), remat="none"),
    "disp2_sga": dict(UNEQUAL, mesh=(1, 1, 2), remat="sga"),
    "space2_disp2_none": dict(UNEQUAL, mesh=(1, 2, 2), remat="none"),
    "space2_disp2_sga_left_right": dict(LEFT_RIGHT, mesh=(1, 2, 2), remat="sga"),
}
JAX_MESH = (1, 1, 2)
TRAINER_MESH = (2, 1, 2)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


def _ranks(name) -> int:
    return int(np.prod(CASES[name]["mesh"] if name in CASES else JAX_MESH))


@pytest.fixture(scope="module")
def jax_weights(tmp_path_factory):
    """GANet_small's variables at 48x96, max_disp 12, as
    tests/test_torch_ddp.py draws them, and the path of their port
    state_dict."""
    jmodel = JGANet(J.ganet_small(D, sga_impl="scan"))
    dummy = jax.ShapeDtypeStruct((1, H, W, 3), jnp.float32)
    shapes = jax.eval_shape(lambda k, a: jmodel.init(k, a, a, train=True), jax.random.PRNGKey(0), dummy)
    variables = seeded_variables(he_normal_draw(shapes))
    path = tmp_path_factory.mktemp("weights") / "small.pt"
    torch.save(convert_flax_variables(variables), path)
    return variables, str(path)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_weights):
    """Every case run once, on 2 gloo ranks (the (1, 1, 2) meshes) and on 4
    (the (1, 2, 2) and (2, 1, 2) meshes): name -> the ranks' results."""
    out_dir = str(tmp_path_factory.mktemp("disp_train"))
    cases = dict(CASES,
                 jax=dict(SMALL, mesh=JAX_MESH, remat="none", dtype="float32", steps=1,
                          weights=jax_weights[1]),
                 trainer=dict(kind="trainer", model="GANet_small", size=(H, W), max_disp=D, batch=4,
                              mesh=TRAINER_MESH))
    named = {n: dict(c, name=n) for n, c in cases.items()}
    for n in (2, 4):
        todo = [c for c in named.values() if np.prod(c["mesh"]) == n]
        launch(K.run_cases, n, (todo, out_dir, "cpu"), backend="gloo", device="cpu")
    return {n: K.load(c, out_dir, int(np.prod(c["mesh"]))) for n, c in named.items()}


@functools.lru_cache(maxsize=None)
def _reference(seed, left_right):
    """The one-process step of the cases with this seed and `left_right`."""
    case = dict(LEFT_RIGHT if left_right else UNEQUAL, remat="none")
    assert case["seed"] == seed
    return K.reference(case, "cpu")


def _reference_of(name):
    case = CASES[name]
    return _reference(case["seed"], case.get("left_right", False))


@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_metrics_match_one_device(ranks, name):
    ref = _reference_of(name)
    for res in ranks[name]:
        np.testing.assert_allclose(res["losses"], ref["losses"], rtol=TOL)
        for k, v in ref["metrics"].items():
            np.testing.assert_allclose(res["metrics"][k], v, rtol=TOL, err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_parameters_after_two_steps_match_one_device(ranks, name):
    ref = _reference_of(name)["state"]
    got = ranks[name][0]["state"]
    params = [k for k in ref if "running" not in k and "num_batches" not in k]
    assert len(params) > 50 and sorted(got) == sorted(ref)
    worst = max((_rel(got[k], ref[k]), k) for k in params)
    assert worst[0] <= TOL, worst


@pytest.mark.parametrize("name", list(CASES))
def test_global_gradients_match_one_device(ranks, name):
    """The last step's gradients: the aggregation's summed over the whole
    mesh (each rank's rows and bins, the heads' C -> 1 convs included),
    the 2D part's summed over the mesh and divided by `disp`."""
    ref = _reference_of(name)["grads"]
    for res in ranks[name]:
        assert sorted(res["grads"]) == sorted(ref)
        worst = max((_rel(res["grads"][k], ref[k]), k) for k in ref)
        assert worst[0] <= TOL, worst


@pytest.mark.parametrize("name", list(CASES))
def test_running_statistics_match_one_device(ranks, name):
    """The 2D part's moments over `data`, the aggregation's over the whole
    mesh: both the global tensor's."""
    ref = _reference_of(name)["state"]
    got = ranks[name][0]["state"]
    stats = [k for k in ref if "running" in k]
    assert len(stats) > 20 and any(k.startswith("cost_agg.") for k in stats)
    worst = max((_rel(got[k], ref[k]), k) for k in stats)
    assert worst[0] <= TOL, worst
    assert all(got[k].item() == 2 for k in ref if k.endswith("num_batches_tracked"))


@pytest.mark.parametrize("name", list(CASES) + ["jax"])
def test_ranks_hold_the_same_bits(ranks, name):
    first, *others = ranks[name]
    assert len(others) == _ranks(name) - 1
    for res in others:
        assert res["digest"] == first["digest"]
        assert res["losses"] == first["losses"]
        assert all(torch.equal(res["state"][k], v) for k, v in first["state"].items())
        assert all(torch.equal(res["grads"][k], v) for k, v in first["grads"].items())


def test_ranks_of_a_plane_read_their_data_index_slice(ranks):
    """`Trainer` on (2, 1, 2): the ranks of a `disp` line read the slice of
    their `data` index (the batch iterator's process slice follows the
    data index, not the rank), the two lines other slices; its first-step
    check raises on every rank of a line whose ranks hold different
    batches."""
    res = ranks["trainer"]
    assert [r["index"] for r in res] == [{"data": d, "space": 0, "disp": p}
                                         for d in range(2) for p in range(2)]
    assert res[0]["digest"] == res[1]["digest"] and res[2]["digest"] == res[3]["digest"]
    assert res[0]["digest"] != res[2]["digest"]
    assert all(r["raised"] and "read different batches" in r["raised"] for r in res)
    assert all(r["step"] == 1 for r in res) and len({r["state_digest"] for r in res}) == 1


@pytest.fixture(scope="module")
def jax_step(jax_weights):
    """One step of JAX's `make_train_step` over MeshConfig(disp=2) with the
    model built on the mesh (the conv phase's volumes constrained to
    `P("data", "disp", "space")`) and optax's Adam, on the jax case's
    global batch: (loss, port state_dict of the updated variables)."""
    variables = jax_weights[0]
    jcfg = J.TrainConfig(model=J.ganet_small(D, sga_impl="scan"),
                         data=J.DataConfig(crop_height=H, crop_width=W, kind="synthetic"),
                         mesh=J.MeshConfig(*JAX_MESH), batch_size=2)
    mesh = j_make_mesh(jcfg.mesh)
    state = JTrainState.create(apply_fn=JGANet(jcfg.model, mesh=mesh).apply,
                               params=variables["params"], batch_stats=variables["batch_stats"],
                               tx=j_make_optimizer(jcfg.optim))
    batch = K.batches(dict(SMALL, steps=1))[0]
    with mesh:
        new_state, metrics = j_make_train_step(jcfg, mesh, BATCH_KEYS)(
            state, {k: batch[k] for k in BATCH_KEYS})
    updated = convert_flax_variables(jax.device_get(
        {"params": new_state.params, "batch_stats": new_state.batch_stats}))
    return float(metrics["loss"]), updated


def test_disp2_step_matches_jax(ranks, jax_step):
    loss, want = jax_step
    got = ranks["jax"][0]
    np.testing.assert_allclose(got["losses"][0], loss, rtol=1e-6)
    state = got["state"]
    params = [k for k in want if "running" not in k and "num_batches" not in k]
    worst = max((_rel(state[k], want[k]), k) for k in params)
    assert worst[0] <= 3e-4, worst
    flat = lambda d: torch.cat([d[k].double().flatten() for k in params])  # noqa: E731
    assert _rel(flat(state), flat(want)) <= 1e-4
    stats = [k for k in want if "running" in k]
    worst = max((_rel(state[k], want[k]), k) for k in stats)
    assert worst[0] <= 1e-5, worst


def test_dryrun_multichip_on_eight_cpu_ranks(capsys):
    """n = 8 gives (2, 2, 2): D halos, H halos, their corners, the
    wavefront and BatchNorm over the whole mesh in one step."""
    res = dryrun.dryrun_multichip(8, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip ok: mesh={'data': 2, 'space': 2, 'disp': 2} "), line
    assert "predict_sharded ok shape=(4, 48, 96)" in line
    d = float(re.search(r"mesh_invariance \|d\|=(\S+)", line).group(1))
    assert np.isfinite(res["loss"]) and d <= 1e-5 * abs(res["ref_loss"])


@pytest.mark.parametrize("model, max_disp, disp, fits", [("GANet_deep", 192, 3, "[1, 2, 4, 8]"),
                                                          ("GANet_small", 24, 8, "[1, 2, 4]")])
def test_trainer_refuses_a_max_disp_disp_cannot_share(model, max_disp, disp, fits):
    """Before any rank or step: the disparity rule's ValueError names the
    sizes that pass."""
    cfg = C.TrainConfig(model=C.model_config(model, max_disp=max_disp),
                        data=C.DataConfig(crop_height=48, crop_width=96, kind="synthetic"),
                        mesh=C.MeshConfig(disp=disp), batch_size=2)
    with pytest.raises(ValueError, match=re.escape(f"disp may be {fits}")):
        Trainer(cfg, device="cpu")
