"""Spatially sharded training of the port (the image height split over the
mesh's `space` axis, alone and with `data`) on ranks of
`torch.distributed` over gloo, on the CPU, against the port's one-process
step on the same global batch and against JAX's `make_train_step(cfg,
mesh)` over `MeshConfig(data=2, space=2)` on 4 of the 8 faked CPU devices
of conftest; and `dryrun_multichip`, the port's counterpart of the repo's
`__graft_entry__.dryrun_multichip`.

The ranks are started once for the module (`parallel/launch.py`, spawn),
2 for the mesh (1, 2, 1) and 4 for (2, 2, 1), and run every case
(`parallel/dp_cases.py`, which lives in the port so that the children
import neither this module nor JAX).  GANet_small at 48x96, max_disp 12,
global batch 4, two steps in float64: under remat none, sga and full; with
valid masks that differ between the row blocks (the second half of the
batch loses the valid pixels of its top 16 rows, all in the first block
of 24) and between the `data` halves; one case with `left_right`.  The
one-process reference runs remat none: remat recomputes the same ops and
changes no bit (tests/test_torch_remat.py), so one reference serves every
policy.

Tolerances.  In float64 the sharded step is the one-process step within
1e-9 (it reads 2e-14 to 8e-12 after two steps: the sharded path sums in
other orders only in the SGA sweeps, the upsample's coordinates and the
all-reduces), norm-relative for tensors: a sum over the wrong group
moves them by 1e-3 or more (the aggregation's BatchNorm over `data`
alone, the gradients left unsummed, the targets' rows of the other
block: the second loss 3e-3 to 1e-2 apart, a gradient 1.9-2.6 apart,
checked on mutated copies).  Against JAX (one float32 step,
global batch 2, JAX's weight draw as `tests/test_torch_ddp.py` makes it):
the loss within 1e-6 and the parameters within 3e-4 per parameter and
1e-4 over all, the running statistics within 1e-5, the bounds
`tests/test_torch_ddp.py` states (JAX's own float32 noise floor).
"""

import dataclasses
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
from ganet_tpu_torch.train.trainer import check_train_shape
from tests.torch_parity import he_normal_draw, seeded_variables, two_torch_threads  # noqa: F401

H, W, D = 48, 96, 12
TOL = 1e-9
SMALL = dict(kind="step", model="GANet_small", size=(H, W), max_disp=D, batch=4, dtype="float64",
             steps=2)
UNEQUAL = dict(SMALL, valid="unequal", seed=1)
LEFT_RIGHT = dict(SMALL, valid="unequal", left_right=True, seed=2)
CASES = {
    "space2_none": dict(UNEQUAL, mesh=(1, 2), remat="none"),
    "space2_sga": dict(UNEQUAL, mesh=(1, 2), remat="sga"),
    "data2_space2_full": dict(UNEQUAL, mesh=(2, 2), remat="full"),
    "data2_space2_sga_left_right": dict(LEFT_RIGHT, mesh=(2, 2), remat="sga"),
}
JAX_MESH = (2, 2)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


def _ranks(name) -> int:
    data, space = CASES[name]["mesh"] if name in CASES else JAX_MESH
    return data * space


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
    """Every case run once, on 2 gloo ranks (the (1, 2) meshes) and on 4
    (the (2, 2) meshes): name -> the ranks' results."""
    out_dir = str(tmp_path_factory.mktemp("spatial_train"))
    cases = dict(CASES,
                 jax=dict(SMALL, mesh=JAX_MESH, remat="none", dtype="float32", batch=2, steps=1,
                          weights=jax_weights[1]),
                 trainer=dict(kind="trainer", model="GANet_small", size=(H, W), max_disp=D, batch=4,
                              mesh=JAX_MESH))
    named = {n: dict(c, name=n) for n, c in cases.items()}
    for n in (2, 4):
        todo = [c for c in named.values() if c["mesh"][0] * c["mesh"][1] == n]
        launch(K.run_cases, n, (todo, out_dir, "cpu"), backend="gloo", device="cpu")
    return {n: K.load(c, out_dir, c["mesh"][0] * c["mesh"][1]) for n, c in named.items()}


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
    """The last step's gradients, summed over data x space, are the global
    batch's: the aggregation's from each rank's rows, the 2D part's from
    each rank's rows of the cost volume and guidance."""
    ref = _reference_of(name)["grads"]
    for res in ranks[name]:
        assert sorted(res["grads"]) == sorted(ref)
        worst = max((_rel(res["grads"][k], ref[k]), k) for k in ref)
        assert worst[0] <= TOL, worst


@pytest.mark.parametrize("name", list(CASES))
def test_running_statistics_match_one_device(ranks, name):
    """The 2D part's moments over `data`, the aggregation's over data x
    space: both the global tensor's."""
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


def test_valid_counts_differ_between_row_blocks(ranks):
    """The unequal cases' row blocks hold different valid counts, and the
    metrics count the global batch's pixels."""
    batch = K.batches(CASES["space2_none"])[1]
    top, bottom = batch["valid"][:, : H // 2].sum(), batch["valid"][:, H // 2 :].sum()
    assert bottom > 1.4 * top
    for name in ("space2_none", "data2_space2_full"):
        assert ranks[name][0]["metrics"]["valid_px"] == batch["valid"].sum()


def test_ranks_of_a_space_line_read_one_batch(ranks):
    """`Trainer` on (2, 2): the ranks of a `space` line read the same batch
    (crops included) and the two lines other slices; its first-step check
    raises on every rank of a line whose ranks hold different batches."""
    res = ranks["trainer"]
    assert [r["index"] for r in res] == [{"data": d, "space": s, "disp": 0}
                                         for d in range(2) for s in range(2)]
    assert res[0]["digest"] == res[1]["digest"] and res[2]["digest"] == res[3]["digest"]
    assert res[0]["digest"] != res[2]["digest"]
    assert all(r["raised"] and "read different batches" in r["raised"] for r in res)
    assert all(r["step"] == 1 for r in res) and len({r["state_digest"] for r in res}) == 1


@pytest.fixture(scope="module")
def jax_step(jax_weights):
    """One step of JAX's `make_train_step` over MeshConfig(data=2, space=2)
    with the model built on the mesh (the wavefront SGA, the halo LGA) and
    optax's Adam, on the jax case's global batch: (loss, port state_dict
    of the updated variables)."""
    variables = jax_weights[0]
    data, space = JAX_MESH
    jcfg = J.TrainConfig(model=J.ganet_small(D, sga_impl="scan"),
                         data=J.DataConfig(crop_height=H, crop_width=W, kind="synthetic"),
                         mesh=J.MeshConfig(data=data, space=space), batch_size=2)
    mesh = j_make_mesh(jcfg.mesh)
    state = JTrainState.create(apply_fn=JGANet(jcfg.model, mesh=mesh).apply,
                               params=variables["params"], batch_stats=variables["batch_stats"],
                               tx=j_make_optimizer(jcfg.optim))
    batch = K.batches(dict(SMALL, batch=2, steps=1))[0]
    with mesh:
        new_state, metrics = j_make_train_step(jcfg, mesh, BATCH_KEYS)(
            state, {k: batch[k] for k in BATCH_KEYS})
    updated = convert_flax_variables(jax.device_get(
        {"params": new_state.params, "batch_stats": new_state.batch_stats}))
    return float(metrics["loss"]), updated


def test_data2_space2_step_matches_jax(ranks, jax_step):
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


def test_dryrun_multichip_on_four_cpu_ranks(capsys):
    res = dryrun.dryrun_multichip(4, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip ok: mesh={'data': 2, 'space': 2, 'disp': 1} "), line
    assert "predict_sharded ok shape=(4, 48, 96)" in line
    d = float(re.search(r"mesh_invariance \|d\|=(\S+)", line).group(1))
    assert np.isfinite(res["loss"]) and d <= 1e-5 * abs(res["ref_loss"])


@pytest.mark.parametrize("n, mesh", [(1, (1, 1, 1)), (2, (2, 1, 1)), (3, (3, 1, 1)), (4, (2, 2, 1)),
                                     (6, (6, 1, 1)), (8, (2, 2, 2)), (12, (6, 2, 1)),
                                     (16, (2, 4, 2))])
def test_dryrun_mesh_follows_the_jax_rule(n, mesh):
    assert dryrun.dryrun_mesh(n) == C.MeshConfig(*mesh)


def test_dryrun_of_eight_raises_before_any_rank_starts():
    """The disp branch (n a multiple of 8), which raised before any rank
    started while the port had no `disp` axis, now runs
    (tests/test_torch_disp_train.py runs n = 8): its mesh and config are
    those of the repo's `__graft_entry__.dryrun_multichip`, field for
    field, and pass the port's shape rules."""
    for n, (data, space) in ((8, (2, 2)), (16, (2, 4)), (24, (6, 2))):
        mesh = dryrun.dryrun_mesh(n)
        assert (mesh.data, mesh.space, mesh.disp) == (data, space, 2)
        cfg = dryrun.dryrun_config(mesh)
        ref = J.TrainConfig(model=J.ganet_small(max_disp=24),
                            data=J.DataConfig(crop_height=48, crop_width=96, kind="synthetic"),
                            mesh=J.MeshConfig(data=data, space=space, disp=2), batch_size=2 * data)
        mine, theirs = dataclasses.asdict(cfg), dataclasses.asdict(ref)
        j_model = theirs.pop("model")
        assert mine.pop("model") == {
            **{k: v for k, v in j_model.items() if k != "sga_impl"},
            "impl": {"pallas": "kernel", "scan": "torch", "auto": "auto"}[j_model["sga_impl"]]}
        assert not j_model["channel_tp"]
        assert {k: v for k, v in mine.items() if k != "save_path"} == {
            k: v for k, v in theirs.items() if k != "save_path"}
        check_train_shape(cfg)


@pytest.mark.parametrize("model, height, space", [("GANet_deep", 240, 4), ("GANet_small", 48, 3)])
def test_trainer_refuses_a_height_space_cannot_share(model, height, space):
    """Before any rank or step: the shape rule's ValueError names the sizes
    that pass."""
    cfg = C.TrainConfig(model=C.model_config(model, max_disp=24),
                        data=C.DataConfig(crop_height=height, crop_width=96, kind="synthetic"),
                        mesh=C.MeshConfig(space=space), batch_size=2)
    with pytest.raises(ValueError, match="space may be"):
        Trainer(cfg, device="cpu")
