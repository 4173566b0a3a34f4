"""Data-parallel training of the port on 2 ranks of `torch.distributed`
over gloo, on the CPU, against the port's one-process step on the same
global batch and against JAX's `make_train_step` over `MeshConfig(data=2)`
on 2 of the 8 faked CPU devices of conftest.

The ranks are started once for the module (`parallel/launch.py`, spawn)
and run every case (`parallel/dp_cases.py`, which lives in the port so that
the children import neither this module nor JAX); each case is then its
own tests here.  GANet_small at 48x96, max_disp 12, global batch 4 (2 a
rank): with remat none and valid masks that differ between the ranks'
halves (a mean of per-rank means weighs their pixels wrongly), and with
remat sga (the recompute's BatchNorm all-reduces run in the autograd
engine's thread) and `left_right` (each rank stacks its two views;
BatchNorm covers both views of the global batch); each in float32 for
one step and in float64 for two.  `bn_train` alone: its output, input
gradient, parameter gradients and running statistics.

Tolerances: rtol 1e-5, the bound `__graft_entry__.py` asserts for the loss
of JAX's mesh against one device, norm-relative for tensors.  In float32
the 2 ranks and one process sum the same terms in other groupings: the
first step's loss and metrics agree bit for bit and its running
statistics within 1e-7, but the gradients of the scale and bias of a
layer re-normalised downstream nearly cancel (worst 0.23-0.68
norm-relative apart after 3 steps), and Adam moves each element by lr
times the sign of its gradient, so an element within the noise of 0 moves
either way: after 3 steps the parameters read up to 0.18 apart and the
second step's loss 1.4e-5 (measured on these cases).  So the parameters,
the gradients and the later steps are held in float64, where the same
comparison reads 1e-13 after 3 steps: a fault of the algorithm (a
per-rank mean, local BatchNorm moments, an unsummed gradient) moves them
by 1e-3 or more.  The parameters are the same bits on both ranks.
Against JAX (one float32 step, global batch 2 from
`tests/test_torch_train.py`'s fixed draw of the weights): the loss within
1e-6 and the parameters within 3e-4 per parameter and 1e-4 over all,
norm-relative, JAX's own float32 noise floor on this draw
(`tests/test_torch_train.py`, `tests/test_torch_trainer.py`).
"""

import functools

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
from ganet_tpu_torch.convert import convert_flax_variables
from ganet_tpu_torch.parallel.launch import launch
from ganet_tpu_torch.parallel import dp_cases as K
from tests.torch_parity import he_normal_draw, seeded_variables, two_torch_threads  # noqa: F401

RANKS = 2
H, W, D = 48, 96, 12
RTOL = 1e-5
SMALL = dict(kind="step", model="GANet_small", size=(H, W), max_disp=D, batch=4)

STEPS = {"float32": 1, "float64": 2}
CASES = {
    **{f"none_unequal_{dt}": dict(SMALL, remat="none", valid="unequal", seed=1, dtype=dt, steps=n)
       for dt, n in STEPS.items()},
    **{f"sga_left_right_{dt}": dict(SMALL, remat="sga", left_right=True, seed=2, dtype=dt, steps=n)
       for dt, n in STEPS.items()},
    "bn": dict(kind="bn", shape=(4, 3, 2, 5, 6), seed=3),
}
STEP_CASES = [n for n, c in CASES.items() if c["kind"] == "step"]
F64_CASES = [n for n in STEP_CASES if n.endswith("float64")]


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


@pytest.fixture(scope="module")
def jax_weights(tmp_path_factory):
    """GANet_small's variables at 48x96, max_disp 12, as
    tests/test_torch_train.py draws them (kernels truncated He-normal,
    every BatchNorm leaf seeded), and the path of their port state_dict."""
    jmodel = JGANet(J.ganet_small(D, sga_impl="scan"))
    dummy = jax.ShapeDtypeStruct((1, H, W, 3), jnp.float32)
    shapes = jax.eval_shape(lambda k, a: jmodel.init(k, a, a, train=True), jax.random.PRNGKey(0), dummy)
    variables = seeded_variables(he_normal_draw(shapes))
    path = tmp_path_factory.mktemp("weights") / "small.pt"
    torch.save(convert_flax_variables(variables), path)
    return variables, str(path)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_weights):
    """Every case run once on 2 gloo ranks on the CPU: name -> the ranks'
    results."""
    cases = dict(CASES, jax=dict(SMALL, remat="none", batch=2, steps=1, weights=jax_weights[1]))
    out_dir = str(tmp_path_factory.mktemp("ddp"))
    launch(K.run_cases, RANKS, (list(dict(c, name=n) for n, c in cases.items()), out_dir, "cpu"),
           backend="gloo", device="cpu")
    return {n: K.load(dict(c, name=n), out_dir, RANKS) for n, c in cases.items()}


@functools.lru_cache(maxsize=None)
def _reference(name):
    return K.reference(CASES[name], "cpu")


@pytest.mark.parametrize("name", STEP_CASES)
def test_loss_and_metrics_match_one_device(ranks, name):
    ref = _reference(name)
    for res in ranks[name]:
        np.testing.assert_allclose(res["losses"], ref["losses"], rtol=RTOL)
        for k, v in ref["metrics"].items():
            np.testing.assert_allclose(res["metrics"][k], v, rtol=RTOL, err_msg=k)


@pytest.mark.parametrize("name", F64_CASES)
def test_parameters_match_one_device(ranks, name):
    ref = _reference(name)["state"]
    got = ranks[name][0]["state"]
    params = [k for k in ref if "running" not in k and "num_batches" not in k]
    assert len(params) > 50 and sorted(got) == sorted(ref)
    worst = max((_rel(got[k], ref[k]), k) for k in params)
    assert worst[0] <= RTOL, worst


@pytest.mark.parametrize("name", F64_CASES)
def test_global_gradients_match_one_device(ranks, name):
    """The last step's gradients, summed over the ranks, are the global
    batch's."""
    ref = _reference(name)["grads"]
    for res in ranks[name]:
        assert sorted(res["grads"]) == sorted(ref)
        worst = max((_rel(res["grads"][k], ref[k]), k) for k in ref)
        assert worst[0] <= RTOL, worst


@pytest.mark.parametrize("name", STEP_CASES)
def test_running_statistics_match_one_device(ranks, name):
    ref = _reference(name)["state"]
    got = ranks[name][0]["state"]
    stats = [k for k in ref if "running" in k]
    assert len(stats) > 20
    worst = max((_rel(got[k], ref[k]), k) for k in stats)
    assert worst[0] <= RTOL, worst
    steps = CASES[name]["steps"]
    assert all(got[k].item() == steps for k in ref if k.endswith("num_batches_tracked"))


@pytest.mark.parametrize("name", STEP_CASES + ["jax"])
def test_ranks_hold_the_same_bits(ranks, name):
    first, *others = ranks[name]
    for res in others:
        assert res["digest"] == first["digest"]
        assert res["losses"] == first["losses"]
        assert all(torch.equal(res["state"][k], v) for k, v in first["state"].items())


def test_unequal_valid_counts_weigh_by_pixel(ranks):
    """The case whose ranks hold different valid counts: the metrics are
    the global batch's."""
    batch = K.batches(CASES["none_unequal_float32"])[0]
    halves = [batch["valid"][:2].sum(), batch["valid"][2:].sum()]
    assert halves[0] > 1.4 * halves[1]
    assert ranks["none_unequal_float32"][0]["metrics"]["valid_px"] == sum(halves)


def test_bn_train_moments_and_gradients_match_one_device(ranks):
    ref = _reference("bn")
    res = ranks["bn"]
    for key in ("y", "dx"):
        np.testing.assert_allclose(torch.cat([r[key] for r in res]).numpy(), ref[key].numpy(),
                                   rtol=RTOL, atol=1e-6, err_msg=key)
    for r in res:
        for key in ("dweight", "dbias"):
            np.testing.assert_allclose(r[key].numpy(), ref[key].numpy(), rtol=RTOL, atol=1e-6,
                                       err_msg=key)
        for k, v in ref["state"].items():
            np.testing.assert_allclose(r["state"][k].numpy(), v.numpy(), rtol=RTOL, atol=1e-7,
                                       err_msg=k)
        assert r["state"]["num_batches_tracked"].item() == 1


@pytest.fixture(scope="module")
def jax_step(jax_weights):
    """One step of JAX's `make_train_step` over MeshConfig(data=2) with
    optax's Adam, on the jax case's global batch: (loss, port state_dict
    of the updated variables)."""
    variables = jax_weights[0]
    case = dict(SMALL, remat="none", batch=2, steps=1)
    jcfg = J.TrainConfig(model=J.ganet_small(D, sga_impl="scan"),
                         data=J.DataConfig(crop_height=H, crop_width=W, kind="synthetic"),
                         mesh=J.MeshConfig(data=RANKS), batch_size=case["batch"])
    state = JTrainState.create(apply_fn=JGANet(jcfg.model).apply, params=variables["params"],
                               batch_stats=variables["batch_stats"], tx=j_make_optimizer(jcfg.optim))
    batch = K.batches(case)[0]
    mesh = j_make_mesh(jcfg.mesh)
    with mesh:
        new_state, metrics = j_make_train_step(jcfg, mesh, BATCH_KEYS)(
            state, {k: batch[k] for k in BATCH_KEYS})
    updated = convert_flax_variables(jax.device_get(
        {"params": new_state.params, "batch_stats": new_state.batch_stats}))
    return float(metrics["loss"]), updated


def test_two_ranks_match_jax_data_mesh(ranks, jax_step):
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
