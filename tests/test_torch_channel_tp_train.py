"""Channel tensor parallelism in training (`ModelConfig.channel_tp`: the
mesh's `disp` axis splits the aggregation's channels, alone and with
`space`) on ranks of `torch.distributed` over gloo, on the CPU, against
the port's one-process step on the same global batch and against JAX's
`make_train_step(cfg, mesh)` with `channel_tp` over `MeshConfig(disp=2)`
on 2 of the 8 faked CPU devices of conftest; a `Trainer` on (2, 1, 2);
and the train CLI with `--mesh_disp 2 --channel_tp 1`.

The ranks are started once for the module (`parallel/launch.py`, spawn),
2 for the mesh (1, 1, 2) and 4 for (1, 2, 2) and (2, 1, 2), and run every
case (`parallel/dp_cases.py`).  GANet_small at 48x96, max_disp 12, global
batch 2, two steps in float64, with valid masks that differ between the
row blocks (`dp_cases.batches`): over (1, 1, 2) under remat none and sga,
over (1, 2, 2) under remat sga with `left_right`.  One reference per
seed serves both policies.

Tolerances.  In float64 the sharded step is the one-process step within
1e-9, norm-relative for tensors (it reads about 1e-14: the sharded path
sums in other orders only in the reduce-scatter of `column_gather`'s
backward, the heads' partial convs, the all-reduces and the wavefront).
The rules that keep it so were each broken on a mutated copy, and each
moved a float64 check here by far more: the aggregation's BatchNorm over
the whole mesh, `gather_blocks`' backward in the convs' gather, a head
conv's gradient counted P times or not summed, the running statistics
left unsynchronised.  After every step every rank holds the same bits in
every parameter and buffer.  Against JAX (one float32 step, global batch
2): the loss within rtol 1e-5 (TestChannelTP's), the parameters and the
running statistics within the bounds of `tests/test_torch_disp_train.py`.
"""

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ganet_tpu_torch.predict as t_predict
from ganet_tpu import config as J
from ganet_tpu.models.ganet import GANet as JGANet
from ganet_tpu.parallel.mesh import make_mesh as j_make_mesh
from ganet_tpu.train.state import TrainState as JTrainState
from ganet_tpu.train.state import make_optimizer as j_make_optimizer
from ganet_tpu.train.trainer import BATCH_KEYS
from ganet_tpu.train.trainer import make_train_step as j_make_train_step
from ganet_tpu_torch import config as C
from ganet_tpu_torch.convert import convert_flax_variables
from ganet_tpu_torch.parallel import dp_cases as K
from ganet_tpu_torch.parallel.launch import launch
from ganet_tpu_torch.train import Trainer, main
from ganet_tpu_torch.train.checkpoint import load_inference_state
from tests.torch_parity import he_normal_draw, seeded_variables, two_torch_threads  # noqa: F401

H, W, D = 48, 96, 12
TOL = 1e-9
SMALL = dict(kind="step", model="GANet_small", size=(H, W), max_disp=D, batch=2, dtype="float64",
             steps=2, channel_tp=True)
UNEQUAL = dict(SMALL, valid="unequal", seed=1)
LEFT_RIGHT = dict(SMALL, valid="unequal", left_right=True, seed=2)
CASES = {
    "tp2_none": dict(UNEQUAL, mesh=(1, 1, 2), remat="none"),
    "tp2_sga": dict(UNEQUAL, mesh=(1, 1, 2), remat="sga"),
    "space2_tp2_sga_left_right": dict(LEFT_RIGHT, mesh=(1, 2, 2), remat="sga"),
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
    out_dir = str(tmp_path_factory.mktemp("channel_tp_train"))
    cases = dict(CASES,
                 jax=dict(SMALL, mesh=JAX_MESH, remat="none", dtype="float32", steps=1,
                          weights=jax_weights[1]),
                 trainer=dict(kind="trainer", model="GANet_small", size=(H, W), max_disp=D, batch=4,
                              mesh=TRAINER_MESH, channel_tp=True))
    named = {n: dict(c, name=n) for n, c in cases.items()}
    for n in (2, 4):
        todo = [c for c in named.values() if np.prod(c["mesh"]) == n]
        launch(K.run_cases, n, (todo, out_dir, "cpu"), backend="gloo", device="cpu")
    return {n: K.load(c, out_dir, int(np.prod(c["mesh"]))) for n, c in named.items()}


@functools.lru_cache(maxsize=None)
def _reference(seed, left_right):
    """The one-process step of the cases with this seed and `left_right`
    (`channel_tp` without a mesh: nothing is split)."""
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
    """The last step's gradients: each rank's blocks of the aggregation's
    weights (its output channels' for a 3D conv and its BatchNorm, its
    input channels' for a head) summed over the whole mesh, the 2D
    part's summed over the mesh and divided by `disp`."""
    ref = _reference_of(name)["grads"]
    for res in ranks[name]:
        assert sorted(res["grads"]) == sorted(ref)
        worst = max((_rel(res["grads"][k], ref[k]), k) for k in ref)
        assert worst[0] <= TOL, worst


@pytest.mark.parametrize("name", list(CASES))
def test_running_statistics_match_one_device(ranks, name):
    """The 2D part's moments over `data`, the aggregation's blocks over
    `data` x `space` and gathered over `disp`: the global tensor's."""
    ref = _reference_of(name)["state"]
    got = ranks[name][0]["state"]
    stats = [k for k in ref if "running" in k]
    assert len(stats) > 20 and any(k.startswith("cost_agg.") for k in stats)
    worst = max((_rel(got[k], ref[k]), k) for k in stats)
    assert worst[0] <= TOL, worst
    assert all(got[k].item() == 2 for k in ref if k.endswith("num_batches_tracked"))


@pytest.mark.parametrize("name", list(CASES) + ["jax"])
def test_ranks_hold_the_same_bits(ranks, name):
    """Parameters and buffers (running statistics, batch counts) alike."""
    first, *others = ranks[name]
    assert len(others) == _ranks(name) - 1
    for res in others:
        assert res["digest"] == first["digest"]
        assert res["losses"] == first["losses"]
        assert all(torch.equal(res["state"][k], v) for k, v in first["state"].items())
        assert all(torch.equal(res["grads"][k], v) for k, v in first["grads"].items())


def test_trainer_on_data_and_channels(ranks):
    """`Trainer` on (2, 1, 2) with `channel_tp`: the ranks of a `disp` line
    read the slice of their `data` index, the two lines other slices; its
    first-step check raises on every rank of a line whose ranks hold
    different batches; one step leaves every rank the same state."""
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
    channel-TP model built on the mesh (the conv phase's volumes
    constrained to `P("data", None, "space", None, "disp")`) and optax's
    Adam, on the jax case's global batch: (loss, port state_dict of the
    updated variables)."""
    variables = jax_weights[0]
    jcfg = J.TrainConfig(model=J.ganet_small(D, sga_impl="scan", channel_tp=True),
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


def test_channel_tp_step_matches_jax(ranks, jax_step):
    loss, want = jax_step
    got = ranks["jax"][0]
    np.testing.assert_allclose(got["losses"][0], loss, rtol=1e-5)
    state = got["state"]
    params = [k for k in want if "running" not in k and "num_batches" not in k]
    worst = max((_rel(state[k], want[k]), k) for k in params)
    assert worst[0] <= 3e-4, worst
    flat = lambda d: torch.cat([d[k].double().flatten() for k in params])  # noqa: E731
    assert _rel(flat(state), flat(want)) <= 1e-4
    stats = [k for k in want if "running" in k]
    worst = max((_rel(state[k], want[k]), k) for k in stats)
    assert worst[0] <= 1e-5, worst


CLI = ["--model", "GANet_small", "--synthetic_data", "1", "--crop_height", "48", "--crop_width",
       "96", "--max_disp", "24"]


def test_train_cli_with_channel_tp_and_predict_on_one_device(tmp_path):
    """--mesh_disp 2 --channel_tp 1: two ranks share the aggregation's
    channels (this process rank 0); one run's rows and checkpoint, rank
    0's state bit for bit, which the predict CLI reads on one device."""
    save = str(tmp_path / "ckpt")
    trainer = main(CLI + ["--batchSize", "2", "--steps", "2", "--nEpochs", "1", "--log_every", "1",
                          "--save_path", save, "--device", "cpu", "--mesh_disp", "2",
                          "--channel_tp", "1"])
    assert trainer.cfg.model.channel_tp and trainer.state.model.mesh.size("disp") == 2
    assert trainer.mesh.index == {"data": 0, "space": 0, "disp": 0} and trainer.state.step == 2
    with open(os.path.join(save, "train.jsonl")) as f:
        assert [line.count('"epoch0"') for line in f] == [1, 1]
    final = trainer.state.model.state_dict()
    weights = load_inference_state(save)
    assert sorted(weights) == sorted(final)
    for k, v in weights.items():
        assert torch.equal(v, final[k]), k
    written = t_predict.main(CLI + ["--resume", save, "--save_path", str(tmp_path / "out"),
                                    "--device", "cpu"])
    assert len(written) == 4 and all(os.path.exists(p) for p in written)


@pytest.mark.parametrize("model, tp, fits", [("GANet_deep", 3, "[1, 2, 4, 8, 16]"),
                                              ("GANet_small", 8, "[1, 2, 4]")])
def test_trainer_refuses_channels_tp_cannot_split(model, tp, fits):
    """Before any rank or step: the channel rule's ValueError names the
    sizes that pass."""
    cfg = C.TrainConfig(model=C.model_config(model, max_disp=24, channel_tp=True),
                        data=C.DataConfig(crop_height=48, crop_width=96, kind="synthetic"),
                        mesh=C.MeshConfig(disp=tp), batch_size=2)
    with pytest.raises(ValueError, match=re.escape(f"disp may be {fits}")):
        Trainer(cfg, device="cpu")
