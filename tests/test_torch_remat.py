"""Rematerialisation (`ModelConfig.remat`) of the port, on the CPU.

One float32 train step of GANet_small (48x96, max_disp 24, batch 2) under
remat "none", "sga" and "full" gives the same loss, gradients, updated
parameters, BatchNorm running statistics and `num_batches_tracked`, bit
for bit: the recompute repeats the forward's arithmetic, and train-mode
BatchNorm updates its statistics once a step, not again in the recompute.
Forward pre-hooks count the modules each policy runs twice (the recompute
stops once it has remade what backward needs, so it may skip the
post-hooks).  One step under
"sga" is held against JAX's `make_train_step` with `remat="sga"`, within
the tolerances of `tests/test_torch_train.py`'s one-step test.
"""

import collections

import jax
import numpy as np
import pytest
import torch

from ganet_tpu import config as J
from ganet_tpu.models.ganet import GANet as JGANet
from ganet_tpu.parallel.mesh import make_mesh
from ganet_tpu.train.state import TrainState as JTrainState
from ganet_tpu.train.trainer import BATCH_KEYS
from ganet_tpu.train.trainer import make_train_step as j_make_train_step
from ganet_tpu_torch import config as C
from ganet_tpu_torch.convert import convert_flax_variables
from ganet_tpu_torch.data import SyntheticStereoDataset, stack
from ganet_tpu_torch.models import BasicConv, Conv2x, SGABlock
from ganet_tpu_torch.models.aggregation import DispAggHead, DispHead
from ganet_tpu_torch.train import create_train_state, make_train_step
from tests.test_torch_train import D, H, W, _grad_capture, _port_step, _rel, small_variables  # noqa: F401
from tests.torch_parity import two_torch_threads  # noqa: F401


def _step(remat, left_right):
    """One Adam step under `remat` from the seeded init: (loss, gradients,
    parameters and buffers after the step, forward calls by module)."""
    cfg = C.TrainConfig(
        model=C.ganet_small(24, remat=remat),
        data=C.DataConfig(crop_height=48, crop_width=96, kind="synthetic", left_right=left_right),
        batch_size=2,
    )
    state = create_train_state(cfg, device="cpu")
    calls = collections.Counter()
    for name, module in state.model.cost_agg.named_modules():
        if isinstance(module, (BasicConv, Conv2x, SGABlock, DispHead, DispAggHead)):
            module.register_forward_pre_hook(lambda m, i, name=name: calls.update([name]))
    batch = stack(SyntheticStereoDataset(48, 96, 24, left_right=left_right), [0, 1])
    metrics = make_train_step(cfg)(state, batch)
    grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
    return metrics["loss"], grads, dict(state.model.state_dict()), calls


@pytest.mark.parametrize("left_right", [False, True], ids=["plain", "left_right"])
def test_remat_policies_are_bit_equal(left_right):
    runs = {remat: _step(remat, left_right) for remat in C.REMATS}
    loss, grads, tensors, calls = runs["none"]
    assert all(v == 1 for v in calls.values())
    for remat in ("sga", "full"):
        got_loss, got_grads, got_tensors, got_calls = runs[remat]
        assert torch.equal(got_loss, loss), remat
        assert all(torch.equal(got_grads[n], g) for n, g in grads.items()), remat
        assert all(torch.equal(got_tensors[k], v) for k, v in tensors.items()), remat
        assert all(v.item() == 1 for k, v in got_tensors.items() if k.endswith("num_batches_tracked"))
        # Run twice a step: the blocks and heads (and what they hold) under
        # both, everything under "full".
        for name, n in got_calls.items():
            twice = remat == "full" or name.startswith(("sga_", "disp"))
            assert n == (2 if twice else 1), (remat, name, n)


def test_unknown_remat_raises():
    with pytest.raises(ValueError, match="remat"):
        C.ganet_small(24, remat="blocks")


def test_remat_sga_step_matches_jax(small_variables):  # noqa: F811
    """As `test_torch_train.py::test_train_step_matches_jax`, under remat
    "sga" on both sides."""
    variables = small_variables
    data = dict(crop_height=H, crop_width=W, kind="synthetic")
    jcfg = J.TrainConfig(model=J.ganet_small(D, sga_impl="scan", remat="sga"),
                         data=J.DataConfig(**data), batch_size=1)
    tcfg = C.TrainConfig(model=C.ganet_small(D, remat="sga"), data=C.DataConfig(**data), batch_size=1)
    batch = stack(SyntheticStereoDataset(H, W, D), [0])
    jmodel = JGANet(jcfg.model)
    state = JTrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                               batch_stats=variables["batch_stats"], tx=_grad_capture())
    mesh = make_mesh(jcfg.mesh)
    with mesh:
        new_state, jm = j_make_train_step(jcfg, mesh)(state, {k: batch[k] for k in BATCH_KEYS})
    want_grads = convert_flax_variables({"params": jax.device_get(new_state.opt_state)})
    want_stats = convert_flax_variables({"batch_stats": jax.device_get(new_state.batch_stats)})

    metrics, model = _port_step(tcfg, variables, batch, "float32")
    grads = {n: p.grad.double() for n, p in model.named_parameters()}
    assert sorted(grads) == sorted(want_grads)
    np.testing.assert_allclose(metrics["loss"].item(), float(jm["loss"]), rtol=1e-6)
    np.testing.assert_allclose(metrics["epe"].item(), float(jm["epe"]), rtol=1e-4)
    worst = max((_rel(grads[n], want_grads[n].double()), n) for n in grads)
    assert worst[0] <= 3e-4, worst
    flat = lambda d: torch.cat([d[n].double().flatten() for n in sorted(grads)])  # noqa: E731
    assert _rel(flat(grads), flat(want_grads)) <= 1e-4
    stats = model.state_dict()
    for k, v in want_stats.items():
        if "num_batches" in k:
            assert stats[k].item() == 1, k
        else:
            assert _rel(stats[k].double(), v.double()) <= 1e-5, k
