"""The port's training slice against the JAX package's, on the CPU.

Train-mode layers are held against flax (`train=True`,
`mutable=["batch_stats"]`) with converted weights and seeded BatchNorm
(tests/torch_parity.py), within 1e-4 as the eval-mode layer tests.

One GANet_small train step (48x96, max_disp 12) is held against JAX's
`make_train_step` on a one-device mesh with `sga_impl="scan"`, with and
without `left_right`: the loss, every parameter's gradient (norm-relative,
parameter by parameter, and over all of them) and the updated BatchNorm
statistics.  The JAX gradients come out of the train step through an
optimiser that keeps them (`_grad_capture`).

Tolerances.  The float32 noise floor of the step is measured in the test:
the port in float32 against itself in float64.  On the CPU it reads at
most 1.8e-5 per parameter, 5e-6 over all, 7e-8 on the loss and 1.4e-7 on
the statistics; the tolerances are 3e-4 per parameter, 1e-4 over all,
1e-6 on the loss and 1e-5 on the statistics, where the port against JAX
read at most 5.8e-5, 1.3e-5, 1.2e-7 and 1.3e-6 (XLA-CPU sums in float32
with about 20 times the error of PyTorch's pairwise sums).  A few
parameters are ill-conditioned in float32: the scale and bias of a layer
whose output is L1-normalised or re-normalised by a train-mode BatchNorm
have gradients that nearly cancel, and for some weights the port's own
float32 and float64 differ there by up to 5e-3 (with JAX in float64 as
the judge, the port in float32 was the closer one as often as not).  The
weights are therefore a fixed draw of flax's init law (truncated He
normal, seed 0) for which the floor stays low, and the test asserts that
it does before it compares.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ganet_tpu import config as J
from ganet_tpu.data.dataset import SyntheticStereoDataset as JSynthetic
from ganet_tpu.models.aggregation import SGABlock as JSGABlock
from ganet_tpu.models.ganet import GANet as JGANet
from ganet_tpu.models.layers import BasicConv as JBasicConv
from ganet_tpu.models.layers import Conv2x as JConv2x
from ganet_tpu.parallel.mesh import make_mesh
from ganet_tpu.train import loss as j_loss
from ganet_tpu.train import metrics as j_metrics
from ganet_tpu.train.state import TrainState as JTrainState
from ganet_tpu.train.state import make_optimizer as j_make_optimizer
from ganet_tpu.train.trainer import BATCH_KEYS
from ganet_tpu.train.trainer import make_train_step as j_make_train_step
from ganet_tpu_torch import config as C
from ganet_tpu_torch.convert import convert_flax_variables
from ganet_tpu_torch.data import SyntheticStereoDataset, stack
from ganet_tpu_torch.entry import build_model, predict
from ganet_tpu_torch.models import BasicConv, Conv2x, SGABlock
from ganet_tpu_torch.train import (
    TrainState,
    create_train_state,
    deep_supervision_loss,
    disparity_metrics,
    make_eval_step,
    make_optimizer,
    make_train_step,
)
from tests.torch_parity import he_normal_draw, nchw, nhwc, seeded_variables

TOL = dict(rtol=1e-4, atol=1e-4)
KEY = jax.random.PRNGKey(0)


def _randn(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# configuration and data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["DataConfig", "OptimConfig", "MeshConfig", "TrainConfig"])
def test_config_fields_match(name):
    ours, theirs = getattr(C, name)(), getattr(J, name)()
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(theirs)]
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        if f.name == "model":  # the model presets are held in test_torch_models.py
            assert a.name == b.name
        elif dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize(
    "kw",
    [{}, {"sparse_frac": 0.3}, {"left_right": True}, {"left_right": True, "sparse_frac": 0.3, "seed": 3}],
    ids=["dense", "sparse", "left_right", "sparse_left_right"],
)
def test_synthetic_dataset_is_bit_equal(kw):
    ours, theirs = SyntheticStereoDataset(**kw), JSynthetic(**kw)
    assert len(ours) == len(theirs)
    for index in (0, 1, 17):
        a, b = ours[index], theirs[index]
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    batch = stack(ours, [2, 5])
    assert batch["left"].shape == (2, 48, 96, 3)
    assert np.array_equal(batch["disparity"][1], theirs[5]["disparity"])


# ---------------------------------------------------------------------------
# train-mode layers against flax
# ---------------------------------------------------------------------------


def _jax_train(jmod, *args):
    """Seeded variables of a flax module, its train-mode output and its
    updated batch statistics."""
    variables = seeded_variables(jax.jit(lambda k: jmod.init(k, *args, False))(KEY))
    out, upd = jax.jit(lambda v: jmod.apply(v, *args, True, mutable=["batch_stats"]))(variables)
    stats = convert_flax_variables({"batch_stats": jax.device_get(upd["batch_stats"])})
    return variables, jax.tree_util.tree_map(np.asarray, out), stats


def _check_stats(module, want):
    got = {k: v for k, v in module.state_dict().items() if k in want and "num_batches" not in k}
    assert got, "no running statistics"
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=1e-5, atol=1e-6, err_msg=k)
    assert all(v.item() == 1 for k, v in module.state_dict().items() if k.endswith("num_batches_tracked"))


def _train_module(module, variables):
    module.load_state_dict(convert_flax_variables(variables), strict=True)
    return module.train()


# (in, features, kernel, stride, is_3d, deconv, relu, input shape NHWC/NDHWC)
BASIC_CONV_CASES = {
    "2d_k3_s1": (4, 6, 3, 1, False, False, True, (2, 12, 12, 4)),
    "2d_k5_s3": (4, 6, 5, 3, False, False, False, (2, 12, 12, 4)),
    "2d_deconv": (4, 6, 3, 2, False, True, True, (2, 6, 6, 4)),
    "3d_k3_s1": (4, 6, 3, 1, True, False, False, (1, 6, 8, 8, 4)),
    "3d_k3_s2": (4, 6, 3, 2, True, False, True, (1, 6, 8, 8, 4)),
    "3d_deconv": (4, 6, 3, 2, True, True, True, (1, 3, 4, 4, 4)),
}


@pytest.mark.parametrize("case", sorted(BASIC_CONV_CASES))
def test_basic_conv_train(rng, case):
    cin, feats, k, stride, is_3d, deconv, relu, shape = BASIC_CONV_CASES[case]
    x = _randn(rng, shape) + 0.5  # a mean away from 0 exercises E[x^2] - E[x]^2
    jmod = JBasicConv(feats, k, stride=stride, is_3d=is_3d, deconv=deconv, relu=relu)
    variables, want, stats = _jax_train(jmod, x)
    tmod = _train_module(
        BasicConv(cin, feats, k, stride=stride, is_3d=is_3d, deconv=deconv, relu=relu), variables
    )
    got = nhwc(tmod(nchw(x)))
    np.testing.assert_allclose(got, want, **TOL)
    _check_stats(tmod, stats)


@pytest.mark.parametrize("is_3d", [False, True])
@pytest.mark.parametrize("deconv", [False, True])
def test_conv2x_train(rng, is_3d, deconv):
    sp_hi = (6, 8, 8) if is_3d else (12, 12)
    sp_lo = tuple(s // 2 for s in sp_hi)
    if deconv:
        x, rem, cin, feats = _randn(rng, (1, *sp_lo, 8)), _randn(rng, (1, *sp_hi, 4)), 8, 4
    else:
        x, rem, cin, feats = _randn(rng, (1, *sp_hi, 4)), _randn(rng, (1, *sp_lo, 8)), 4, 8
    jmod = JConv2x(feats, deconv=deconv, is_3d=is_3d)
    variables, want, stats = _jax_train(jmod, x, rem)
    tmod = _train_module(Conv2x(cin, feats, feats, deconv=deconv, is_3d=is_3d), variables)
    got = nhwc(tmod(nchw(x), nchw(rem)))
    np.testing.assert_allclose(got, want, **TOL)
    _check_stats(tmod, stats)


def test_sga_block_train(rng):
    C_ = 4
    jcfg, tcfg = J.ganet_small(24, sga_impl="scan"), C.ganet_small(24)
    x = _randn(rng, (2, 4, 6, 8, C_))
    g = _randn(rng, (2, 6, 8, 20 * C_))
    jmod = JSGABlock(C_, jcfg)
    variables, want, stats = _jax_train(jmod, x, g)
    tmod = _train_module(SGABlock(C_, tcfg), variables)
    got = nhwc(tmod(nchw(x), nchw(g)))
    np.testing.assert_allclose(got, want, **TOL)
    _check_stats(tmod, stats)


# ---------------------------------------------------------------------------
# loss, metrics, optimiser
# ---------------------------------------------------------------------------


def test_loss_and_metrics(rng):
    target = rng.uniform(0, 20, (2, 6, 9)).astype(np.float32)
    valid = (rng.random((2, 6, 9)) < 0.7).astype(np.float32)
    outs = [target + rng.normal(0, s, target.shape).astype(np.float32) for s in (0.5, 2.0, 5.0)]
    for heads in (outs, outs[1:]):  # three heads, and two with the last weights
        want = float(j_loss.deep_supervision_loss(heads, target, valid, (0.2, 0.6, 1.0)))
        got = deep_supervision_loss([torch.from_numpy(o) for o in heads], torch.from_numpy(target),
                                    torch.from_numpy(valid), (0.2, 0.6, 1.0))
        np.testing.assert_allclose(got.item(), want, rtol=1e-6)
    zero = deep_supervision_loss([torch.ones(1, 2, 2)], torch.zeros(1, 2, 2), torch.zeros(1, 2, 2), (1.0,))
    assert zero.item() == 0.0
    want = j_metrics.disparity_metrics(outs[2], target, valid)
    got = disparity_metrics(*(torch.from_numpy(a) for a in (outs[2], target, valid)))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6, err_msg=k)


def test_adam_matches_optax(rng):
    optim = C.OptimConfig(lr=3e-3)
    p0 = [_randn(rng, (4, 3)), _randn(rng, (5,))]
    grads = [[_randn(rng, p.shape) * s for p in p0] for s in (1.0, 1e-3, 10.0)]
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt, sched = make_optimizer(optim, params)
    tx = j_make_optimizer(J.OptimConfig(lr=3e-3))
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    for g in grads:
        for p, gi in zip(params, g):
            p.grad = torch.from_numpy(gi)
        opt.step()
        sched.step()
        upd, state = tx.update([jnp.asarray(gi) for gi in g], state, jp)
        jp = optax.apply_updates(jp, upd)
    for p, q in zip(params, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(q), rtol=1e-6, atol=1e-7)


def test_schedule_boundary_matches_optax():
    optim = C.OptimConfig(lr=1e-3, decay_epoch=2, decay_factor=0.1)
    steps_per_epoch, boundary = 5, 10
    schedule = optax.piecewise_constant_schedule(optim.lr, {boundary: optim.decay_factor})
    opt, sched = make_optimizer(optim, [torch.nn.Parameter(torch.zeros(1))], steps_per_epoch)
    lrs = []
    for _ in range(boundary + 2):
        lrs.append(sched.get_last_lr()[0])  # the lr of this update
        opt.step()
        sched.step()
    for step in (boundary - 1, boundary, boundary + 1):
        np.testing.assert_allclose(lrs[step], float(schedule(step)), rtol=1e-7)
    assert lrs[boundary - 1] == optim.lr and lrs[boundary] == pytest.approx(optim.lr * 0.1)


# ---------------------------------------------------------------------------
# the train step against JAX's make_train_step
# ---------------------------------------------------------------------------


def _grad_capture() -> optax.GradientTransformation:
    """An optimiser that leaves the parameters alone and keeps the last
    gradients as its state."""
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)  # noqa: E731
    return optax.GradientTransformation(lambda p: zeros(p), lambda g, s, p=None: (zeros(g), g))


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


H, W, D = 48, 96, 12


@pytest.fixture(scope="module")
def small_variables():
    """GANet_small variables at 48x96, max_disp 12: the tree of flax's init
    (traced, not compiled) filled from a seed, kernels truncated He-normal
    as flax's `he_normal`, every BatchNorm leaf seeded as
    tests/torch_parity.py does."""
    jmodel = JGANet(J.ganet_small(D, sga_impl="scan"))
    dummy = jax.ShapeDtypeStruct((1, H, W, 3), jnp.float32)
    shapes = jax.eval_shape(lambda k, a: jmodel.init(k, a, a, train=True), KEY, dummy)
    return seeded_variables(he_normal_draw(shapes))


def _port_step(tcfg, variables, batch, dtype):
    """One port train step from converted `variables`: (metrics, model)."""
    cfg = dataclasses.replace(tcfg, model=dataclasses.replace(tcfg.model, compute_dtype=dtype))
    model = build_model(cfg.model, device="cpu", state_dict=convert_flax_variables(variables))
    model = model.double() if dtype == "float64" else model
    opt, sched = make_optimizer(cfg.optim, model.parameters())
    state = TrainState(model.train(), opt, sched)
    metrics = make_train_step(cfg)(state, batch)
    assert state.step == 1 and metrics["lr"] == cfg.optim.lr
    return metrics, model


@pytest.mark.parametrize("left_right", [False, True], ids=["plain", "left_right"])
def test_train_step_matches_jax(small_variables, left_right):
    variables = small_variables
    data = dict(crop_height=H, crop_width=W, kind="synthetic", left_right=left_right)
    jcfg = J.TrainConfig(model=J.ganet_small(D, sga_impl="scan"), data=J.DataConfig(**data), batch_size=1)
    tcfg = C.TrainConfig(model=C.ganet_small(D), data=C.DataConfig(**data), batch_size=1)
    batch = stack(SyntheticStereoDataset(H, W, D, left_right=left_right), [0])
    keys = BATCH_KEYS + (("disparity_right", "valid_right") if left_right else ())

    jmodel = JGANet(jcfg.model)
    state = JTrainState.create(apply_fn=jmodel.apply, params=variables["params"],
                               batch_stats=variables["batch_stats"], tx=_grad_capture())
    mesh = make_mesh(jcfg.mesh)
    with mesh:
        new_state, jm = j_make_train_step(jcfg, mesh, keys)(state, {k: batch[k] for k in keys})
    want_grads = convert_flax_variables({"params": jax.device_get(new_state.opt_state)})
    want_stats = convert_flax_variables({"batch_stats": jax.device_get(new_state.batch_stats)})
    want_stats = {k: v for k, v in want_stats.items() if "num_batches" not in k}

    metrics, model = _port_step(tcfg, variables, batch, "float32")
    _, model64 = _port_step(tcfg, variables, batch, "float64")
    grads = {n: p.grad.double() for n, p in model.named_parameters()}
    grads64 = {n: p.grad for n, p in model64.named_parameters()}
    assert sorted(grads) == sorted(want_grads) == sorted(grads64)
    floor = max((_rel(grads[n], grads64[n]), n) for n in grads)
    assert floor[0] <= 5e-5, f"float32 noise floor {floor}: the case is ill-conditioned"

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


def test_train_and_eval_steps_run_and_learn():
    """A few Adam steps on one fixed batch lower the loss; the eval step is
    the eval-mode forward's metrics; the trainer takes one device only."""
    cfg = C.TrainConfig(model=C.ganet_small(D),
                        data=C.DataConfig(crop_height=H, crop_width=W, kind="synthetic"),
                        optim=C.OptimConfig(lr=3e-3), batch_size=2)
    state = create_train_state(cfg, device="cpu")
    assert state.model.training
    batch = stack(SyntheticStereoDataset(H, W, D), [0, 1])
    step = make_train_step(cfg)
    losses = [step(state, batch)["loss"].item() for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    metrics = make_eval_step(cfg)(state, batch)
    assert not state.model.training
    disp = predict(state.model, batch["left"], batch["right"])
    want = disparity_metrics(disp, torch.from_numpy(batch["disparity"]), torch.from_numpy(batch["valid"]))
    for k in want:
        assert metrics[k].item() == pytest.approx(want[k].item(), rel=1e-6), k
    with pytest.raises(NotImplementedError):
        create_train_state(dataclasses.replace(cfg, mesh=C.MeshConfig(data=2)), device="cpu")
