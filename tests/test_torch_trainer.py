"""The port's `Trainer` against the JAX package's, on the CPU.

One JAX `Trainer` runs for the module: GANet_small at 48x96 with max_disp
24, batch 2, synthetic data with sparse ground truth (so that batches
weigh differently in evaluation), 1 epoch of 2 steps with a row a step,
then `evaluate` over 4 test batches.  The port's `Trainer` of the same
configuration starts from the JAX trainer's initial weights, converted.

Those weights are the fixed draw of `tests/test_torch_train.py` (kernels
truncated He-normal, every BatchNorm leaf seeded), set into the JAX
trainer's state before it trains: with flax's own init the BatchNorm
biases start at 0, and the final parameters of those layers are 2 Adam
updates alone.  An Adam update is about lr times the sign of each
gradient element, so an element whose gradient lies within float32 noise
of 0 moves by +-lr at random; XLA-CPU's float32 gradients carry about 20
times PyTorch's noise, and on flax's init the port and JAX read up to
1.3e-3 apart on a parameter's first gradient and 0.22 on its update after
2 steps, where the port's float32 and float64 read 7.3e-5 and 2.6e-5
apart.

Tolerances, those of `tests/test_torch_train.py`'s one-step test: the
loss within 1e-6 and the EPE within 1e-4 (relative) in each logged row,
the learning rate exactly; the final parameters within 3e-4
norm-relative per parameter and 1e-4 over all (measured: 9.8e-5 and
8.9e-6, where the port's float32 against its float64 reads 8.2e-5 and
7.4e-6).  Evaluation on the JAX trainer's final weights: each metric
within 1e-4 (relative) of JAX's.
"""

import copy
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from ganet_tpu import config as J
from ganet_tpu.train.trainer import Trainer as JTrainer
from ganet_tpu_torch import config as C
from ganet_tpu_torch.convert import convert_flax_variables
from ganet_tpu_torch.train import Trainer
from ganet_tpu_torch.train.checkpoint import load_inference_state
from tests.torch_parity import he_normal_draw, seeded_variables, two_torch_threads  # noqa: F401

EVAL_BATCHES = 4


def _cfg(cls, save_path, epochs=1):
    return cls.TrainConfig(
        model=cls.ganet_small(max_disp=24),
        data=cls.DataConfig(crop_height=48, crop_width=96, kind="synthetic", shuffle=True,
                            num_prefetch=0, sparse_frac=0.3),
        optim=cls.OptimConfig(lr=3e-4),
        batch_size=2,
        num_epochs=epochs,
        steps_per_epoch=2,
        save_path=str(save_path),
        log_every=1,
        keep_checkpoints=2,
    )


def _variables(state):
    return convert_flax_variables(
        jax.device_get({"params": state.params, "batch_stats": state.batch_stats}))


def _rows(save_path, prefix):
    with open(os.path.join(save_path, "train.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["prefix"].startswith(prefix)]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX trainer's initial and final weights, its rows and its
    evaluation (on its final weights)."""
    save = tmp_path_factory.mktemp("jax") / "ckpt"
    trainer = JTrainer(_cfg(J, save))
    try:
        v = seeded_variables(he_normal_draw(jax.device_get(
            {"params": trainer.state.params, "batch_stats": trainer.state.batch_stats})))
        trainer.state = trainer.state.replace(params=v["params"], batch_stats=v["batch_stats"])
        init = _variables(trainer.state)
        trainer.fit()
        final = _variables(trainer.state)
        result = trainer.evaluate(max_batches=EVAL_BATCHES)
    finally:
        trainer.close()
    return {"init": init, "final": final, "rows": _rows(save, "epoch"), "eval": result,
            "steps_per_epoch": trainer.steps_per_epoch}


def _port_trainer(save_path, weights, epochs=1) -> Trainer:
    trainer = Trainer(_cfg(C, save_path, epochs), device="cpu")
    trainer.state.model.load_state_dict(weights, strict=True)
    return trainer


def _rel(a, b) -> float:
    return float((a - b).double().norm() / b.double().norm().clamp_min(1e-30))


def test_fit_matches_jax(jax_run, tmp_path):
    trainer = _port_trainer(tmp_path / "ckpt", jax_run["init"])
    assert trainer.steps_per_epoch == jax_run["steps_per_epoch"] == 2
    state = trainer.fit()
    trainer.close()
    assert state.step == 2
    rows, want = _rows(tmp_path / "ckpt", "epoch"), jax_run["rows"]
    assert [(r["prefix"], r["step"]) for r in rows] == [(r["prefix"], r["step"]) for r in want] == [
        ("epoch0", 1), ("epoch0", 2)]
    for got, ref in zip(rows, want):
        assert sorted(got) == sorted(ref)
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-6)
        np.testing.assert_allclose(got["epe"], ref["epe"], rtol=1e-4)
        assert got["lr"] == pytest.approx(ref["lr"], rel=1e-7) and ref["lr"] == 3e-4
    final = jax_run["final"]
    params = {n: p.detach() for n, p in state.model.named_parameters()}
    assert sorted(params) == sorted(n for n in final if n in params)
    worst = max((_rel(params[n], final[n]), n) for n in params)
    assert worst[0] <= 3e-4, worst
    flat = lambda d: torch.cat([d[n].flatten() for n in sorted(params)])  # noqa: E731
    assert _rel(flat(params), flat(final)) <= 1e-4
    assert sorted(os.listdir(tmp_path / "ckpt" / "0")) == [
        "meta.json", "model.pt", "optimizer.pt", "scheduler.pt"]


def _snapshot(state):
    return {
        "model": {k: v.clone() for k, v in state.model.state_dict().items()},
        "optimizer": copy.deepcopy(state.optimizer.state_dict()),
        "scheduler": copy.deepcopy(state.scheduler.state_dict()),
        "step": state.step,
    }


def _equal(a, b) -> bool:
    """Nested state dicts equal bit for bit."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return sorted(a, key=str) == sorted(b, key=str) and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def _recording(trainer):
    """Record the disparity of every batch the trainer's steps take."""
    seen, step = [], trainer.train_step

    def recorded(state, batch):
        seen.append(batch["disparity"].copy())
        return step(state, batch)

    trainer.train_step = recorded
    return seen


def test_resume_restores_the_state_with_jax_semantics(jax_run, tmp_path):
    """Epoch 0's checkpoint restores the state bit for bit, by default from
    save_path and from --resume elsewhere; start_epoch is 1, the step goes
    on to 4, and the resumed epoch sees epoch 0's batches again (a fresh
    iterator and dataset, as in the JAX trainer)."""
    save = tmp_path / "ckpt"
    first = _port_trainer(save, jax_run["init"])
    seen_first = _recording(first)
    first.fit()
    first.close()
    saved = _snapshot(first.state)
    assert saved["step"] == 2 and saved["optimizer"]["state"]

    resumed = Trainer(_cfg(C, save, epochs=2), device="cpu")  # restores from save_path
    elsewhere = Trainer(dataclasses.replace(_cfg(C, tmp_path / "other"), resume=str(save)),
                        device="cpu")
    for trainer in (resumed, elsewhere):
        assert trainer.start_epoch == 1
        assert _equal(_snapshot(trainer.state), saved)
    with pytest.raises(FileNotFoundError):
        Trainer(dataclasses.replace(_cfg(C, tmp_path / "x"), resume=str(tmp_path / "none")),
                device="cpu")

    seen_resumed = _recording(resumed)
    state = resumed.fit()
    resumed.close()
    assert state.step == 4
    assert [r["step"] for r in _rows(save, "epoch1")] == [3, 4]
    assert len(seen_resumed) == len(seen_first) == 2
    assert all(np.array_equal(a, b) for a, b in zip(seen_resumed, seen_first))
    with open(save / "1" / "meta.json") as f:
        meta = json.load(f)
    assert (meta["step"], meta["epoch"], meta["train_step"]) == (1, 1, 4)


def test_save_best_keeps_one_improving_checkpoint(tmp_path):
    trainer = Trainer(_cfg(C, tmp_path / "ckpt"), device="cpu")
    marker = tmp_path / "ckpt" / "best_epe.json"
    trainer.state.step = 3
    assert trainer.save_best(5.0)
    assert not trainer.save_best(5.0) and not trainer.save_best(6.0)
    assert json.loads(marker.read_text()) == {"epe": 5.0, "step": 3}
    trainer.state.step = 7
    assert trainer.save_best(4.0)
    assert json.loads(marker.read_text()) == {"epe": 4.0, "step": 7}
    assert sorted(os.listdir(tmp_path / "ckpt" / "best")) == ["7"]
    weights = load_inference_state(str(tmp_path / "ckpt" / "best"))
    assert _equal(weights, trainer.state.model.state_dict())
    trainer.close()


def test_evaluate_is_pixel_weighted_and_matches_jax(jax_run, tmp_path):
    trainer = _port_trainer(tmp_path / "ckpt", jax_run["final"])
    result = trainer.evaluate(max_batches=EVAL_BATCHES)
    trainer.close()
    want = jax_run["eval"]
    assert sorted(result) == sorted(want)
    for k in want:
        np.testing.assert_allclose(result[k], want[k], rtol=1e-4, err_msg=k)

    # The same batches through the eval step, weighted by their valid pixels.
    from ganet_tpu_torch.data import SyntheticStereoDataset, stack

    ds = SyntheticStereoDataset(48, 96, 24, length=16, training=False, sparse_frac=0.3)
    per = [trainer.eval_step(trainer.state, stack(ds, [i])) for i in range(EVAL_BATCHES)]
    w = np.array([m["valid_px"].item() for m in per])
    assert len(set(w)) > 1, "the batches weigh alike: the check cannot tell the weighting"
    for k in ("epe", "rate_3px", "d1_all"):
        v = np.array([m[k].item() for m in per])
        assert result[k] == pytest.approx((v * w).sum() / w.sum(), rel=1e-12)
    assert result["valid_px"] == w.sum()
    rows = _rows(tmp_path / "ckpt", "val")
    assert [r["step"] for r in rows] == [EVAL_BATCHES] and rows[0]["epe"] == result["epe"]
    assert json.loads((tmp_path / "ckpt" / "best_epe.json").read_text())["epe"] == result["epe"]
