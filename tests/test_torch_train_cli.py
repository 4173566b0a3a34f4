"""The port's train CLI (`python -m ganet_tpu_torch.train`) against the
repo's `train.py`, on the CPU.

For a table of command lines (the reference's at `train.py:7-10` among
them) the port's `build_config` gives `train.py`'s `TrainConfig` field
for field; the model's `impl` stands for JAX's `sga_impl` (scan runs the
plain versions, pallas the kernels), and `channel_tp`, which the port
lacks, is off.  Flags whose paths are not ported raise.  Then the CLI
trains GANet_small for 2 steps on synthetic data and writes a checkpoint
that the port's predict CLI loads.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

import train as j_train
import ganet_tpu_torch.predict as t_predict
from ganet_tpu_torch.train import build_config, main, parse_args
from ganet_tpu_torch.train.checkpoint import load_inference_state
from tests.torch_parity import two_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMPL = {"auto": "auto", "scan": "torch", "pallas": "kernel"}

ARGVS = {
    "defaults": [],
    "reference_sceneflow": ["--crop_height=240", "--crop_width=528", "--max_disp=192",
                            "--batchSize=16", "--nEpochs=10", "--data_path=/data/sceneflow/",
                            "--training_list=lists/sceneflow_train.list",
                            "--save_path=./checkpoint", "--model", "GANet_deep"],
    "reference_kitti2015": ["--kitti2015=1", "--resume", "./checkpoint", "--data_path=/data/kitti/",
                            "--training_list=lists/kitti2015_train.list",
                            "--val_list=lists/kitti2015_test.list"],
    "kitti2012": ["--kitti", "1", "--lr", "1e-4"],
    "left_right": ["--left_right", "1", "--prefetch", "0", "--seed", "3"],
    "lr_decay": ["--lr_decay_epoch", "3", "--nEpochs", "5", "--steps", "20"],
    "remat_full": ["--remat", "full", "--bf16", "1", "--batchSize", "4"],
    "synthetic": ["--synthetic_data", "1", "--sparse_frac", "0.3", "--model", "GANet_small",
                  "--max_disp", "24", "--remat", "none", "--eval", "1"],
    "ganet11_pallas": ["--model", "GANet11", "--sga_impl", "pallas", "--compile_cache", "0"],
    "scan": ["--sga_impl", "scan"],
}


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_build_config_matches_train_py(name):
    argv = ARGVS[name]
    mine = dataclasses.asdict(build_config(parse_args(argv)))
    ref = dataclasses.asdict(j_train.build_config(j_train.parse_args(argv)))
    ref_model = ref.pop("model")
    assert mine.pop("model") == {
        **{k: v for k, v in ref_model.items() if k not in ("sga_impl", "channel_tp")},
        "impl": IMPL[ref_model["sga_impl"]],
    }
    assert ref_model["channel_tp"] is False
    assert mine == ref


def test_flags_and_defaults_match_train_py():
    mine, ref = vars(parse_args([])), vars(j_train.parse_args([]))
    assert set(mine) - set(ref) == {"device", "log_every"}
    assert {k: mine[k] for k in ref} == ref
    assert mine["remat"] == "sga" and mine["batchSize"] == 2


@pytest.mark.parametrize("argv", [["--mesh_data", "2"], ["--mesh_space", "2"], ["--mesh_disp", "2"],
                                  ["--distributed", "1"], ["--channel_tp", "1"]],
                         ids=lambda a: a[0][2:])
def test_unported_flags_raise(argv):
    j_train.build_config(j_train.parse_args(argv))  # the reference takes them
    with pytest.raises(NotImplementedError, match="queue 1"):
        build_config(parse_args(argv))


SMALL = ["--model", "GANet_small", "--synthetic_data", "1", "--crop_height", "48",
         "--crop_width", "96", "--max_disp", "24"]


def test_trains_and_writes_a_checkpoint_predict_loads(tmp_path):
    save = str(tmp_path / "ckpt")
    argv = SMALL + ["--batchSize", "2", "--nEpochs", "1", "--steps", "2", "--log_every", "1",
                    "--eval", "1", "--save_path", save]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)
    trainer = main(argv + ["--device", "cpu"])
    assert trainer.state.step == 2 and trainer.cfg.model.remat == "sga"
    with open(os.path.join(save, "train.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [(r["prefix"], r["step"]) for r in rows] == [("epoch0", 1), ("epoch0", 2), ("val", 16)]
    assert all(r["loss"] == r["loss"] for r in rows[:2])
    assert sorted(os.listdir(save)) == ["0", "best", "best_epe.json", "train.jsonl"]

    written = t_predict.main(SMALL + ["--resume", save, "--save_path", str(tmp_path / "out"),
                                      "--device", "cpu"])
    assert len(written) == 4 and all(os.path.exists(p) for p in written)
    weights = load_inference_state(save)
    for k, v in trainer.state.model.state_dict().items():
        assert torch.equal(weights[k], v), k


def test_runs_as_a_module():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-m", "ganet_tpu_torch.train", "--help"], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--remat" in out.stdout and "--device" in out.stdout
