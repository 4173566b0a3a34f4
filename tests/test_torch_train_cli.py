"""The port's train CLI (`python -m ganet_tpu_torch.train`) against the
repo's `train.py`, on the CPU.

For a table of command lines (the reference's at `train.py:7-10` among
them) the port's `build_config` gives `train.py`'s `TrainConfig` field
for field; the model's `impl` stands for JAX's `sga_impl` (scan runs the
plain versions, pallas the kernels), and --channel_tp 1 sets
`channel_tp` as there.  Then
the CLI trains GANet_small for 2 steps on synthetic data and writes a
checkpoint that the port's predict CLI loads; trains it on 2 ranks
(--mesh_data 2, this process rank 0) and resumes the checkpoint on one
device; trains it over --mesh_disp 2; and joins a world that the
environment describes (--distributed 1).
"""

import contextlib
import dataclasses
import io
import json
import os
import re
import runpy
import socket
import sys

import pytest
import torch

import train as j_train
import ganet_tpu_torch.predict as t_predict
from ganet_tpu_torch import config as C
from ganet_tpu_torch.train import build_config, main, parse_args
from ganet_tpu_torch.train.checkpoint import load_inference_state
from tests.torch_parity import two_torch_threads  # noqa: F401

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
    "mesh_data": ["--mesh_data", "2", "--batchSize", "4"],
    "mesh_space": ["--mesh_space", "2", "--mesh_data", "2", "--batchSize", "4"],
    "distributed": ["--distributed", "1", "--mesh_data", "4", "--batchSize", "8"],
}


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_build_config_matches_train_py(name):
    argv = ARGVS[name]
    mine = dataclasses.asdict(build_config(parse_args(argv)))
    ref = dataclasses.asdict(j_train.build_config(j_train.parse_args(argv)))
    ref_model = ref.pop("model")
    assert mine.pop("model") == {
        **{k: v for k, v in ref_model.items() if k != "sga_impl"},
        "impl": IMPL[ref_model["sga_impl"]],
    }
    assert ref_model["channel_tp"] is False
    assert mine == ref


def test_flags_and_defaults_match_train_py():
    mine, ref = vars(parse_args([])), vars(j_train.parse_args([]))
    assert set(mine) - set(ref) == {"device", "log_every"}
    assert {k: mine[k] for k in ref} == ref
    assert mine["remat"] == "sga" and mine["batchSize"] == 2


@pytest.mark.parametrize("argv", [["--mesh_space", "2", "--mesh_disp", "2"], ["--mesh_disp", "2"],
                                  ["--channel_tp", "1"], ["--mesh_disp", "2", "--channel_tp", "1"]],
                         ids=["mesh_space", "mesh_disp", "channel_tp", "mesh_disp_channel_tp"])
def test_unported_flags_raise(argv):
    """The flags of the mesh slices, once unported, now all ported: their
    configs are train.py's, as in test_build_config_matches_train_py, and
    --channel_tp 1 sets the model's `channel_tp`."""
    ref = dataclasses.asdict(j_train.build_config(j_train.parse_args(argv)))
    mine = dataclasses.asdict(build_config(parse_args(argv)))
    ref_model = ref.pop("model")
    assert mine.pop("model") == {
        **{k: v for k, v in ref_model.items() if k != "sga_impl"},
        "impl": IMPL[ref_model["sga_impl"]],
    }
    assert mine == ref
    assert ref_model["channel_tp"] is ("--channel_tp" in argv)
    assert mine["mesh"]["disp"] == (2 if "--mesh_disp" in argv else 1)


@pytest.mark.parametrize("argv, words", [
    (["--mesh_space", "4"], "space 4 cannot share a height of 240"),
    (["--mesh_space", "2", "--crop_height", "264"], "space 2 cannot share a height of 264"),
    (["--mesh_data", "2", "--batchSize", "3"], "--batchSize 3 must be divisible by --mesh_data 2"),
    (["--mesh_disp", "3"], "disp may be [1, 2, 4, 8]"),
    (["--mesh_disp", "2", "--max_disp", "36"], "disp 2 cannot share max_disp 36"),
    (["--mesh_disp", "3", "--channel_tp", "1"], "widths [64, 32, 48, 64, 96] (the cost volume's"),
], ids=["space4_at_240", "space2_at_264", "batch", "disp3_at_192", "disp2_at_36", "channel_tp3"])
def test_flags_no_mesh_can_train_exit_before_any_rank(argv, words, monkeypatch):
    """GANet_deep's shape rule at the reference crop (H/3 = 80 rows in
    blocks of a multiple of 8: space 2 fits, 4 does not), its disparity
    rule (max_disp / 3 bins in blocks of a multiple of 8: 192 takes disp
    1, 2, 4 or 8, 36 none above 1), its channel rule under --channel_tp 1
    (the cost volume's 64 channels do not split in 3), and a batch that
    --mesh_data does not divide: SystemExit, with the rule's message,
    before a rank starts."""
    import ganet_tpu_torch.train.cli as cli

    monkeypatch.setattr(cli, "launch", lambda *a, **k: pytest.fail("a rank was started"))
    with pytest.raises(SystemExit, match=re.escape(words)):
        main(argv + ["--device", "cpu"])


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


def _rows(save):
    with open(os.path.join(save, "train.jsonl")) as f:
        return [(r["prefix"], r["step"]) for r in map(json.loads, f)]


def test_trains_on_two_ranks_and_resumes_on_one_device(tmp_path):
    """--mesh_data 2: this process is rank 0 and gets its trainer back; the
    rows and the checkpoint are one run's (rank 1 logs and writes
    nothing), and the checkpoint resumes on one device."""
    save = str(tmp_path / "ckpt")
    argv = SMALL + ["--batchSize", "2", "--steps", "2", "--log_every", "1", "--remat", "none",
                    "--save_path", save, "--device", "cpu"]
    trainer = main(argv + ["--mesh_data", "2", "--nEpochs", "1"])
    assert (trainer.data_index, trainer.data_size) == (0, 2) and trainer.state.step == 2
    assert trainer.train_iter.local_batch == 1
    assert _rows(save) == [("epoch0", 1), ("epoch0", 2)]
    assert sorted(os.listdir(save)) == ["0", "train.jsonl"]
    assert sorted(os.listdir(os.path.join(save, "0"))) == [
        "meta.json", "model.pt", "optimizer.pt", "scheduler.pt"]
    final = {k: v.clone() for k, v in trainer.state.model.state_dict().items()}
    for k, v in load_inference_state(save).items():
        assert torch.equal(v, final[k]), k

    resumed = main(argv + ["--nEpochs", "2"])
    assert resumed.mesh is None and resumed.start_epoch == 1 and resumed.state.step == 4
    assert _rows(save) == [("epoch0", 1), ("epoch0", 2), ("epoch1", 3), ("epoch1", 4)]


def test_trains_over_disp_and_predict_loads(tmp_path):
    """--mesh_disp 2: two ranks share the cost volume's bins; one run's rows
    and checkpoint, rank 0's state bit for bit, which the predict CLI reads
    on one device."""
    save = str(tmp_path / "ckpt")
    trainer = main(SMALL + ["--batchSize", "2", "--steps", "2", "--nEpochs", "1", "--log_every",
                            "1", "--save_path", save, "--device", "cpu", "--mesh_disp", "2"])
    assert trainer.mesh.index == {"data": 0, "space": 0, "disp": 0} and trainer.state.step == 2
    assert trainer.cfg.mesh.disp == 2 and trainer.state.model.mesh.size("disp") == 2
    assert _rows(save) == [("epoch0", 1), ("epoch0", 2)]
    final = trainer.state.model.state_dict()
    for k, v in load_inference_state(save).items():
        assert torch.equal(v, final[k]), k
    written = t_predict.main(SMALL + ["--resume", save, "--save_path", str(tmp_path / "out"),
                                      "--device", "cpu"])
    assert len(written) == 4 and all(os.path.exists(p) for p in written)


def test_joins_a_world_from_the_environment(tmp_path, monkeypatch):
    """--distributed 1 joins the env:// world (here of one rank); its size
    must be --mesh_data."""
    def world_of_one():
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        for k, v in dict(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK="0",
                         WORLD_SIZE="1").items():
            monkeypatch.setenv(k, v)

    save = str(tmp_path / "ckpt")
    argv = SMALL + ["--distributed", "1", "--batchSize", "1", "--nEpochs", "1", "--steps", "1",
                    "--remat", "none", "--save_path", save, "--device", "cpu"]
    world_of_one()
    trainer = main(argv)
    assert trainer.state.step == 1 and _rows(save) == [("epoch0", 1)]
    assert not torch.distributed.is_initialized()
    world_of_one()
    with pytest.raises(ValueError, match="world"):
        main(argv + ["--mesh_data", "2"])
    assert not torch.distributed.is_initialized()


def test_runs_as_a_module(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["ganet_tpu_torch.train", "--help"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as exit_:
        runpy.run_module("ganet_tpu_torch.train", run_name="__main__", alter_sys=True)
    assert exit_.value.code == 0
    assert "--remat" in out.getvalue() and "--device" in out.getvalue()


def test_trains_over_space_and_predicts_on_one_device(tmp_path):
    """--mesh_space 2: 2 ranks share each image's rows (this process rank
    0), train 2 steps and evaluate; the checkpoint holds no trace of the
    mesh, and the predict CLI reads it on one device."""
    save = str(tmp_path / "ckpt")
    argv = SMALL + ["--max_disp", "12", "--batchSize", "2", "--steps", "2", "--nEpochs", "1",
                    "--log_every", "1", "--eval", "1", "--save_path", save, "--device", "cpu"]
    trainer = main(argv + ["--mesh_space", "2"])
    assert trainer.mesh.cfg == C.MeshConfig(space=2) and trainer.state.step == 2
    assert (trainer.data_index, trainer.data_size) == (0, 1)
    assert _rows(save) == [("epoch0", 1), ("epoch0", 2), ("val", 16)]
    assert sorted(os.listdir(save)) == ["0", "best", "best_epe.json", "train.jsonl"]
    final = {k: v.clone() for k, v in trainer.state.model.state_dict().items()}
    weights = load_inference_state(save)
    assert sorted(weights) == sorted(final)
    for k, v in weights.items():
        assert torch.equal(v, final[k]), k
    written = t_predict.main(SMALL + ["--max_disp", "12", "--resume", save, "--save_path",
                                      str(tmp_path / "out"), "--device", "cpu"])
    assert len(written) == 4 and all(os.path.exists(p) for p in written)
