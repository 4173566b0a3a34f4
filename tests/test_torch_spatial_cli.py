"""The predict and evaluate CLIs of the port on a (data, space) mesh of gloo
ranks on the CPU (`--space`, `--data`), against the same CLIs on one
device: GANet_small at 48x96, max_disp 24, synthetic frames, the fresh
seeded init (no checkpoint), every rank building the same weights.  This
process is rank 0 and starts the others (`parallel/launch.py`).

Tolerances: PNGs within one least significant bit (1/256 px: the sharded
and the one-device forward sum in other orders, and the writer truncates;
tests/test_torch_spatial.py bounds the float32 difference of the forward);
metrics within 1e-4 relative.
"""

import os

import numpy as np
import pytest

import ganet_tpu_torch.predict as t_predict
from ganet_tpu_torch import evaluate
from ganet_tpu_torch.data.png import read_disparity_png
from tests.torch_parity import two_torch_threads  # noqa: F401

SMALL = ["--model", "GANet_small", "--synthetic_data", "1", "--crop_height", "48",
         "--crop_width", "96", "--max_disp", "24", "--device", "cpu"]


@pytest.fixture(autouse=True)
def no_checkpoint(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # no ./checkpoint/: the seeded fresh init on every rank


def _pngs(paths):
    return {os.path.basename(p): read_disparity_png(p) for p in paths}


def test_predict_on_data2_space2_writes_the_one_device_pngs(tmp_path, capsys):
    one = _pngs(t_predict.main(SMALL + ["--batch", "2", "--save_path", str(tmp_path / "one")]))
    mesh = t_predict.main(SMALL + ["--batch", "2", "--space", "2", "--data", "2",
                                   "--save_path", str(tmp_path / "mesh")])
    assert sorted(os.listdir(tmp_path / "mesh")) == sorted(one) and len(one) == 4
    got = _pngs(mesh)
    for name, want in one.items():
        assert got[name].shape == want.shape == (48, 96)
        assert np.abs(got[name] - want).max() <= 1.0 / 256, name
    # Rank 0 alone writes and prints.
    assert capsys.readouterr().out.count("wrote") == 8


def test_predict_refuses_a_batch_that_data_does_not_divide(tmp_path):
    with pytest.raises(SystemExit, match="--batch 1 must be divisible by --data 2"):
        t_predict.main(SMALL + ["--batch", "1", "--data", "2", "--save_path", str(tmp_path / "x")])
    assert not (tmp_path / "x").exists()


@pytest.mark.parametrize("mesh", [["--space", "2"], ["--data", "2"]], ids=["space2", "data2"])
def test_evaluate_online_on_a_mesh_gives_the_one_device_metrics(mesh, capsys):
    """--data 2 batches 2 frames: the third is padded, and counted once."""
    args = SMALL + ["--test_list", "synthetic", "--max_samples", "3"]
    one = evaluate.main(args)
    got = evaluate.main(args + mesh)
    assert sorted(got) == sorted(one) == ["d1_all", "epe", "rate_1px", "rate_2px", "rate_3px"]
    for k, v in one.items():
        assert got[k] == pytest.approx(v, rel=1e-4, abs=1e-6), k
    assert capsys.readouterr().out.count("samples=3 ") == 2
