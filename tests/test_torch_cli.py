"""The port's predict, evaluate and bench entries against the JAX package's
CLIs, on the CPU, at GANet_small 48x96 with max_disp 24.

Fixture files are written from numpy seeds: three KITTI-2015-shaped frames
of 41x89 (padded to the 48x96 crop and unpadded back), sparse ground
truth, and an orbax checkpoint of seeded JAX variables (every BatchNorm
leaf seeded), converted into the port's checkpoint format.  JAX's
`predict.main` and `evaluation.main` run once each for the module.

Tolerances: PNGs within one least significant bit (1/256 px: the two
frameworks sum in other orders, and the writer truncates); metrics within
1e-4.
"""

import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch
from PIL import Image

import evaluation as j_evaluation
import predict as j_predict
from ganet_tpu.config import model_config as jmodel_config
from ganet_tpu.data.kitti_io import write_disparity_png
from ganet_tpu.models.ganet import GANet as JGANet
import ganet_tpu_torch.predict as t_predict
from ganet_tpu_torch import bench, build_model, evaluate, ganet_deep, ganet_small
from ganet_tpu_torch.convert import convert_flax_variables
from ganet_tpu_torch.ops import dispatch
from ganet_tpu_torch.ops.sga import SGA_MAX_D
from ganet_tpu_torch.train.checkpoint import save_checkpoint
from torch_parity import seeded_variables, two_torch_threads  # noqa: F401

j_sga = importlib.import_module("ganet_tpu.ops.sga")

H0, W0 = 41, 89  # frames smaller than the crop
CROP = ["--crop_height", "48", "--crop_width", "96", "--max_disp", "24", "--model", "GANet_small"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """KITTI-2015 fixture frames, the JAX and port checkpoints, and JAX's
    predictions and online metrics."""
    root = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    names = [f"{i:06d}_10.png" for i in range(3)]
    for sub in ("image_2", "image_3", "disp_occ_0"):
        os.makedirs(root / "kitti" / sub)
    for name in names:
        base = rng.integers(0, 256, (H0 // 4 + 2, W0 // 4 + 2, 3)).astype(np.float32)
        left = np.kron(base, np.ones((4, 4, 1)))[:H0, :W0] + rng.normal(0, 4, (H0, W0, 3))
        right = np.roll(left, -3, axis=1)
        for sub, img in (("image_2", left), ("image_3", right)):
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(root / "kitti" / sub / name)
        gt = (rng.random((H0, W0)) * 20).astype(np.float32)
        gt[rng.random((H0, W0)) < 0.4] = 0
        write_disparity_png(str(root / "kitti" / "disp_occ_0" / name), gt)
    (root / "kitti.list").write_text("\n".join(names))

    jcfg = jmodel_config("GANet_small", max_disp=24)
    model = JGANet(jcfg)
    dummy = jnp.zeros((1, 48, 96, 3))
    variables = seeded_variables(
        jax.jit(lambda k: model.init(k, dummy, dummy, train=True))(jax.random.PRNGKey(0)), 2)
    with ocp.CheckpointManager(str(root / "jax_ckpt")) as mgr:
        mgr.save(1, args=ocp.args.StandardSave(variables))
        mgr.wait_until_finished()
    port = build_model(ganet_small(24), "cpu", state_dict=convert_flax_variables(variables))
    save_checkpoint(str(root / "port_ckpt"), 1, port)

    data = ["--kitti2015", "1", "--data_path", str(root / "kitti"), "--test_list", str(root / "kitti.list")]
    j_predict.main(data + CROP + ["--resume", str(root / "jax_ckpt"), "--save_path", str(root / "jax_out")])
    online = j_evaluation.main(data + CROP + ["--resume", str(root / "jax_ckpt")])
    return {"root": root, "names": names, "data": data, "jax_online": online}


def _pngs(d, names):
    return [np.asarray(Image.open(os.path.join(d, n)), dtype=np.int64) for n in names]


@pytest.mark.parametrize("batch", ["1", "2"])
def test_predict_matches_jax_predict(files, tmp_path, batch):
    """The port's PNGs (unpadded to the 41x89 frames) equal JAX's within one
    LSB; batch 2 pads the last of three frames by repeating it."""
    root = files["root"]
    out = tmp_path / "port_out"
    written = t_predict.main(files["data"] + CROP + [
        "--resume", str(root / "port_ckpt"), "--save_path", str(out), "--device", "cpu",
        "--batch", batch])
    assert [os.path.basename(p) for p in written] == files["names"]
    for mine, ref in zip(_pngs(out, files["names"]), _pngs(root / "jax_out", files["names"])):
        assert mine.shape == ref.shape == (H0, W0)
        assert np.abs(mine - ref).max() <= 1
        assert ref.max() > 0


@pytest.mark.parametrize("weighting", ["image", "pixel"])
def test_evaluate_offline_matches_jax(files, weighting):
    root = files["root"]
    args = ["--pred_path", str(root / "jax_out"), "--gt_path", str(root / "kitti"),
            "--test_list", str(root / "kitti.list"), "--kitti2015", "1", "--max_disp", "24",
            "--weighting", weighting]
    mine, ref = evaluate.main(args), j_evaluation.main(args)
    assert sorted(mine) == sorted(ref) == ["d1_all", "epe", "rate_1px", "rate_2px", "rate_3px"]
    for k in ref:
        assert abs(mine[k] - ref[k]) <= 1e-4, (k, mine, ref)


def test_evaluate_online_matches_jax(files):
    root = files["root"]
    mine = evaluate.main(files["data"] + CROP + ["--resume", str(root / "port_ckpt"), "--device", "cpu"])
    ref = files["jax_online"]
    assert sorted(mine) == sorted(ref)
    for k in ref:
        assert abs(mine[k] - ref[k]) <= 1e-4, (k, mine, ref)


def test_fresh_init_fallback_warns_and_missing_resume_raises(files, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)  # no ./checkpoint/ here
    args = files["data"] + CROP + ["--device", "cpu", "--max_samples", "1"]
    evaluate.main(args)
    assert "WARNING" in capsys.readouterr().err
    t_predict.main(files["data"] + CROP + ["--device", "cpu", "--save_path", str(tmp_path / "out")])
    err = capsys.readouterr().err
    assert "WARNING" in err and "FRESH-INIT" in err
    for main in (evaluate.main, t_predict.main):
        with pytest.raises(FileNotFoundError, match="no checkpoint"):
            main(files["data"] + CROP + ["--device", "cpu", "--resume", str(tmp_path / "none")])


def test_meshes_are_not_ported(files):
    """Meshes are served now (tests/test_torch_spatial_cli.py); the flags
    that no mesh can serve exit before any rank starts: a height that
    --space cannot share, a --batch that --data does not divide (predict's;
    evaluate batches --data frames), an axis below 1."""
    for main in (evaluate.main, t_predict.main):
        with pytest.raises(SystemExit, match=r"multiple of 3 \* 2 \* 5 = 30"):
            main(files["data"] + CROP + ["--device", "cpu", "--space", "5"])
        with pytest.raises(SystemExit, match="at least 1"):
            main(files["data"] + CROP + ["--device", "cpu", "--data", "0"])
    with pytest.raises(SystemExit, match="divisible by --data 2"):
        t_predict.main(files["data"] + CROP + ["--device", "cpu", "--data", "2"])


def test_bench_quick_on_the_cpu(capsys):
    payload = bench.main(["--quick", "--device", "cpu", "--iters", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == payload
    assert sorted(payload) == ["metric", "probe_ms", "unit", "value", "vs_baseline"]
    assert payload["metric"] == "stereo_pairs_per_sec_per_chip_96x192_GANet_small"
    assert payload["unit"] == "pairs/s/chip" and payload["value"] > 0 and payload["probe_ms"] is None
    assert abs(payload["vs_baseline"] - payload["value"] / bench.BASELINE_PAIRS_PER_S) <= 1e-3


def test_entries_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["--quick"])
    with pytest.raises(RuntimeError, match="CUDA"):
        t_predict.main(["--synthetic_data", "1"] + CROP)


def test_build_model_refuses_a_volume_above_the_sga_kernels():
    """max_disp = 3 * SGA_MAX_D + 12 gives D = SGA_MAX_D + 4 bins: refused on
    a CUDA device before the model is built, with the limit named."""
    max_disp = 3 * SGA_MAX_D + 12
    assert max_disp == 1548
    with pytest.raises(ValueError, match=f"max_disp {max_disp}.*D <= {SGA_MAX_D}.*max_disp <= 1536"):
        build_model(ganet_deep(max_disp=max_disp), device="cuda")


def test_sga_above_128_bins_matches_jax():
    """The port's sga and its gradient at D = 132 against JAX's scan version."""
    rng = np.random.default_rng(3)
    B, D, H, W, C = 1, 132, 3, 5, 2
    x = (rng.integers(-3, 4, (B, D, H, W, C)) / 2.0).astype(np.float32)
    w = rng.standard_normal((B, H, W, C, 4, 5)).astype(np.float32)
    w /= np.abs(w).sum(-1, keepdims=True)
    gbar = rng.standard_normal((B, D, H, W, C)).astype(np.float32)
    out, vjp = jax.vjp(j_sga.sga, jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = vjp(jnp.asarray(gbar))
    xr = torch.from_numpy(x).requires_grad_()
    wr = torch.from_numpy(w).requires_grad_()
    got = dispatch.sga(xr, wr, impl="kernel")
    got.backward(torch.from_numpy(gbar))
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), **tol)
    np.testing.assert_allclose(xr.grad.numpy(), np.asarray(want_dx), **tol)
    np.testing.assert_allclose(wr.grad.numpy(), np.asarray(want_dw), **tol)
