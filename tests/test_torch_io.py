"""The port's file readers and checkpoints against the JAX package and
Pillow, on the CPU.

Fixture files are written in tmp_path from numpy seeds.  Pillow is the
reference PNG codec: the port reads Pillow's files (with the row filters
Pillow chooses) and files made here with each of the five filters, and
Pillow reads the port's files.  Samples of `StereoDataset` equal the JAX
package's with `use_native=False`, in test mode and as training crops.  A
JAX checkpoint written with orbax goes through the conversion recipe into
the port's format and back out bit for bit.
"""

import dataclasses
import json
import os
import struct
import zlib

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch
from PIL import Image

from ganet_tpu.config import DataConfig as JDataConfig
from ganet_tpu.data import dataset as jds
from ganet_tpu.data import kitti_io as jkio
from ganet_tpu.data import lists as jlists
from ganet_tpu.data import pfm as jpfm
from ganet_tpu.train import trainer as jtrainer
from ganet_tpu_torch import ganet_small
from ganet_tpu_torch.entry import build_model, predict
from ganet_tpu_torch.config import DataConfig
from ganet_tpu_torch.convert import convert_flax_variables
from ganet_tpu_torch.data import dataset as tds
from ganet_tpu_torch.data import lists as tlists
from ganet_tpu_torch.data import pfm as tpfm
from ganet_tpu_torch.data import png
from ganet_tpu_torch.train import checkpoint as ckpt
from torch_parity import seeded_variables


def _smooth(rng, shape):
    """A smooth 8-bit image with noise, as a photograph compresses."""
    h, w = shape[:2]
    c = shape[2] if len(shape) == 3 else 1
    base = rng.integers(0, 256, (h // 6 + 2, w // 6 + 2, c)).astype(np.float32)
    t = np.kron(base, np.ones((6, 6, 1)))[:h, :w] + rng.normal(0, 6, (h, w, c))
    t = np.clip(t, 0, 255).astype(np.uint8)
    return t.reshape(shape)


def _filters(path):
    """The row filter types of a PNG file."""
    data = open(path, "rb").read()
    w, h, depth, colour = struct.unpack(">IIBB", data[16:26])
    pos, idat = 8, []
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos : pos + 8])
        if kind == b"IDAT":
            idat.append(data[pos + 8 : pos + 8 + n])
        pos += 12 + n
    raw = zlib.decompress(b"".join(idat))
    stride = w * {0: 1, 2: 3, 6: 4}[colour] * depth // 8 + 1
    return {raw[y * stride] for y in range(h)}


# ---------------------------------------------------------------------------
# PFM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(13, 21), (9, 17, 3)])
def test_pfm_round_trip_and_both_readers(tmp_path, shape):
    a = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    tpfm.write_pfm(str(tmp_path / "t.pfm"), a)
    jpfm.write_pfm(str(tmp_path / "j.pfm"), a)
    for path in ("t.pfm", "j.pfm"):
        np.testing.assert_array_equal(tpfm.read_pfm(str(tmp_path / path)), a)
        np.testing.assert_array_equal(jpfm.read_pfm(str(tmp_path / path)), a)
    assert (tmp_path / "t.pfm").read_bytes() == (tmp_path / "j.pfm").read_bytes()


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

PNG_KINDS = [((37, 53, 3), "RGB"), ((40, 61, 4), "RGBA"), ((33, 47), "L"), ((29, 41), "I;16")]


@pytest.mark.parametrize("shape,mode", PNG_KINDS, ids=[m for _, m in PNG_KINDS])
def test_png_reads_pillow_files(tmp_path, shape, mode):
    rng = np.random.default_rng(2)
    a = (rng.random(shape) * 65535).astype(np.uint16) if mode == "I;16" else _smooth(rng, shape)
    path = str(tmp_path / "p.png")
    Image.fromarray(a).save(path)
    assert Image.open(path).mode == mode
    np.testing.assert_array_equal(png.read_png(path), a)
    assert png.png_size(path) == shape[:2]
    np.testing.assert_array_equal(png.read_image(path), jkio.read_image(path))
    if a.ndim == 2:
        np.testing.assert_array_equal(png.read_disparity_png(path), jkio.read_disparity_png(path))
    else:
        with pytest.raises(ValueError, match="single-channel"):
            png.read_disparity_png(path)


def test_pillow_files_use_several_filters(tmp_path):
    """Pillow filters row by row; its files above carry several filter
    types, so the port reads what an encoder chooses, not one filter."""
    rng = np.random.default_rng(3)
    seen = set()
    for i, (shape, _) in enumerate(PNG_KINDS[:3]):
        path = str(tmp_path / f"{i}.png")
        Image.fromarray(_smooth(rng, shape)).save(path)
        seen |= _filters(path)
    assert len(seen) >= 3, seen


def _encode(image, filt):
    """A PNG of an 8-bit RGB or 16-bit gray array with every row filtered
    by `filt` (or row y by `filt[y % len(filt)]`), encoded here byte by byte
    as the PNG spec states it."""
    filts = (filt,) if isinstance(filt, int) else tuple(filt)
    if image.dtype == np.uint16:
        colour, depth, bpp = 0, 16, 2
        raw = image.astype(">u2").view(np.uint8).reshape(image.shape[0], -1)
    else:
        colour, depth, bpp = 2, 8, 3
        raw = image.reshape(image.shape[0], -1)
    h, n = raw.shape
    out = bytearray()
    for y in range(h):
        filt = filts[y % len(filts)]
        out.append(filt)
        for x in range(n):
            a = int(raw[y, x - bpp]) if x >= bpp else 0
            b = int(raw[y - 1, x]) if y else 0
            c = int(raw[y - 1, x - bpp]) if y and x >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            paeth = a if pa <= pb and pa <= pc else b if pb <= pc else c
            pred = (0, a, b, (a + b) // 2, paeth)[filt]
            out.append((int(raw[y, x]) - pred) % 256)
    ihdr = struct.pack(">IIBBBBB", image.shape[1], h, depth, colour, 0, 0, 0)
    chunk = lambda k, d: struct.pack(">I", len(d)) + k + d + struct.pack(">I", zlib.crc32(k + d))  # noqa: E731
    return b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b"")


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4], ids=["none", "sub", "up", "average", "paeth"])
def test_png_reads_every_filter(tmp_path, filt):
    rng = np.random.default_rng(4 + filt)
    for i, a in enumerate((_smooth(rng, (11, 17, 3)), (rng.random((7, 13)) * 65535).astype(np.uint16))):
        path = tmp_path / f"{i}.png"
        path.write_bytes(_encode(a, filt))
        assert _filters(str(path)) == {filt}
        np.testing.assert_array_equal(np.asarray(Image.open(path)), a)  # the file is valid
        np.testing.assert_array_equal(png.read_png(str(path)), a)


@pytest.mark.parametrize("rows", [(0, 1, 2, 2, 1), (2, 0, 4, 1, 3)], ids=["linear", "all"])
def test_png_reads_rows_of_mixed_filters(tmp_path, rows):
    """Rows filtered None, Sub and Up are undone row by row; a file with an
    Average or Paeth row goes through the wavefront."""
    rng = np.random.default_rng(9)
    for i, a in enumerate((_smooth(rng, (12, 19, 3)), (rng.random((10, 14)) * 65535).astype(np.uint16))):
        path = tmp_path / f"{i}.png"
        path.write_bytes(_encode(a, rows))
        assert _filters(str(path)) == set(rows)
        np.testing.assert_array_equal(png.read_png(str(path)), a)


@pytest.mark.parametrize("shape,dtype", [((23, 31, 3), np.uint8), ((19, 27, 4), np.uint8),
                                         ((17, 29), np.uint8), ((21, 33), np.uint16)])
def test_png_writer_read_by_pillow(tmp_path, shape, dtype):
    rng = np.random.default_rng(5)
    a = (rng.random(shape) * np.iinfo(dtype).max).astype(dtype)
    path = str(tmp_path / "w.png")
    png.write_png(path, a)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), a)
    np.testing.assert_array_equal(png.read_png(path), a)


def test_disparity_png_matches_the_jax_writer(tmp_path):
    rng = np.random.default_rng(6)
    d = (rng.random((31, 45)) * 300 - 20).astype(np.float32)  # below 0 and above 255 px
    d[0, 0], d[0, 1] = 1e6, 1 / 256 - 1e-7
    png.write_disparity_png(str(tmp_path / "t.png"), d)
    jkio.write_disparity_png(str(tmp_path / "j.png"), d)
    want = np.asarray(Image.open(tmp_path / "j.png"))
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t.png")), want)
    np.testing.assert_array_equal(png.read_disparity_png(str(tmp_path / "t.png")),
                                  jkio.read_disparity_png(str(tmp_path / "j.png")))


def test_png_refuses_what_it_cannot_read(tmp_path):
    Image.fromarray(np.zeros((4, 5), np.uint8)).convert("P").save(tmp_path / "p.png")
    with pytest.raises(ValueError, match="palette"):
        png.read_png(str(tmp_path / "p.png"))
    Image.fromarray(np.zeros((4, 5), np.uint8)).convert("LA").save(tmp_path / "la.png")
    with pytest.raises(ValueError, match="unsupported"):
        png.read_png(str(tmp_path / "la.png"))
    Image.fromarray(np.zeros((4, 5, 3), np.uint8)).save(tmp_path / "i.png")
    data = bytearray((tmp_path / "i.png").read_bytes())
    data[28] = 1  # the IHDR's interlace byte
    (tmp_path / "i.png").write_bytes(bytes(data))
    with pytest.raises(ValueError, match="interlaced"):
        png.read_png(str(tmp_path / "i.png"))


# ---------------------------------------------------------------------------
# lists, paths and samples
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,line", [
    ("sceneflow", "frames_finalpass/TRAIN/A/0000/left/0006.png"),
    ("sceneflow", "frames_cleanpass/TEST/B/0001/left/0010.png"),
    ("kitti2015", "000003_10.png"),
    ("kitti2012", "000007_10.png"),
])
def test_derive_paths_equal_jax(kind, line):
    mine, ref = tlists.derive_paths("/data", line, kind), jlists.derive_paths("/data", line, kind)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


def test_derive_paths_refuse_like_jax():
    for mod in (tlists, jlists):
        with pytest.raises(ValueError):
            mod.derive_paths("/d", "no_left_dir/0.png", "sceneflow")
        with pytest.raises(ValueError):
            mod.derive_paths("/d", "0.png", "middlebury")


def _kitti_root(root, rng, n=3, H=41, W=89):
    """KITTI-2015-shaped files: RGB pairs and sparse uint16 ground truth."""
    names = [f"{i:06d}_10.png" for i in range(n)]
    for sub in ("image_2", "image_3", "disp_occ_0"):
        os.makedirs(root / sub, exist_ok=True)
    for name in names:
        for sub in ("image_2", "image_3"):
            Image.fromarray(_smooth(rng, (H, W, 3))).save(root / sub / name)
        gt = (rng.random((H, W)) * 30).astype(np.float32)
        gt[rng.random((H, W)) < 0.5] = 0
        jkio.write_disparity_png(str(root / "disp_occ_0" / name), gt)
    lst = root / "kitti.list"
    lst.write_text("# comment\n" + "\n".join(names) + "\n\n")
    return str(lst)


def _sceneflow_root(root, rng, n=2, H=30, W=70):
    lines = []
    for i in range(n):
        line = f"frames_finalpass/TRAIN/A/{i:04d}/left/0006.png"
        lines.append(line)
        for view in ("left", "right"):
            img = root / line.replace("/left/", f"/{view}/")
            os.makedirs(img.parent, exist_ok=True)
            Image.fromarray(_smooth(rng, (H, W, 3))).save(img)
            d = root / line.replace("frames_finalpass", "disparity").replace("/left/", f"/{view}/")
            os.makedirs(d.parent, exist_ok=True)
            jpfm.write_pfm(str(d.with_suffix(".pfm")), rng.normal(0, 20, (H, W)).astype(np.float32))
    lst = root / "sf.list"
    lst.write_text("\n".join(lines))
    return str(lst)


def _same_samples(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("kind", ["kitti2015", "sceneflow"])
def test_samples_equal_jax(tmp_path, kind):
    """Test-mode samples (padded to the crop) and training crops from the
    same seed, draw after draw, equal the JAX package's python path."""
    rng = np.random.default_rng(7)
    root = tmp_path / kind
    lst = _kitti_root(root, rng) if kind == "kitti2015" else _sceneflow_root(root, rng)
    assert tlists.read_list(lst) == jlists.read_list(lst)
    for training, (ch, cw) in ((False, (48, 96)), (True, (24, 48)), (True, (48, 96))):
        common = dict(data_path=str(root), list_path=lst, crop_height=ch, crop_width=cw,
                      kind=kind, training=training, max_disp=24, seed=3,
                      left_right=kind == "sceneflow")
        mine = tds.StereoDataset(**common)
        ref = jds.StereoDataset(**common, use_native=False)
        assert len(mine) == len(ref)
        for i in list(range(len(ref))) * 2:  # twice: the generator advances
            _same_samples(mine[i], ref[i])
            if not training:
                assert mine.original_size(i) == ref.original_size(i)


def test_dataset_factories_equal_jax(tmp_path):
    rng = np.random.default_rng(8)
    lst = _kitti_root(tmp_path, rng, n=2)
    kw = dict(data_path=str(tmp_path), training_list=lst, val_list=lst, crop_height=48,
              crop_width=96, kind="kitti2015")
    for make_t, make_j in ((tds.get_training_set, jds.get_training_set),
                           (tds.get_test_set, jds.get_test_set)):
        mine, ref = make_t(DataConfig(**kw), 24), make_j(JDataConfig(**kw), 24)
        ref.use_native = False
        for i in range(len(ref)):
            _same_samples(mine[i], ref[i])
    syn = dict(kind="synthetic", crop_height=48, crop_width=96)
    _same_samples(tds.get_test_set(DataConfig(**syn), 24)[1], jds.get_test_set(JDataConfig(**syn), 24)[1])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_small():
    """Seeded GANet_small variables at 48x96 (every BatchNorm leaf seeded)."""
    from ganet_tpu.config import model_config as jmodel_config
    from ganet_tpu.models.ganet import GANet as JGANet

    jcfg = jmodel_config("GANet_small", max_disp=24)
    dummy = jax.numpy.zeros((1, 48, 96, 3))
    model = JGANet(jcfg)
    v = jax.jit(lambda k: model.init(k, dummy, dummy, train=True))(jax.random.PRNGKey(0))
    return jcfg, seeded_variables(v, 1)


def test_orbax_checkpoint_converts_bit_exact(tmp_path, jax_small):
    """orbax (JAX) -> load_inference_state -> convert_flax_variables -> the
    port's save_checkpoint -> load_inference_state: the same bits, and the
    same predictions as the model built from the converted weights."""
    _, variables = jax_small
    with ocp.CheckpointManager(str(tmp_path / "jax")) as mgr:
        mgr.save(7, args=ocp.args.StandardSave(variables))
        mgr.wait_until_finished()
    state = jtrainer.load_inference_state(str(tmp_path / "jax"))
    sd = convert_flax_variables(jax.device_get({"params": state.params, "batch_stats": state.batch_stats}))
    cfg = ganet_small(24)
    model = build_model(cfg, "cpu", state_dict=sd)
    path = ckpt.save_checkpoint(str(tmp_path / "port"), 7, model, extra={"epoch": 2})
    assert path == str(tmp_path / "port" / "7")
    back = ckpt.load_inference_state(str(tmp_path / "port"))
    direct = convert_flax_variables(variables)
    assert sorted(back) == sorted(direct) == sorted(model.state_dict())
    for k in direct:
        assert back[k].dtype == direct[k].dtype and torch.equal(back[k], direct[k]), k
    meta = ckpt.load_meta(str(tmp_path / "port"))
    assert meta["step"] == 7 and meta["epoch"] == 2 and meta["model_config"]["name"] == "GANet_small"
    rng = np.random.default_rng(9)
    left, right = (rng.random((1, 48, 96, 3), dtype=np.float32) for _ in range(2))
    again = build_model(cfg, "cpu", state_dict=back)
    assert torch.equal(predict(again, left, right), predict(model, left, right))


def test_checkpoints_keep_the_newest(tmp_path):
    cfg = ganet_small(24)
    model = build_model(cfg, "cpu", seed=0)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    root = str(tmp_path / "ck")
    assert ckpt.latest_step(root) is None
    with pytest.raises(FileNotFoundError):
        ckpt.load_inference_state(root)
    for step in (1, 2, 3, 4):
        with torch.no_grad():
            next(model.parameters()).add_(1.0)
        ckpt.save_checkpoint(root, step, model, optimizer=opt, keep=2)
    assert sorted(os.listdir(root)) == ["3", "4"]
    assert ckpt.latest_step(root) == 4
    assert set(os.listdir(os.path.join(root, "4"))) == {"model.pt", "optimizer.pt", "meta.json"}
    first = next(iter(ckpt.load_inference_state(root, step=3).values()))
    assert torch.equal(first + 1.0, next(model.parameters()).detach())
    with pytest.raises(FileNotFoundError):
        ckpt.load_inference_state(root, step=1)
    # Saving a step again replaces it; a leftover temporary directory of a
    # killed save is not a checkpoint.
    os.makedirs(os.path.join(root, ".9.killed"))
    ckpt.save_checkpoint(root, 4, model, keep=2)
    assert ckpt.latest_step(root) == 4
    assert json.load(open(os.path.join(root, "4", "meta.json")))["step"] == 4


def test_fresh_init_state_is_the_seeded_model():
    cfg = ganet_small(24)
    sd = ckpt.fresh_init_state(cfg, seed=5)
    want = build_model(cfg, "cpu", seed=5).state_dict()
    assert all(torch.equal(sd[k], want[k]) for k in want)
