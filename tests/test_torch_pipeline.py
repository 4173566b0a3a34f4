"""The port's `BatchIterator` against the JAX package's, on the CPU.

Over two epochs the port yields the same batches, bit for bit, as JAX's
iterator over the same samples: the synthetic set, and SceneFlow-shaped
PNG/PFM files written into tmp_path from a seed (training crops, drawn in
order from each dataset's one seeded generator; with and without the
right-view ground truth).  Each case runs with shuffle on and off, one
process or either slice of two, with the last partial batch dropped or
wrap-padded (its padding's valid masks zeroed), and with the port's
prefetch thread off and on.  JAX's side reads without its prefetch thread,
which ends an epoch only when the consumer keeps up with the reads: it
puts its end marker with `put_nowait` and drops it on a full queue.  The
port's blocks; `test_slow_consumer_reaches_the_end_of_an_epoch` pins it.
"""

import os
import threading
import time

import numpy as np
import pytest

from ganet_tpu.data import dataset as jds
from ganet_tpu.data.pipeline import BatchIterator as JBatchIterator
from ganet_tpu_torch.data import dataset as tds
from ganet_tpu_torch.data import png
from ganet_tpu_torch.data.pfm import write_pfm
from ganet_tpu_torch.data.pipeline import BatchIterator, process_coordinates

N_FILES, FRAME, CROP = 5, (60, 110), (48, 96)


@pytest.fixture(scope="module")
def sceneflow(tmp_path_factory):
    """A SceneFlow-shaped tree of N_FILES frames (left and right PNGs, PFM
    disparity signed by view) and its list file."""
    root = tmp_path_factory.mktemp("sceneflow")
    rng = np.random.default_rng(15)
    H, W = FRAME
    lines = []
    for i in range(N_FILES):
        line = f"frames_finalpass/TRAIN/A/{i:04d}/left/0006.png"
        lines.append(line)
        left = rng.integers(0, 256, (H, W, 3)).astype(np.uint8)
        disp = rng.uniform(0.5, 30.0, (H, W)).astype(np.float32)
        for view, sign in (("left", -1.0), ("right", 1.0)):
            img_dir = root / os.path.dirname(line).replace("left", view)
            pfm_dir = root / os.path.dirname(line).replace("left", view).replace(
                "frames_finalpass", "disparity")
            os.makedirs(img_dir, exist_ok=True)
            os.makedirs(pfm_dir, exist_ok=True)
            png.write_png(str(img_dir / "0006.png"), left if view == "left" else np.roll(left, -3, 1))
            write_pfm(str(pfm_dir / "0006.pfm"), sign * disp)
    lst = root / "train.list"
    lst.write_text("\n".join(lines))
    return str(root), str(lst)


def _datasets(kind, files):
    """(the port's dataset, JAX's dataset) of a case, fresh: the training
    crops' generators start from their seed."""
    if kind == "synthetic":
        return tds.SyntheticStereoDataset(length=7), jds.SyntheticStereoDataset(length=7)
    root, lst = files
    common = dict(data_path=root, list_path=lst, crop_height=CROP[0], crop_width=CROP[1],
                  kind="sceneflow", training=True, max_disp=24, seed=2,
                  left_right=kind == "files_left_right")
    return tds.StereoDataset(**common), jds.StereoDataset(**common, use_native=False)


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("drop_remainder", [True, False], ids=["drop", "pad"])
@pytest.mark.parametrize("slice_", [(0, 1), (0, 2), (1, 2)], ids=["one", "first_of_2", "second_of_2"])
@pytest.mark.parametrize("shuffle", [True, False], ids=["shuffle", "in_order"])
@pytest.mark.parametrize("kind", ["synthetic", "files", "files_left_right"])
def test_batches_equal_jax(sceneflow, kind, shuffle, slice_, drop_remainder, prefetch):
    mine_ds, ref_ds = _datasets(kind, sceneflow)
    index, count = slice_
    common = dict(batch_size=2, shuffle=shuffle, seed=4, drop_remainder=drop_remainder,
                  process_index=index, process_count=count)
    mine = BatchIterator(mine_ds, prefetch=prefetch, **common)
    ref = JBatchIterator(ref_ds, prefetch=0, **common)
    assert len(mine) == len(ref) == len(ref_ds) // 2 + (not drop_remainder)
    for epoch in range(2):
        got, want = list(mine), list(ref)
        assert len(got) == len(want) == len(ref)
        for a, b in zip(got, want):
            assert sorted(a) == sorted(b)
            for k in b:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (epoch, k)
            assert a["left"].shape[0] == 2 // count
        assert mine.epoch == ref.epoch == epoch + 1
    if not drop_remainder:
        # The tail: one real sample and one wrap-padded duplicate, whose
        # valid masks are zero on the slice that holds it.
        last = got[-1]
        keys = [k for k in ("valid", "valid_right") if k in last]
        assert keys == (["valid", "valid_right"] if kind == "files_left_right" else ["valid"])
        if count == 1:
            assert last["valid"][0].sum() > 0 and all(last[k][1].sum() == 0 for k in keys)
        else:
            assert all((last[k].sum() == 0) == (index == 1) for k in keys)


def test_default_process_coordinates():
    """Without torch.distributed initialised, one process of one."""
    assert process_coordinates() == (0, 1)
    it = BatchIterator(tds.SyntheticStereoDataset(length=4), 2)
    assert (it.process_index, it.process_count, it.local_batch) == (0, 1, 2)


def test_indivisible_batch_rejected():
    with pytest.raises(ValueError, match="not divisible"):
        BatchIterator(tds.SyntheticStereoDataset(length=8), 3, process_count=2)


def test_early_break_reaps_prefetch_thread_and_advances_epoch():
    it = BatchIterator(tds.SyntheticStereoDataset(length=16), 2, shuffle=True, seed=0, prefetch=2)
    before = threading.active_count()
    gen = iter(it)
    first = next(gen)["disparity"].copy()
    time.sleep(0.2)  # the producer fills the queue and waits on it
    gen.close()
    # The producer has exited, and the next pass reshuffles.
    assert threading.active_count() <= before
    assert it.epoch == 1
    second = next(iter(it))["disparity"]
    assert not np.array_equal(first, second)


def test_slow_consumer_reaches_the_end_of_an_epoch():
    """A consumer slower than the reads finds the end marker behind a full
    queue (JAX's iterator drops it and waits forever here)."""
    it = BatchIterator(tds.SyntheticStereoDataset(length=4), 1, shuffle=False, prefetch=2)
    seen = []

    def consume():
        for batch in it:
            time.sleep(0.1)
            seen.append(batch["disparity"])

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive(), "the iterator never ended its epoch"
    assert len(seen) == 4


def test_producer_errors_reach_the_consumer():
    class Broken:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise OSError(f"unreadable sample {i}")

    with pytest.raises(OSError, match="unreadable sample"):
        list(BatchIterator(Broken(), 2, shuffle=False, prefetch=2))
