"""The port's training benchmarks against the JAX scripts they stand for:
`python -m ganet_tpu_torch.bench_train`, `.profile_train` and
`.bench_scaling` against `scripts/bench_train.py`, `profile_train.py` and
`bench_scaling.py` (their flags, defaults and JSON keys), run on the CPU
at GANet_small 48x96, max_disp 24; and the timing helpers of
`ganet_tpu_torch/utils/profiling.py`.

The JAX scripts are not run: their parsers are captured as `main` calls
`parse_args`, and the keys of their rows are read from their source."""

from __future__ import annotations

import argparse
import ast
import importlib.util
import json
import math
import os
import pathlib
import re

import pytest
import torch

from ganet_tpu_torch import bench_scaling, bench_train, profile_train
from ganet_tpu_torch.config import DataConfig, TrainConfig, ganet_small
from ganet_tpu_torch.train.trainer import create_train_state, make_train_step
from ganet_tpu_torch.utils import MetricLogger, Timer, benchmark_fn  # noqa: F401
from ganet_tpu_torch.utils.profiling import chained_ms, synchronize, trace
from tests.torch_parity import two_torch_threads  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
SMALL = ["--model", "GANet_small", "--max_disp", "24", "--device", "cpu"]
PORTS = {"bench_train": bench_train, "profile_train": profile_train,
         "bench_scaling": bench_scaling}


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_parser(name, monkeypatch):
    """The parser that the JAX script's `main` builds, caught at its
    `parse_args` call."""
    parsers = []

    class Stop(Exception):
        pass

    def capture(self, argv=None, namespace=None):
        parsers.append(self)
        raise Stop

    real = argparse.ArgumentParser.parse_args
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(Stop):
        _jax_script(name).main([])
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", real)
    return parsers[0]


def _dict_keys(node) -> list:
    return [k.value for k in node.keys if isinstance(k, ast.Constant)]


def _jax_keys(name) -> dict:
    """The keys of the rows each JAX script prints, from its source:
    bench_train's measured row (`return {...}` in `bench_one`) and failure
    row (`r = {...}` in `main`); profile_train's `results` (its literal and
    every `results[...] =`); bench_scaling's `rec` and summary line."""
    tree = ast.parse((ROOT / "scripts" / f"{name}.py").read_text())
    keys = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Dict):
            keys["row"] = _dict_keys(node.value)
        elif isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            target = node.targets[0]
            if isinstance(target, ast.Name):
                keys.setdefault(target.id, []).extend(_dict_keys(node.value))
        elif (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript)
              and isinstance(node.targets[0].value, ast.Name)
              and isinstance(node.targets[0].slice, ast.Constant)):
            keys.setdefault(node.targets[0].value.id, []).append(node.targets[0].slice.value)
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "dumps"
              and node.args and isinstance(node.args[0], ast.Dict)):
            keys.setdefault("dumped", []).append(_dict_keys(node.args[0]))
    return keys


def _json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


# ---------------------------------------------------------------------------
# flags
# ---------------------------------------------------------------------------

OTHER_ARGV = {
    "bench_train": ["--model", "GANet11", "--height", "96", "--width", "192", "--max_disp", "48",
                    "--dtype", "float32", "--batches", "2,4", "--remat", "sga", "--impl", "pallas",
                    "--lr", "2e-4", "--steps", "3", "--json", "x.jsonl"],
    "profile_train": ["--model", "GANet11", "--height", "96", "--width", "192", "--max_disp", "48",
                      "--dtype", "float32", "--batch", "2", "--remat", "none"],
    "bench_scaling": ["--meshes", "1,1,1", "2x2", "--model", "GANet_deep", "--crop_height", "96",
                      "--crop_width", "192", "--max_disp", "48", "--batch_per_chip", "2",
                      "--steps", "3", "--warmup", "1", "--real", "--force_cpu_devices", "4"],
}


@pytest.mark.parametrize("name", sorted(PORTS))
def test_flags_and_defaults_equal_the_jax_scripts(name, monkeypatch):
    ref = _jax_parser(name, monkeypatch)
    port = PORTS[name]
    for argv in ([], OTHER_ARGV[name]):
        mine = vars(port.parse_args(argv))
        assert mine.pop("device") is None
        assert mine == vars(ref.parse_args(argv)), argv
    assert vars(port.parse_args(["--device", "cpu"]))["device"] == "cpu"


@pytest.mark.parametrize("name", sorted(PORTS))
def test_each_entry_point_raises_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the entry point uses it")
    with pytest.raises(RuntimeError, match="CUDA"):
        PORTS[name].main([])


# ---------------------------------------------------------------------------
# bench_train
# ---------------------------------------------------------------------------


def test_bench_train_rows_on_the_cpu(capsys, tmp_path):
    out = tmp_path / "rows.jsonl"
    rows = bench_train.main(SMALL + ["--height", "48", "--width", "96", "--batches", "1,2",
                                     "--steps", "1", "--json", str(out)])
    printed = capsys.readouterr()
    assert _json_lines(printed.out) == rows
    assert [json.loads(line) for line in out.read_text().splitlines()] == rows
    keys = _jax_keys("bench_train")["row"]
    assert [r["batch"] for r in rows] == [1, 2]
    for r in rows:
        assert list(r) == keys
        assert r["compiler_memory"] == {} and r["runtime_memory"] == {}
        assert (r["model"], r["shape"], r["max_disp"], r["remat"]) == ("GANet_small", "48x96", 24, "none")
        assert math.isfinite(r["loss"]) and r["ms_per_step"] > 0
        # pairs/s from the unrounded time: the rounded ms moves it by at most 0.05 ms in ms_per_step.
        ms = r["ms_per_step"]
        assert r["batch"] / ((ms + 0.05) / 1e3) - 1e-3 <= r["pairs_per_s"] <= r["batch"] / ((ms - 0.05) / 1e3) + 1e-3
    assert len(re.findall(r"^# batch=\d remat=none launches a step: \{", printed.err, re.M)) == 2


def _stub_rows(monkeypatch, fail_at, error):
    """bench_one stubbed: measured peaks of 4 and 7 GiB at batches 1 and 2,
    `error` raised at `fail_at`; the card's memory stated as 10 GiB."""
    calls = []

    def stub(model, H, W, D, dtype, batch, remat, lr, steps, impl="auto", device=None):
        calls.append(batch)
        if batch == fail_at:
            raise error
        return {"model": model, "batch": batch, "loss": 1.0,
                "runtime_memory": {"peak_bytes_in_use": {1: 4, 2: 7}[batch] * 2**30}}

    monkeypatch.setattr(bench_train, "bench_one", stub)
    monkeypatch.setattr(bench_train, "bytes_limit", lambda device: 10 * 2**30)
    return calls


def test_bench_train_out_of_memory_ends_the_probe_with_a_failure_row(monkeypatch, capsys, tmp_path):
    calls = _stub_rows(monkeypatch, 4, torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 9 GiB"))
    out = tmp_path / "rows.jsonl"
    rows = bench_train.main(SMALL + ["--batches", "1,2,4,8", "--json", str(out)])
    assert calls == [1, 2, 4]  # the probe stops at the first failure
    assert _json_lines(capsys.readouterr().out) == rows
    assert len(out.read_text().splitlines()) == 3
    fail = rows[-1]
    assert list(fail) == _jax_keys("bench_train")["r"]
    assert fail["batch"] == 4 and fail["remat"] == "none"
    assert fail["reason"].startswith("HBM-infeasible: extrapolated peak memory ≈13.0 GiB > 10 GiB")
    assert fail["estimated_total_bytes"] == 13 * 2**30 and fail["hbm_limit_bytes"] == 10 * 2**30
    assert fail["error_head"].startswith("OutOfMemoryError: CUDA out of memory")


def test_bench_train_reason_texts():
    pts = [(1, 4 * 2**30), (2, 7 * 2**30)]
    assert bench_train.failure_reason(4, pts, 13.5 * 2**30)[0].startswith("HBM-infeasible at the boundary")
    assert bench_train.failure_reason(4, pts, 40 * 2**30)[0].startswith("out of memory well below")
    assert bench_train.failure_reason(4, pts[:1], None) == (
        "out of memory; extrapolated peak memory ≈16.0 GiB, device memory limit unknown on this device",
        16 * 2**30)
    assert bench_train.failure_reason(4, [], 10)[1] is None


def test_bench_train_lets_any_other_error_propagate(monkeypatch, capsys):
    calls = _stub_rows(monkeypatch, 2, RuntimeError("the kernel failed to launch"))
    with pytest.raises(RuntimeError, match="failed to launch"):
        bench_train.main(SMALL + ["--batches", "1,2,4"])
    assert calls == [1, 2]


# ---------------------------------------------------------------------------
# profile_train
# ---------------------------------------------------------------------------


def test_profile_train_split_and_its_forward_loss(capsys):
    row = profile_train.main(SMALL + ["--height", "48", "--width", "96", "--batch", "1",
                                      "--remat", "sga"])
    printed = capsys.readouterr()
    assert _json_lines(printed.out) == [row]
    assert list(row) == _jax_keys("profile_train")["results"]
    assert (row["batch"], row["remat"], row["shape"], row["dtype"]) == (1, "sga", "48x96", "bfloat16")
    assert row["bwd_attrib_ms"] == round(row["fwd_bwd_ms"] - row["fwd_train_ms"], 1)
    assert row["optimizer_attrib_ms"] == round(row["full_step_ms"] - row["fwd_bwd_ms"], 1)
    assert min(row["fwd_train_ms"], row["fwd_bwd_ms"], row["full_step_ms"]) > 0
    loss = float(re.search(r"fwd_train loss=(\S+)", printed.err).group(1))

    # The first train step on a fresh state from the same seed and batch.
    cfg = TrainConfig(model=ganet_small(24, compute_dtype="bfloat16", remat="sga"),
                      data=DataConfig(crop_height=48, crop_width=96, kind="synthetic"), batch_size=1)
    state = create_train_state(cfg, "cpu")
    ref = float(make_train_step(cfg)(state, bench_train.random_batch(1, 48, 96, 24, torch.device("cpu")))["loss"])
    assert math.isfinite(loss)
    assert loss == pytest.approx(ref, rel=1e-6)


# ---------------------------------------------------------------------------
# bench_scaling
# ---------------------------------------------------------------------------


def test_bench_scaling_on_cpu_ranks(capsys):
    rows = bench_scaling.main(SMALL + ["--crop_height", "48", "--crop_width", "96", "--meshes",
                                       "1,1,1", "2,1,1", "1,1,8", "--steps", "1", "--warmup", "1"])
    lines = _json_lines(capsys.readouterr().out)
    keys = _jax_keys("bench_scaling")
    assert lines[:2] == rows and [r["mesh"] for r in rows] == [[1, 1, 1], [2, 1, 1]]
    for r in rows:
        assert list(r) == keys["rec"]
        assert r["pairs_per_s"] is r["pairs_per_s_per_chip"] is r["efficiency_vs_1chip"] is None
        assert r["plumbing_only"] is True and r["backend"] == "cpu"
        assert math.isfinite(r["loss"])
    assert (rows[1]["devices"], rows[1]["global_batch"]) == (2, 2)
    # The refused mesh: a skipped row, as JAX prints a mesh it cannot place.
    skipped_keys, summary_keys = (next(k for k in keys["dumped"] if key in k)
                                  for key in ("skipped", "summary"))
    skipped = lines[2]
    assert list(skipped) == skipped_keys and skipped["mesh"] == [1, 1, 8]
    assert skipped["skipped"].startswith("disp 8 cannot share max_disp 24")
    summary = lines[3]
    assert list(summary) == summary_keys
    assert summary["meshes_run"] == [[1, 1, 1], [2, 1, 1]] and summary["backend"] == "cpu"


@pytest.mark.parametrize("flags, match", [(["--force_cpu_devices", "8"], "--device cpu"),
                                          (["--real"], "--real names the card")],
                         ids=["force_cpu_devices", "real_on_the_cpu"])
def test_bench_scaling_refuses_flags_it_cannot_honour(flags, match):
    with pytest.raises(ValueError, match=match):
        bench_scaling.main(SMALL + flags)


# ---------------------------------------------------------------------------
# utils/profiling.py
# ---------------------------------------------------------------------------


def test_timer_sums_laps_by_name():
    timer = Timer()
    for _ in range(2):
        with timer.lap("a"):
            pass
    with timer.lap("b"):
        sum(range(1000))
    assert set(timer.laps) == {"a", "b"} and all(v >= 0 for v in timer.laps.values())


def test_benchmark_fn_returns_time_and_the_last_result():
    calls = []

    def fn(x):
        calls.append(x)
        return torch.full((2,), float(len(calls)))

    sec, last = benchmark_fn(fn, 3, warmup=2, iters=5)
    assert len(calls) == 7 and sec >= 0
    assert torch.equal(last, torch.full((2,), 7.0))


def test_chained_ms_is_the_time_one_more_call_adds():
    """The chain's first call pays 30 ms more (the queue's fill), one call
    later in the chain 60 ms more (a stall of the host), every call 5 ms:
    the median of the gaps after the first keeps the 5 ms."""
    import time

    calls = []

    def fn():
        calls.append(len(calls))
        time.sleep({0: 0.035, 3: 0.065}.get(calls[-1], 0.005))

    ms = chained_ms(fn, torch.device("cpu"), 6)
    assert len(calls) == 6
    assert 4.5 <= ms < 25.0
    with pytest.raises(ValueError, match="at least 3 calls"):
        chained_ms(fn, torch.device("cpu"), 2)


def test_synchronize_waits_for_nothing_on_the_cpu():
    synchronize("cpu")
    synchronize(torch.device("cpu"))
    assert benchmark_fn(lambda: 1, warmup=0, iters=1, device="cpu")[1] == 1


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "t")) as prof:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    files = os.listdir(tmp_path / "t")
    assert len(files) == 1 and files[0].endswith(".json")
    assert "traceEvents" in json.loads((tmp_path / "t" / files[0]).read_text())
    assert any("mm" in e.key for e in prof.key_averages())
