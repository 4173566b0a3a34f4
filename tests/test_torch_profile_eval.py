"""The port's eval-forward profilers against the JAX scripts they stand for:
`python -m ganet_tpu_torch.profile_breakdown`, `.profile_agg`,
`.profile_head` and `.bench_conv3d` against `scripts/profile_breakdown.py`,
`profile_agg.py`, `profile_head.py` and `bench_conv3d.py`: their flags and
defaults, their stage names (read from the scripts' source), a small run
of each on the CPU, the stage loop's failure rule, and the arithmetic of
the stages against the JAX functions they copy.

The JAX scripts are not run: their parsers are captured as `main` calls
`parse_args`, and their stage names are read from their source.  The
convolution strategies are held against `conv3d_via_2d`, `conv3d_dsplit`
and `lax.conv_general_dilated` at rtol = atol = 1e-4 (XLA-CPU float32
sums carry about 20x PyTorch's error); the head's stages against the same
composition of the JAX package's ops at 1e-5, its LGA through
`dispatch.lga(impl="pallas")` in interpret mode."""

from __future__ import annotations

import ast
import io
import json
import math
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from ganet_tpu.models.layers import conv3d_dsplit, conv3d_via_2d
from ganet_tpu.ops import dispatch as jdispatch
from ganet_tpu.ops.disparity import disparity_regression as j_regression
from ganet_tpu.ops.disparity import trilinear_upsample as j_upsample
from ganet_tpu.ops.normalize import l1_normalize as j_l1_normalize
from ganet_tpu.ops.normalize import normalize_weights as j_normalize_weights
from ganet_tpu_torch import bench_conv3d, profile_agg, profile_breakdown, profile_head
from ganet_tpu_torch.parallel.spatial import halo_conv_same
from ganet_tpu_torch.utils.profiling import run_stages
from tests.test_torch_train_bench import _jax_parser
from tests.torch_parity import two_torch_threads  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORTS = {"profile_breakdown": profile_breakdown, "profile_agg": profile_agg,
         "profile_head": profile_head, "bench_conv3d": bench_conv3d}
SMALL = ["--height", "48", "--width", "96", "--max_disp", "24", "--device", "cpu"]
ROWS = {"bench_conv3d": 30, "profile_head": 16, "profile_breakdown": 10, "profile_agg": 16}
# Small cases for bench_conv3d's CPU run: the module's names, its strides.
SMALL_CASES = tuple((name, (1, 8 - 2 * i, 6, 8, 10), 4 + i, stride)
                    for i, (name, _, _, stride) in enumerate(bench_conv3d.CASES))
SMALL_DECONVS = tuple((name, (1, 6, 3, 4, 5), 4) for name, _, _ in bench_conv3d.DECONVS)


def _source(name):
    return ast.parse((ROOT / "scripts" / f"{name}.py").read_text())


def _stages_keys(name) -> list:
    """The constant keys of every `stages["..."] = ...`, in source order."""
    keys = []
    for node in ast.walk(_source(name)):
        if isinstance(node, ast.Assign):
            t = node.targets[0]
            if (isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
                    and t.value.id == "stages" and isinstance(t.slice, ast.Constant)):
                keys.append((node.lineno, t.slice.value))
    return [k for _, k in sorted(keys)]


def _conv3d_script() -> dict:
    """bench_conv3d.py's cases (name, NDHWC shape, Cout, stride), its
    deconvolutions (name, shape, Cout) and its `bench` calls (the
    f-string's variable, its suffix, whether under `if stride == 1`), in
    source order."""
    tree = _source("bench_conv3d")
    consts = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            try:
                consts[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                pass
    out = {"cases": [], "deconvs": [], "calls": []}

    def value(node):
        return consts[node.id] if isinstance(node, ast.Name) else ast.literal_eval(node)

    def visit(node, stride1):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "append"
                and getattr(node.func.value, "id", "") == "cases"):
            out["cases"].append((node.lineno, tuple(value(e) for e in node.args[0].elts)))
        if (isinstance(node, ast.For) and isinstance(node.target, ast.Tuple)
                and node.target.elts[0].id == "dname"):
            out["deconvs"] = [ast.literal_eval(e) for e in node.iter.elts]
        if (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "bench"
                and isinstance(node.args[0], ast.JoinedStr)):
            var, suffix = node.args[0].values
            out["calls"].append((node.lineno, var.value.id, suffix.value, stride1))
        if isinstance(node, ast.If):
            test = ast.unparse(node.test)
            for child in node.body:
                visit(child, stride1 or test == "stride == 1")
            for child in node.orelse:
                visit(child, stride1)
            return
        for child in ast.iter_child_nodes(node):
            visit(child, stride1)

    visit(tree, False)
    out["cases"] = [c for _, c in sorted(out["cases"])]
    out["calls"] = [c[1:] for c in sorted(out["calls"])]
    return out


def _jax_names(name) -> list:
    """Every row name the JAX script prints at its defaults, in order."""
    if name != "bench_conv3d":
        return _stages_keys(name)
    script = _conv3d_script()
    names = []
    for cname, _, _, stride in script["cases"]:
        names += [f"{cname}{s}" for var, s, s1 in script["calls"]
                  if var == "cname" and (stride == 1 or not s1)]
    for dname, _, _ in script["deconvs"]:
        names += [f"{dname}{s}" for var, s, _ in script["calls"] if var == "dname"]
    return names


def _port_names(name) -> list:
    if name == "bench_conv3d":
        names = [f"{c}/{n}" for c, _, _, s in bench_conv3d.CASES for n in bench_conv3d.strategies(s)]
        return names + [f"{d}/{n}" for d, _, _ in bench_conv3d.DECONVS for n in ("convtranspose", "subpixel8")]
    module = PORTS[name]
    return list(module.build_stages(module.parse_args(SMALL), torch.device("cpu")))


# ---------------------------------------------------------------------------
# flags, names, and no card
# ---------------------------------------------------------------------------

OTHER_ARGV = {
    "profile_breakdown": ["--height", "96", "--width", "192", "--max_disp", "48", "--dtype",
                          "float32", "--head_dtype", "float32", "--batch", "2", "--only", "a,b",
                          "--trace", "x"],
    "profile_agg": ["--height", "96", "--width", "192", "--max_disp", "48", "--dtype", "float32",
                    "--impl", "scan", "--only", "sga"],
    "profile_head": ["--height", "96", "--width", "192", "--max_disp", "48", "--batch", "2",
                     "--only", "lga,softmax"],
    "bench_conv3d": ["--dtype", "float32", "--only", "dsplit"],
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
def test_stage_names_equal_the_jax_scripts(name):
    names = _jax_names(name)
    assert len(names) == ROWS[name]
    assert _port_names(name) == names


def test_bench_conv3d_shapes_equal_the_jax_script():
    script = _conv3d_script()
    ncdhw = lambda s: (s[0], s[4], s[1], s[2], s[3])  # noqa: E731
    assert [(n, ncdhw(s), c, st) for n, s, c, st in script["cases"]] == list(bench_conv3d.CASES)
    assert [(n, ncdhw(s), c) for n, s, c in script["deconvs"]] == list(bench_conv3d.DECONVS)


@pytest.mark.parametrize("name", sorted(PORTS))
def test_each_module_raises_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so the module uses it")
    with pytest.raises(RuntimeError, match="CUDA"):
        PORTS[name].main([])


# ---------------------------------------------------------------------------
# small runs on the CPU
# ---------------------------------------------------------------------------

WIDTHS = {"profile_breakdown": (42, 9), "profile_agg": (44, 9), "profile_head": (36, 9),
          "bench_conv3d": (36, 8)}


def _small_run(name, argv, monkeypatch, capsys):
    if name == "bench_conv3d":
        monkeypatch.setattr(bench_conv3d, "CASES", SMALL_CASES)
        monkeypatch.setattr(bench_conv3d, "DECONVS", SMALL_DECONVS)
        argv = ["--device", "cpu"] + argv
    else:
        argv = SMALL + argv
    rows = PORTS[name].main(argv)
    return rows, capsys.readouterr()


@pytest.mark.parametrize("name", sorted(PORTS))
def test_every_stage_prints_one_finite_row_on_the_cpu(name, monkeypatch, capsys):
    rows, printed = _small_run(name, [], monkeypatch, capsys)
    assert list(rows) == _jax_names(name)
    width, ms_width = WIDTHS[name]
    lines = [line for line in printed.out.splitlines() if line.endswith(" ms")]
    assert lines == [f"{n:{width}s} {ms:{ms_width}.2f} ms" for n, ms in rows.items()]
    assert all(math.isfinite(ms) and ms > 0 for ms in rows.values())
    if name == "bench_conv3d":
        headers = [line for line in printed.out.splitlines() if line.startswith("---")]
        assert [h.split()[1] for h in headers] == [c[0] for c in SMALL_CASES]
        assert len(re.findall(r"TFLOP/s$", printed.out, re.M)) == 3 * 7 + 5
        assert len(re.findall(r"dsplit check max \|diff\| \S+ .* ok$", printed.err, re.M)) == 3


def test_only_filters_by_substrings(monkeypatch, capsys):
    rows, printed = _small_run("profile_head", ["--only", "softmax,upsample_f32"], monkeypatch, capsys)
    assert list(rows) == ["upsample_f32", "softmax_f32", "softmax_bf16io"]
    assert [line.split()[0] for line in printed.out.splitlines()] == list(rows)
    rows, _ = _small_run("bench_conv3d", ["--only", "dsplit_bf16"], monkeypatch, capsys)
    assert list(rows) == [f"{c[0]}/dsplit_bf16" for c in SMALL_CASES[:3]]


def test_trace_writes_a_chrome_trace_per_stage(tmp_path, capsys):
    rows = profile_breakdown.main(SMALL + ["--only", "disp_head,cost_volume", "--trace", str(tmp_path)])
    assert list(rows) == ["disp_head(upsample+softmax+reg)", "cost_volume"]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["cost_volume", "disp_head_upsample+softmax+reg"]
    for d in tmp_path.iterdir():
        (trace,) = d.iterdir()
        assert trace.name.startswith("trace-") and json.loads(trace.read_text())["traceEvents"]


def test_only_out_of_memory_becomes_a_failed_row(capsys):
    calls = []

    def ok(tag):
        return lambda: calls.append(tag)

    def oom():
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 9 GiB")

    out = io.StringIO()
    rows = run_stages({"a": ok("a"), "b_oom": oom, "c": ok("c")}, [], torch.device("cpu"), 8, out)
    assert list(rows) == ["a", "b_oom", "c"] and math.isnan(rows["b_oom"])
    lines = out.getvalue().splitlines()
    assert lines[1] == "b_oom    FAILED: OutOfMemoryError: CUDA out of memory. Tried to allocate 9 GiB"
    assert calls == ["a"] * 7 + ["c"] * 7  # a warm-up call and a chain of 6 each

    def broken():
        raise RuntimeError("the kernel failed to launch")

    out = io.StringIO()
    with pytest.raises(RuntimeError, match="failed to launch"):
        run_stages({"a": ok("a"), "b": broken, "c": ok("c")}, [], torch.device("cpu"), 8, out)
    assert [line.split()[0] for line in out.getvalue().splitlines()] == ["a"]


def test_a_module_turns_only_out_of_memory_into_rows(monkeypatch, capsys):
    def oom(p, D):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB")

    monkeypatch.setattr(profile_head, "fused_reg", oom)
    rows, printed = _small_run("profile_head", ["--only", "renorm"], monkeypatch, capsys)
    assert list(rows) == ["renorm_reg_f32(current)", "renorm_reg_fused", "renorm_reg_fused_bf16in"]
    assert rows["renorm_reg_f32(current)"] > 0
    assert math.isnan(rows["renorm_reg_fused"]) and math.isnan(rows["renorm_reg_fused_bf16in"])
    assert printed.out.count("FAILED: OutOfMemoryError: CUDA out of memory") == 2

    def broken(p, D):
        raise RuntimeError("the kernel failed to launch")

    monkeypatch.setattr(profile_head, "fused_reg", broken)
    with pytest.raises(RuntimeError, match="failed to launch"):
        _small_run("profile_head", ["--only", "renorm"], monkeypatch, capsys)


def test_stages_run_without_autograd():
    seen = []
    w = torch.ones(3, requires_grad=True)
    run_stages({"s": lambda: seen.append((w * 2).requires_grad)}, [], torch.device("cpu"), 4,
               io.StringIO())
    assert seen == [False] * 7


# ---------------------------------------------------------------------------
# parity with the JAX package on the CPU
# ---------------------------------------------------------------------------


def _t(a):
    return torch.from_numpy(np.array(a))


def _conv_inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 7, 9, 10, 5)).astype(np.float32)  # NDHWC, odd D and H
    k = rng.standard_normal((3, 3, 3, 5, 6)).astype(np.float32)  # DHWIO
    return x, k, _t(x.transpose(0, 4, 1, 2, 3)), _t(k.transpose(4, 3, 0, 1, 2))


def _jax_conv(x, k, stride):
    return lax.conv_general_dilated(x, k, (stride,) * 3, "SAME",
                                    dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))


CONV_CASES = [
    ("via2d", 1, lambda x, k: bench_conv3d.via2d(x, k, 1), lambda x, k: conv3d_via_2d(x, k, 1)),
    ("via2d", 2, lambda x, k: bench_conv3d.via2d(x, k, 2), lambda x, k: conv3d_via_2d(x, k, 2)),
    ("dconcat", 1, lambda x, k: bench_conv3d.dconcat(x, k, 1), lambda x, k: _jax_conv(x, k, 1)),
    ("dconcat", 2, lambda x, k: bench_conv3d.dconcat(x, k, 2), lambda x, k: _jax_conv(x, k, 2)),
    ("dsplit", 1, bench_conv3d.dsplit, conv3d_dsplit),
    ("native3d", 1, lambda x, k: halo_conv_same(x, k, stride=1), lambda x, k: _jax_conv(x, k, 1)),
    ("native3d", 2, lambda x, k: halo_conv_same(x, k, stride=2), lambda x, k: _jax_conv(x, k, 2)),
]


@pytest.mark.parametrize("case", CONV_CASES, ids=[f"{c[0]}-s{c[1]}" for c in CONV_CASES])
def test_conv_strategies_equal_jax(case):
    _, _, port, ref = case
    x, k, xt, kt = _conv_inputs()
    got = port(xt, kt).permute(0, 2, 3, 4, 1).numpy()
    want = np.asarray(ref(jnp.asarray(x), jnp.asarray(k)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_bf16_strategies_sum_in_bf16():
    x, k, xt, kt = _conv_inputs(1)
    ref = np.asarray(_jax_conv(jnp.asarray(x), jnp.asarray(k), 1)).transpose(0, 4, 1, 2, 3)
    scale = np.abs(ref).max()
    for got in (bench_conv3d.via2d(xt, kt, 1, torch.bfloat16), bench_conv3d.dconcat(xt, kt, 1, torch.bfloat16),
                bench_conv3d.dsplit(xt, kt, torch.bfloat16)):
        assert got.dtype == torch.bfloat16
        # Three bf16 roundings of sums of magnitude up to max|ref|.
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=3 * 2.0**-8 * scale)


def _jax_subpixel(x, k4):
    """The JAX script's `subpixel_deconv` (scripts/bench_conv3d.py), transcribed."""
    B, D, H, W, Cin = x.shape
    outs = {}
    for a in (0, 1):
        for b in (0, 1):
            for c in (0, 1):
                kk = k4[a::2, b::2, c::2]
                o = None
                for dz in range(2):
                    xs = jnp.pad(x, ((0, 0), (1, 0), (1, 0), (1, 0), (0, 0)))[:, dz : dz + D, :, :, :]
                    xs2 = xs.reshape(B * D, H + 1, W + 1, Cin)
                    oo = lax.conv_general_dilated(
                        xs2, kk[dz], (1, 1), "VALID", dimension_numbers=("NHWC", "HWIO", "NHWC"),
                        preferred_element_type=jnp.float32)
                    o = oo if o is None else o + oo
                outs[(a, b, c)] = o.reshape(B, D, H, W, -1)
    z = jnp.stack([outs[(a, b, c)] for a in (0, 1) for b in (0, 1) for c in (0, 1)], axis=-2)
    z = z.reshape(B, D, H, W, 2, 2, 2, -1)
    z = jnp.transpose(z, (0, 1, 4, 2, 5, 3, 6, 7))
    return z.reshape(B, 2 * D, 2 * H, 2 * W, -1)


def test_subpixel8_copies_the_jax_arithmetic():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 4, 6, 8, 3)).astype(np.float32)
    k4 = rng.standard_normal((4, 4, 4, 3, 5)).astype(np.float32)
    got = bench_conv3d.subpixel8(_t(x.transpose(0, 4, 1, 2, 3)), _t(k4.transpose(4, 3, 0, 1, 2)))
    want = np.asarray(_jax_subpixel(jnp.asarray(x), jnp.asarray(k4)))
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), want, rtol=1e-4, atol=1e-4)


def test_dsplit_check_passes():
    assert bench_conv3d.dsplit_check(torch.device("cpu")) < 2e-4


def _head_inputs(seed=3):
    rng = np.random.default_rng(seed)
    D, H, W = 12, 12, 24
    x_low = rng.standard_normal((1, D // 3, H // 3, W // 3)).astype(np.float32)
    l1 = rng.uniform(size=(1, H, W, 75)).astype(np.float32)
    l2 = rng.uniform(size=(1, H, W, 75)).astype(np.float32)
    p = np.asarray(jax.nn.softmax(-rng.standard_normal((1, D, H, W)).astype(np.float32), axis=1))
    return (D, H, W), x_low, l1, l2, p


def _nchw(g):
    return _t(g.transpose(0, 3, 1, 2))


def test_renorm_and_regression_variants_equal_jax():
    (D, _, _), _, _, _, p = _head_inputs()
    jp = jnp.asarray(p)
    renorm = j_regression(jp / jnp.maximum(jnp.sum(jnp.abs(jp), axis=1, keepdims=True), 1e-6), D)
    d = jnp.arange(D, dtype=jnp.float32).reshape(1, D, 1, 1)
    fused = jnp.sum(jp * d, axis=1) / jnp.maximum(jnp.sum(jnp.abs(jp), axis=1), 1e-6)
    pb = jp.astype(jnp.bfloat16).astype(jnp.float32)
    fused_bf16 = jnp.sum(pb * d, axis=1) / jnp.maximum(jnp.sum(jnp.abs(pb), axis=1), 1e-6)
    tp = _t(p)
    for got, want in ((profile_head.renorm_reg(tp, D), renorm), (profile_head.fused_reg(tp, D), fused),
                      (profile_head.fused_reg(tp.to(torch.bfloat16).float(), D), fused_bf16)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_guidance_prep_equals_jax():
    rng = np.random.default_rng(4)
    g = rng.standard_normal((1, 5, 7, 640)).astype(np.float32)  # (B, H, W, 4*5*32)
    k = j_normalize_weights(jnp.moveaxis(jnp.asarray(g).reshape(1, 5, 7, 4, 5, 32), -1, 3), "l1", axis=-1)
    got = profile_agg.guidance_prep(_nchw(g))  # (B, C, 4, 5, H, W)
    np.testing.assert_allclose(got.permute(0, 4, 5, 1, 2, 3).numpy(), np.asarray(k), rtol=1e-5, atol=1e-5)


def test_head_after_conv_equals_jax():
    shape, x_low, l1, l2, _ = _head_inputs()
    D = shape[0]

    @jax.jit  # one compile of the interpreted kernels, not one an op
    def head(x, l1, l2):
        x = j_upsample(x, shape)
        g1, g2 = j_l1_normalize(l1, axis=-1), j_l1_normalize(l2, axis=-1)
        x = jdispatch.lga(x, g1, radius=2, repeats=2, impl="pallas")
        p = jax.nn.softmax(-x, axis=1)
        p = jdispatch.lga(p, g2, radius=2, repeats=2, impl="pallas")
        return j_regression(p / jnp.maximum(jnp.sum(jnp.abs(p), axis=1, keepdims=True), 1e-6), D)

    want = head(jnp.asarray(x_low), jnp.asarray(l1), jnp.asarray(l2))
    got = profile_head.head_f32(_t(x_low), _nchw(l1), _nchw(l2), shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    # The bf16 head runs and stays near the f32 one.
    got_bf16 = profile_head.head_bf16(_t(x_low), _nchw(l1), _nchw(l2), shape)
    assert got_bf16.shape == got.shape and torch.isfinite(got_bf16).all()
