"""The port stands apart from the JAX package and runs on the GPU unless
asked for the CPU."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "ganet_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "orbax", "ganet_tpu"}


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots = [node.module.split(".")[0]]
        else:
            continue
        assert not FORBIDDEN & set(roots), f"{path}:{node.lineno} imports {roots}"


def test_imports_with_jax_and_reference_blocked():
    code = textwrap.dedent(
        """
        import importlib, importlib.util, pkgutil, sys
        for name in ("jax", "jaxlib", "flax", "orbax", "ganet_tpu"):
            sys.modules[name] = None
        import ganet_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(ganet_tpu_torch.__path__, "ganet_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        print(len(names))
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 42  # every module of the package was imported


def test_build_model_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present, so build_model() uses it")
    from ganet_tpu_torch import build_model, ganet_small

    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(ganet_small(24))


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, where):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    else:
        cwd = ROOT
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=_env(),
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
