"""Build and load the port's CUDA kernels.

Each source `ganet_tpu_torch/csrc/<name>.cu` has a plain C interface and is
compiled by `nvcc` for `sm_90a` into its own shared library under
`build/kernels/` at the root of the checkout, then loaded with `ctypes`.
The library's file name carries a hash of the source and of the headers of
`csrc/` it includes, so an edited source or header is rebuilt and an
unchanged one is reused.  `build_all` starts one `nvcc`
per source at once; nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = (
    "sga_fwd", "lga_fwd", "sga_bwd", "lga_bwd", "sga_fwd_seeded", "sga_bwd_seeded", "lga3d_fwd",
)

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.MULTILINE)


def _sources(name: str) -> list:
    """`<name>.cu` and the files of `csrc/` it includes with `#include "..."`,
    recursively, each once, in the order they are first included."""
    found: list = []

    def visit(path: Path) -> None:
        if path in found or not path.is_file():
            return
        found.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            visit(CSRC / inc.decode())

    visit(CSRC / f"{name}.cu")
    return found


def source_digest(paths: Iterable[Path], flags: Iterable[str] = ()) -> str:
    """12 hex digits of the SHA-256 of the files' bytes, in order, then of
    the build flags: the tag that names a library built from them."""
    digest = hashlib.sha256()
    for path in paths:
        digest.update(path.read_bytes())
    for flag in flags:
        digest.update(flag.encode())
    return digest.hexdigest()[:12]


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{source_digest(_sources(name))}.so"


def _start(name: str):
    """Start nvcc for one source; returns (process, output path) or None
    when the library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, started) -> str:
    proc, tmp, out = started
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)
    return log


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Build every listed kernel library in parallel; returns each build's
    nvcc output (kept beside the library when it was built earlier)."""
    names = list(names)
    with _lock:
        started = {n: _start(n) for n in names}
        logs = {}
        for n, s in started.items():
            if s:
                logs[n] = _finish(n, s)
            else:
                log = _lib_path(n).with_suffix(".log")
                logs[n] = log.read_text() if log.exists() else ""
        return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        started = _start(name)
        if started:
            _finish(name, started)
        lib = ctypes.CDLL(str(_lib_path(name)))
        _loaded[name] = lib
        return lib


def check(status: int, what: str) -> None:
    """Raise if a kernel's C entry returned a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
