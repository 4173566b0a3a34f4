"""ctypes bindings of the native C++ decode core (`csrc/ganet_io.cpp`), the
counterpart of `ganet_tpu/data/native_io.py`.

PFM/PNG decode, crop and normalisation run in native code, one sample or a
batch on a C++ thread pool, writing straight into numpy buffers.  The
samples are those of the Python readers (`data/png.py`, `data/pfm.py` and
`dataset.normalize_image`), bit for bit.

The library is built on first use with g++ (libpng, zlib) into
`build/native/libganet_io-<hash>.so` at the root of the checkout, the hash
covering the source and the compiler's flags (`ops/_build.source_digest`).
g++ writes to a temporary name that `os.replace` moves into place, under a
lock file, so that processes that start at once (the ranks of a mesh, test
workers) build it once and each loads a whole library; a process loads it
once.  Without g++ or libpng `native_available()` is False,
`why_unavailable()` says why, and the dataset reads with the Python readers.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from ganet_tpu_torch.ops._build import source_digest

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "ganet_io.cpp"
BUILD_DIR = _PKG.parent / "build/native"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")
LINK_FLAGS = ("-lpng", "-lz", "-lpthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_why: Optional[str] = None
_build_seconds: Optional[float] = None


def library_path() -> Path:
    """Where the library of this source and these flags is built."""
    tag = source_digest([SOURCE], CXX_FLAGS + LINK_FLAGS)
    return BUILD_DIR / f"libganet_io-{tag}.so"


def _compile(out: Path) -> None:
    """g++ the source into `out` through a temporary file; raises
    RuntimeError with the reason when it cannot."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH")
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [gxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LINK_FLAGS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (subprocess.SubprocessError, OSError) as e:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ did not run: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        err = " | ".join(proc.stderr.strip().splitlines()[-3:])
        raise RuntimeError(f"g++ failed with code {proc.returncode}: {err}")
    os.replace(tmp, out)


def _build() -> Path:
    """The built library's path, compiled first unless a process already
    built it; other processes wait on the lock file meanwhile."""
    global _build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not out.exists():
            t0 = time.perf_counter()
            _compile(out)
            _build_seconds = time.perf_counter() - t0
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, _why
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(_build()))
        except (RuntimeError, OSError) as e:
            _why = str(e)
            return None
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int)
        cpp = ctypes.POINTER(ctypes.c_char_p)
        lib.ganet_decode_sample.restype = ctypes.c_int
        lib.ganet_decode_sample.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, fp, fp, fp, fp, fp,
        ]
        lib.ganet_decode_batch.restype = ctypes.c_int
        lib.ganet_decode_batch.argtypes = [
            ctypes.c_int, cpp, cpp, cpp, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ip, ip, fp, fp, fp, fp, fp, ctypes.c_int,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def why_unavailable() -> Optional[str]:
    """Why the library could not be built or loaded in this process (None
    while it loads, or before the first try)."""
    return _why


def build_seconds() -> Optional[float]:
    """The seconds g++ took in this process (None if it found the library
    built, or has not tried)."""
    return _build_seconds


def _as_fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _norm():
    from ganet_tpu_torch.data.dataset import MEAN, STD  # dataset imports this module

    return np.ascontiguousarray(MEAN), np.ascontiguousarray(STD)


def decode_sample(
    left_path: str,
    right_path: str,
    disp_path: str,
    disp_is_pfm: bool,
    crop_h: int,
    crop_w: int,
    crop_y: int,
    crop_x: int,
):
    """Decode one sample; crop_y = -1 selects test-mode padding.

    Returns dict(left, right, disparity) of float32 arrays, or raises."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native io library unavailable: {_why}")
    left = np.empty((crop_h, crop_w, 3), np.float32)
    right = np.empty((crop_h, crop_w, 3), np.float32)
    disp = np.empty((crop_h, crop_w), np.float32)
    mean, std = _norm()
    rc = lib.ganet_decode_sample(
        left_path.encode(), right_path.encode(), disp_path.encode(),
        int(disp_is_pfm), crop_h, crop_w, crop_y, crop_x,
        _as_fp(mean), _as_fp(std), _as_fp(left), _as_fp(right), _as_fp(disp),
    )
    if rc != 0:
        raise IOError(f"native decode failed (code {rc}) for {left_path}")
    return {"left": left, "right": right, "disparity": disp}


def decode_batch(
    lefts: Sequence[str],
    rights: Sequence[str],
    disps: Sequence[str],
    disp_is_pfm: bool,
    crop_h: int,
    crop_w: int,
    crop_ys: Sequence[int],
    crop_xs: Sequence[int],
    num_threads: int = 0,
):
    """Decode a batch on the native thread pool.

    Returns dict(left (N,h,w,3), right, disparity (N,h,w))."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native io library unavailable: {_why}")
    n = len(lefts)
    if not len(rights) == len(disps) == len(crop_ys) == len(crop_xs) == n:
        raise ValueError(
            f"decode_batch takes one right, disparity and crop offset a left image: {n} lefts,"
            f" {len(rights)} rights, {len(disps)} disparities, {len(crop_ys)}/{len(crop_xs)} offsets"
        )
    left = np.empty((n, crop_h, crop_w, 3), np.float32)
    right = np.empty((n, crop_h, crop_w, 3), np.float32)
    disp = np.empty((n, crop_h, crop_w), np.float32)

    def enc(seq):
        return (ctypes.c_char_p * n)(*[s.encode() for s in seq])

    ys = np.asarray(crop_ys, np.int32)
    xs = np.asarray(crop_xs, np.int32)
    mean, std = _norm()
    threads = num_threads or min(n, os.cpu_count() or 1)
    rc = lib.ganet_decode_batch(
        n, enc(lefts), enc(rights), enc(disps), int(disp_is_pfm),
        crop_h, crop_w,
        ys.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        xs.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        _as_fp(mean), _as_fp(std), _as_fp(left), _as_fp(right), _as_fp(disp),
        threads,
    )
    if rc != 0:
        raise IOError(f"native batch decode failed (code {rc})")
    return {"left": left, "right": right, "disparity": disp}
