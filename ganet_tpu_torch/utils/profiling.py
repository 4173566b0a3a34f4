"""Timing helpers (counterpart of `ganet_tpu/utils/profiling.py`), and a
recorder of the shapes the kernels are launched at.

On a CUDA device a call is timed by CUDA events recorded around it and read
after a synchronise, so the time is the device's, not the enqueue's; on the
CPU by the host clock.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Callable, Dict

import torch

from ganet_tpu_torch.ops import lga as _lga
from ganet_tpu_torch.ops import sga as _sga


def median_ms(fn: Callable[[], object], iters: int, device: torch.device) -> float:
    """The median time of `iters` calls of `fn`, in ms."""
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def probe_ms(device: torch.device, repeats: int = 3) -> float:
    """Time of a pinned fixed-shape chain on the card, in ms: 128 bf16
    2048x2048 matrix products, each renormalised to keep the carry finite
    (about 2.2 TFLOP), the median of `repeats` chains after a warm-up.

    The counterpart of `drift_probe_ms`: a constant-work run beside a
    benchmark, so that when two runs disagree on the model but agree on the
    probe the model changed, and when both moved the card's state did.
    Raises on a CPU device (the chain would take minutes there)."""
    if device.type != "cuda":
        raise ValueError(f"the probe times a CUDA device, got {device}")
    a = torch.full((2048, 2048), 0.5, dtype=torch.bfloat16, device=device)

    def chain():
        y = a
        for _ in range(128):
            out = torch.matmul(y, y).float()
            y = (out / out.abs().amax().clamp(min=1.0)).to(torch.bfloat16)
        return y

    chain()
    return median_ms(chain, repeats, device)


# Every kernel wrapper of ops/sga.py and ops/lga.py: (the name its
# launches are counted under, the wrapper's name in its module).
KERNELS = (("sga_fwd", "sga_sweep_kernel"), ("lga_fwd", "lga_kernel"),
           ("sga_bwd", "sga_sweep_bwd_kernel"), ("lga_bwd", "lga_bwd_kernel"),
           ("sga_fwd_seeded", "sga_sweep_seeded_kernel"),
           ("sga_bwd_seeded", "sga_sweep_bwd_seeded_kernel"), ("lga3d_fwd", "lga3d_kernel"))
# The kernels whose launches `recording_shapes` records, by count name,
# with the index of the wrapper's radius argument (the LGA kernels).  K5,
# the seeded sweep of the sharded SGA wavefront, is recorded by the whole
# block it sweeps a window of.
RECORDED = {"sga_fwd": None, "lga_fwd": 2, "sga_bwd": None, "lga_bwd": 3, "sga_fwd_seeded": None}


def _module(attr: str):
    return _lga if attr.startswith("lga") else _sga


def kernel_wrappers() -> Dict[str, Callable]:
    """{count name: wrapper} of every kernel, looked up now:
    `recording_shapes` stands in for some of them while it records."""
    return {name: getattr(_module(attr), attr) for name, attr in KERNELS}


def reset_launches() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_launches() -> Dict[str, int]:
    """{count name: launches} of every kernel since the last reset."""
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


@contextlib.contextmanager
def recording_shapes(seen):
    """Count in `seen` (a Counter) every launch of the kernels in
    `RECORDED` (K1, K2, K3, K4 and K5) in the body by kernel, volume shape,
    dtype (and the LGA kernels' radius).  Each wrapper counts its launches
    on its module's name, which the recorders hold meanwhile; the counts go
    back to the wrappers after."""
    swapped = []
    for name, attr in KERNELS:
        if name not in RECORDED:
            continue
        module, radius_at = _module(attr), RECORDED[name]
        fn = getattr(module, attr)

        def rec(x, *args, fn=fn, name=name, radius_at=radius_at, **kw):
            radius = () if radius_at is None else (args[radius_at - 1],)
            seen[(name, tuple(x.shape), x.dtype) + radius] += 1
            return fn(x, *args, **kw)

        rec.launches = fn.launches
        setattr(module, attr, rec)
        swapped.append((module, attr, fn, rec))
    try:
        yield
    finally:
        for module, attr, fn, rec in swapped:
            fn.launches = rec.launches
            setattr(module, attr, fn)
