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
from typing import Callable

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


# The wrappers whose launches `recording_shapes` records: (count name, the
# wrapper's name in ops/sga.py or ops/lga.py, and the index of its radius
# argument, for the LGA kernels).
RECORDED = (("sga_fwd", "sga_sweep_kernel", None), ("lga_fwd", "lga_kernel", 2),
            ("sga_bwd", "sga_sweep_bwd_kernel", None), ("lga_bwd", "lga_bwd_kernel", 3))


@contextlib.contextmanager
def recording_shapes(seen):
    """Count in `seen` (a Counter) every K1, K2, K3 and K4 launch in the
    body by kernel, volume shape, dtype (and the LGA kernels' radius).  Each
    wrapper counts its launches on its module's name, which the recorders
    hold meanwhile; the counts go back to the wrappers after."""
    swapped = []
    for name, attr, radius_at in RECORDED:
        module = _lga if attr.startswith("lga") else _sga
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
