"""Timing helpers (counterpart of `ganet_tpu/utils/profiling.py`).

On a CUDA device a call is timed by CUDA events recorded around it and read
after a synchronise, so the time is the device's, not the enqueue's; on the
CPU by the host clock.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

import torch


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
