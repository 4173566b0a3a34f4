"""Utilities of the port: metric logging, and timing on the card."""

from ganet_tpu_torch.utils.logging import MetricLogger
from ganet_tpu_torch.utils.profiling import Timer, benchmark_fn

__all__ = ["MetricLogger", "Timer", "benchmark_fn"]
