"""Structured metric logging: a copy of `MetricLogger` in
`ganet_tpu/utils/logging.py`.

Each row is printed as one stdout line, `[prefix] step=... time=... k=v`,
and appended as one JSON object, `{"prefix", "step", "time", ...}`, to
`<log_dir>/<name>.jsonl`, so that runs can be compared and plotted."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricLogger:
    def __init__(self, log_dir: Optional[str] = None, name: str = "train"):
        self._fh = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._fh = open(os.path.join(log_dir, f"{name}.jsonl"), "a")
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, float], prefix: str = ""):
        payload = {
            "step": step,
            "time": round(time.time() - self._t0, 3),
            **{k: float(v) for k, v in metrics.items()},
        }
        line = " ".join(
            f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in payload.items()
        )
        print(f"[{prefix or 'train'}] {line}", flush=True)
        if self._fh:
            self._fh.write(json.dumps({"prefix": prefix, **payload}) + "\n")
            self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
