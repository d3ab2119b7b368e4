"""Metrics logging: JSONL always, TensorBoard when ``torch.utils.tensorboard``
imports (counterpart of ``mipnerf360_tpu/utils/logging.py``). Under a
process group only global rank 0 writes; the other ranks' loggers do
nothing."""
from __future__ import annotations

import json
import os
import time
from typing import Dict

from ..parallel.mesh import is_primary


class MetricsLogger:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.primary = is_primary()
        self._jsonl = self._tb = None
        if not self.primary:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._tb = SummaryWriter(os.path.join(log_dir, "tb"), flush_secs=10)
        except ImportError:
            self._tb = None

    def log(self, step: int, scalars: Dict[str, float]):
        if not self.primary:
            return
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), global_step=step)

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class Timer:
    """Wall-clock timer for steps/s and rays/s counters."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def lap(self) -> float:
        now = time.perf_counter()
        dt = now - self.t0
        self.t0 = now
        return dt
