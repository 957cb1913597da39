"""Scalar logging to a JSONL stream, and wall-clock phase timers.

Counterpart of ``perf_tpu/utils/metrics.py:22-76`` without the
TensorBoard mirror (the GPU machine has no ``tensorboardX``): each scalar
is one line ``{"tag", "value", "step", "t"}`` of ``<log_dir>/metrics.jsonl``.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager


class MetricsWriter:
    def __init__(self, log_dir: str | None):
        self.log_dir = log_dir
        self._jsonl = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def add_scalar(self, tag: str, value, step: int):
        if self._jsonl:
            self._jsonl.write(json.dumps(
                {"tag": tag, "value": float(value), "step": int(step),
                 "t": time.time()}) + "\n")

    def add_scalars(self, scalars: dict, step: int):
        for tag, v in scalars.items():
            self.add_scalar(tag, v, step)

    def flush(self):
        if self._jsonl:
            self._jsonl.flush()

    def close(self):
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None


@contextmanager
def phase_timer(writer: MetricsWriter | None, tag: str, step: int = 0,
                n_items: int | None = None, item_name: str = "items"):
    """Time a phase; log ``time/<tag>_sec`` and, with ``n_items``,
    ``throughput/<tag>_<item_name>_per_sec``. The block must end in a
    device read-back (the training phases read their losses back), or the
    time is that of the launches, not of the work."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if writer is not None:
        writer.add_scalar(f"time/{tag}_sec", dt, step)
        if n_items:
            writer.add_scalar(f"throughput/{tag}_{item_name}_per_sec",
                              n_items / max(dt, 1e-9), step)
