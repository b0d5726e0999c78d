"""Structured metrics logging — port of multipathnet_tpu/utils/metrics.py
(SURVEY.md §5 "Metrics / logging").

JSONL rows (one per log step) with step, walltime, lr, per-head losses,
imgs/sec — machine-readable and greppable — echoed to stdout, plus
optional TensorBoard scalar export (tensorboard_dir=...; the hand-encoded
event-file writer of utils/tbevents.py, no TensorFlow). On a mesh only
the first rank is given a path and a tensorboard_dir (cli/train.py), as
only it writes checkpoints.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional

from multipathnet_tpu_torch.utils.tbevents import EventFileWriter


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = True,
                 tensorboard_dir: Optional[str] = None):
        self.path = path
        self.echo = echo
        self._f = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a", buffering=1)
        self._tb = EventFileWriter(tensorboard_dir) if tensorboard_dir \
            else None
        self._t0 = time.time()

    def log(self, step: int, **metrics) -> None:
        row = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        scalars = {}
        for k, v in metrics.items():
            try:
                row[k] = round(float(v), 6)
                scalars[k] = float(v)
            except (TypeError, ValueError):
                row[k] = v
        if self._f:
            self._f.write(json.dumps(row) + "\n")
        if self._tb is not None and scalars:
            self._tb.add_scalars(int(step), scalars)
        if self.echo:
            parts = " ".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in row.items() if k != "time"
            )
            print(f"[{row['time']:8.1f}s] {parts}", flush=True)

    def flush(self) -> None:
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        if self._f:
            self._f.close()
        self.flush()
        if self._tb is not None:
            self._tb.close()
