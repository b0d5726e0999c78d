"""Structured metrics logging — port of multipathnet_tpu/utils/metrics.py
(SURVEY.md §5 "Metrics / logging").

JSONL rows (one per log step) with step, walltime, lr, per-head losses,
imgs/sec — machine-readable and greppable — echoed to stdout. The
reference's TensorBoard export (utils/tbevents.py) is not ported yet
(ROADMAP A12d): tensorboard_dir raises.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = True,
                 tensorboard_dir: Optional[str] = None):
        if tensorboard_dir:
            raise NotImplementedError(
                "TensorBoard export waits for the port of utils/tbevents.py "
                "(ROADMAP A12d)")
        self.path = path
        self.echo = echo
        self._f = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, step: int, **metrics) -> None:
        row = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                row[k] = round(float(v), 6)
            except (TypeError, ValueError):
                row[k] = v
        if self._f:
            self._f.write(json.dumps(row) + "\n")
        if self.echo:
            parts = " ".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in row.items() if k != "time"
            )
            print(f"[{row['time']:8.1f}s] {parts}", flush=True)

    def close(self) -> None:
        if self._f:
            self._f.close()
