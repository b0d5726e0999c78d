"""The benchmark's driver: one cell, one run, one result line.

BENCHMARK.json names every cell (`workloads`), its configuration
(`configs`, whose `file` is benchmark/configs/<config>.json), its traffic
mix (benchmark/traffic/<traffic>.json) and the metrics. The configuration
file names the entry (benchmark/entries/<entry>.py) that drives the
program for it and the plain reference its outputs are compared with
(benchmark/reference/). Each per-layer metric is read from the traced run
by benchmark/metrics/<metric>.py. So a later cell, mix or metric is a new
file and a new entry in BENCHMARK.json; no file here changes.

The run: check for the card, let the entry set up (weights from the seed,
the kernel build through the program's own cache under build/, the
warm-up), measure for --seconds, check the outputs against the reference,
then make sure no JAX module was loaded, and print
    {"correct", "attempted", "failed", "metrics", "device"[, "breakdown"],
     "checks"}
as the last line of standard output, each compared number beside its
limit under "checks" and again as the last lines of standard error.
With --trace 0 the metrics are the cell's end-to-end ones, with --trace 1
its per-layer ones.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import traceback
from typing import Any

from benchmark import guard

HERE = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Check:
    """One number compared with the reference, beside its limit; the
    number passes where it is at most the limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return not math.isnan(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Run:
    """What an entry gets: the cell's configuration and mix as read from
    their files, and the run's arguments."""

    config: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    start: float


@dataclasses.dataclass
class Outcome:
    """What an entry returns. `end_to_end` holds every end-to-end metric
    the entry measures, by name; `layer` is what the per-layer readers
    read (trace runs only); `busy_s`, `window_s` and `breakdown` come from
    the profiled slice."""

    attempted: int
    failed: int
    end_to_end: dict
    checks: list
    memory_peak_bytes: int
    layer: Any = None
    busy_s: float | None = None
    window_s: float | None = None
    breakdown: dict | None = None


def load_spec(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_json(root: str, *parts: str) -> dict:
    with open(os.path.join(root, *parts)) as f:
        return json.load(f)


def load_cell(root: str, name: str):
    """-> (spec, cell, configuration file, mix file) for cell `name`."""
    spec = load_spec(root)
    cell = find(spec["workloads"], name, "workload")
    conf = find(spec["configs"], cell["config"], "config")
    config = load_json(root, conf["file"])
    mix = load_json(root, "benchmark", "traffic", cell["traffic"] + ".json")
    return spec, cell, config, mix


def cell_metrics(spec: dict, cell: str, trace: bool) -> list:
    """The metrics a run of `cell` reports: its end-to-end ones (those
    listing no cells are every cell's), or with trace the per-layer ones
    that list it; every per-layer metric lists its cells."""
    if trace:
        return [m for m in spec["per_layer"] if cell in m["workloads"]]
    return [m for m in spec["end_to_end"]
            if cell in m.get("workloads", [cell])]


def load_reader(name: str):
    """benchmark/metrics/<name>.py, loaded from its path (the name holds a
    dot)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def run_cell(root: str, name: str, seed: int, seconds: float, trace: bool,
             device, start: float):
    """Drives one run of cell `name` on `device` -> (metrics list,
    Outcome). The card check is the caller's."""
    spec, _, config, mix = load_cell(root, name)
    entry = importlib.import_module("benchmark.entries." + config["entry"])
    run = Run(config, mix, seed, seconds, trace, device, start)
    return cell_metrics(spec, name, trace), entry.run(run)


def result_line(metrics: list, out: Outcome, device: dict) -> dict:
    """The contract's line; "checks" comes last."""
    values = {}
    for m in metrics:
        name = m["name"]
        if "layer" in m:
            v = load_reader(name)(out.layer)
            if v is None:
                continue
        else:
            v = out.end_to_end[name]
        values[name] = {"value": float(v), "unit": m["unit"]}
    checks = all(c.ok for c in out.checks)
    line = {"correct": bool(out.checks) and checks,
            "attempted": out.attempted, "failed": out.failed,
            "metrics": values, "device": device}
    if out.breakdown is not None:
        line["breakdown"] = out.breakdown
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in out.checks}
    return line


def main(argv, start: float, root: str) -> int:
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    _, cell, _, _ = load_cell(root, args.workload)
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"error: cell {args.workload} needs {chips} CUDA device(s); "
            f"torch.cuda.is_available()={torch.cuda.is_available()}, "
            f"device_count={torch.cuda.device_count()}")
        return 2
    try:
        with contextlib.redirect_stdout(sys.stderr):
            metrics, out = run_cell(root, args.workload, args.seed,
                                    args.seconds, bool(args.trace),
                                    torch.device("cuda", 0), start)
            device = {"platform": "gpu",
                      "kind": torch.cuda.get_device_name(0),
                      "count": chips,
                      "memory_peak_bytes": int(out.memory_peak_bytes)}
            if args.trace:
                device["busy_s"] = out.busy_s
                device["window_s"] = out.window_s
            line = result_line(metrics, out, device)
    except Exception:  # the run failed: no result line
        traceback.print_exc()
        return 1
    log(f"card: {power_limit()}; torch {torch.__version__} CUDA "
        f"{torch.version.cuda}; peaks: bf16 989 TF/s, int8 1979 TOP/s, "
        f"fp32 67 TF/s, HBM 3.35 TB/s (H100 SXM at 700 W)")
    found = guard.loaded_jax_modules()
    if found:
        log(f"error: JAX modules were loaded in this process: {found}")
        return 3
    for c in out.checks:
        log(f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
            f"{'ok' if c.ok else 'FAILED'}")
    print(json.dumps(line), flush=True)
    return 0
