"""Timing, tracing and NaN checks — port of
multipathnet_tpu/utils/profiling.py (SURVEY.md §5 "Tracing / profiling").

  - `timed(fn, *args)`: steady-state seconds per call. Launches are
    asynchronous on the card, so it synchronizes every CUDA device that
    holds an output tensor once after the warm-up and once after the
    timed calls (and nothing on the CPU, where calls are synchronous).
  - `trace(log_dir)`: a torch.profiler context that writes a Chrome trace
    TensorBoard's profiler plugin reads (`<host>.<pid>.<ns>.pt.trace.json`).
  - `debug_nans()`: raise FloatingPointError, naming the operator, on the
    first operator whose floating output holds a NaN, as jax_debug_nans
    does for the reference; the backward is checked by autograd's anomaly
    detection (its own error, a RuntimeError naming the backward function).
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# operators whose output is uninitialized memory, which may hold NaN bits
_UNINITIALIZED = frozenset({"empty", "empty_like", "empty_strided",
                            "new_empty", "new_empty_strided", "resize_",
                            "set_"})


def synchronize(out) -> None:
    """Wait for every CUDA device that holds a tensor of `out` (any nest of
    tuples, lists and dicts)."""
    devices = {x.device for x in tree_leaves(out)
               if isinstance(x, torch.Tensor) and x.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)


def timed(fn, *args, iters: int = 10, warmup: int = 2):
    """Returns (seconds per call, the last call's output): `warmup` calls
    (at least one), a fence, `iters` calls back to back, a fence."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args)
    synchronize(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    synchronize(out)
    return (time.perf_counter() - t0) / iters, out


@contextlib.contextmanager
def trace(log_dir: str):
    """`with trace('/tmp/tb'): step(...)` profiles the host and, where
    there is one, the card, and writes the trace into log_dir on exit.
    Open with `tensorboard --logdir` (torch-tb-profiler) or
    chrome://tracing."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


class _NanCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ not in _UNINITIALIZED:
            for x in tree_leaves(out):
                if (isinstance(x, torch.Tensor) and x.is_floating_point()
                        and bool(torch.isnan(x).any())):
                    raise FloatingPointError(
                        f"invalid value (nan) encountered in {func}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Within the context every operator's floating outputs are checked
    for NaN (a host sync per operator: a debugging aid, not for timing)
    and autograd's anomaly detection is on; enable=False turns anomaly
    detection off and checks nothing. The previous anomaly setting is
    restored on exit."""
    before = (torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled())
    torch.autograd.set_detect_anomaly(enable)
    try:
        if enable:
            with _NanCheck():
                yield
        else:
            yield
    finally:
        torch.autograd.set_detect_anomaly(*before)
