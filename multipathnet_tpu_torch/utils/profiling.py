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
  - `span(name)`: a named interval at a layer boundary, as a context
    manager or a decorator (module section "Spans and counters").
  - `count(name, n)`: one process-wide registry of counters, always on;
    `kernel_launches(since)` reads the kernels' launches from it.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
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


# ------------------------------------------------- spans and counters ---
#
# Spans mark the program's layer boundaries: `Detector.__call__` is the
# root "detect" (children detect.put, detect.resize, features, pool_rois,
# predict_rois, detect.decode, multiclass_nms, detect.fetch) and
# `Trainer.step` the root "train.step" (train.put, train.augment,
# train.sample, the same three model spans, train.loss, train.backward with
# pool_rois.backward under it, train.optimizer). Inside features only a
# ResNet trunk opens spans, features.stem and features.stage2..4
# (models/backbones/resnet.py), and under train.backward its training
# stages' features.stage2..4.backward; no span opens inside pool_rois,
# predict_rois or multiclass_nms, so a kernel launched there belongs to
# that span alone.
#
# Tracing is off by default, and then a span is one flag check and a call
# straight through. It is on while a torch.profiler session records, and
# inside `tracing()`. While on, a span keeps its host interval
# (perf_counter_ns), its parent and its root, and on the card a pair of
# timing events on the current stream, whose elapsed time (the span's
# device interval, idle time inside it included) is read only by
# `records()`. While the profiler records, it also runs inside
# record_function("span:" + name), so that the trace holds it on the
# device events' clock. A span opened on another thread with nothing open
# there (autograd's device thread) is a child of the open span that adopts
# such spans (`span(..., adopt=True)`: train.backward).
#
# Counters are always on: `count` adds to one registry, which `counters()`
# reads; nothing resets it, so a reader keeps a snapshot and takes the
# difference, as a root span's record does (every counter's change over
# the root). Names:
#   sync.<site>  blocking waits of the host on the card (CUDA only)
#   nms.rounds   rounds of ops/nms.nms_sorted's fixpoint
#   bn.passes    frozen-BN passes: forwards of models/layers.FrozenBatchNorm
#                and the BNs layers.conv_bn runs with their 1x1 convolution
#   h2d.bytes    bytes put on the program's device from host arrays
#   d2h.bytes    bytes of results copied back to the host
#   launches.<kernel>  launches of a hand-written kernel, counted at its
#                launch site (CUDA only; each module lists its kernels'
#                counters at 0 from import on), read by kernel through
#                `kernel_launches()`

RING = 256   # completed root spans kept

_tracing = 0
_profiler_enabled = torch.autograd._profiler_enabled


class _Local(threading.local):
    def __init__(self):
        self.stack = []     # this thread's open spans


_local = _Local()
_lock = threading.Lock()
_roots = collections.deque(maxlen=RING)
_adopter = None
_n_open = 0     # spans open on every thread
_sites = {}
_counts = collections.defaultdict(int)


def tracing_on() -> bool:
    """Whether spans record: inside `tracing()` or while torch.profiler
    records."""
    return bool(_tracing) or _profiler_enabled()


@contextlib.contextmanager
def tracing():
    """Spans record within the context (on every thread), without the
    profiler: host and device intervals and counter changes, read through
    `records()`."""
    global _tracing
    _tracing += 1
    try:
        yield
    finally:
        _tracing -= 1


class _Record:
    __slots__ = ("site", "parent", "root", "thread", "start_ns", "end_ns",
                 "children", "events", "device_ms", "range", "before",
                 "counters", "outer")

    def __init__(self, site, parent):
        self.site = site
        self.parent = parent
        self.root = self if parent is None else parent.root
        self.thread = threading.get_ident()
        self.children = []
        self.events = self.device_ms = self.range = None
        self.before = self.counters = self.outer = None
        self.end_ns = None


def _open(site) -> None:
    global _adopter, _n_open
    stack = _local.stack
    r = _Record(site, stack[-1] if stack else _adopter)
    if r.parent is None:
        r.before = counters()
    else:
        r.parent.children.append(r)
    if _profiler_enabled():
        r.range = torch.profiler.record_function("span:" + site.name)
        r.range.__enter__()
    if torch.cuda.is_initialized():
        r.events = (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))
        r.events[0].record()
    if site.adopt:
        r.outer, _adopter = _adopter, r
    stack.append(r)
    _n_open += 1
    r.start_ns = time.perf_counter_ns()


def _close(r) -> None:
    global _adopter, _n_open
    r.end_ns = time.perf_counter_ns()
    _n_open -= 1
    if r.events is not None:
        r.events[1].record()
    if r.range is not None:
        r.range.__exit__(None, None, None)
        r.range = None
    if r.site.adopt:
        _adopter = r.outer
    if r.parent is None:
        after = counters()
        r.counters = {k: v - r.before.get(k, 0) for k, v in after.items()
                      if v != r.before.get(k, 0)}
        r.before = None
        with _lock:
            _roots.append(r)


class _Site:
    """A named span: `with span(name):` or `@span(name)`."""

    __slots__ = ("name", "adopt")

    def __init__(self, name, adopt):
        self.name = name
        self.adopt = adopt

    def __enter__(self):
        if tracing_on():
            _open(self)

    def __exit__(self, *exc):
        if _n_open:
            stack = _local.stack
            if stack and stack[-1].site is self:
                _close(stack.pop())
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not tracing_on():
                return fn(*args, **kwargs)
            with self:
                return fn(*args, **kwargs)
        return spanned


def span(name: str, adopt: bool = False) -> _Site:
    """The span `name`, as a context manager or a decorator (one object a
    name, so an off span allocates nothing). adopt=True: while it is open,
    a span opened on another thread with nothing open there is its child
    (autograd runs a CUDA backward on its own thread)."""
    site = _sites.get(name)
    if site is None:
        site = _sites.setdefault(name, _Site(name, adopt))
    if site.adopt != adopt:
        raise ValueError(f"span {name!r} is adopt={site.adopt}")
    return site


def _as_dict(r) -> dict:
    if r.events is not None and r.end_ns is not None:
        start, end = r.events
        end.synchronize()
        r.device_ms = start.elapsed_time(end)
        r.events = None
    out = {"name": r.site.name,
           "parent": None if r.parent is None else r.parent.site.name,
           "root": r.root.site.name, "thread": r.thread,
           "start_ns": r.start_ns, "end_ns": r.end_ns,
           "device_ms": r.device_ms,
           "children": [_as_dict(c) for c in list(r.children)]}
    if r.parent is None:
        out["counters"] = dict(r.counters)
    return out


def records() -> list:
    """The completed root spans kept (the last RING), oldest first: dicts
    of name, parent and root (names), thread, start_ns and end_ns
    (perf_counter_ns), device_ms (the span's device interval; None off
    the card), children (the same dicts, in opening order) and, on a
    root, counters (each counter's change over it). The first read of a
    span waits for its end event."""
    with _lock:
        roots = list(_roots)
    return [_as_dict(r) for r in roots]


def clear_records() -> None:
    with _lock:
        _roots.clear()


def walk(record: dict):
    """A record and every span under it, depth first."""
    yield record
    for c in record["children"]:
        yield from walk(c)


def count(name: str, n: int = 1) -> None:
    """Adds n to counter `name`."""
    _counts[name] += n


def count_sync(site: str, device, n: int = 1) -> None:
    """Counts n blocking waits of the host at `site` (counter
    sync.<site>) when `device` is a CUDA device."""
    if device.type == "cuda":
        _counts["sync." + site] += n


def counters() -> dict:
    """A snapshot of every counter."""
    return dict(_counts)


def kernel_launches(since: dict | None = None) -> dict:
    """{kernel: launches} from the counters launches.<kernel>, less their
    values in `since`, an earlier counters() snapshot."""
    since = since or {}
    return {k.removeprefix("launches."): v - since.get(k, 0)
            for k, v in list(_counts.items()) if k.startswith("launches.")}
