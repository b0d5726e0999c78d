"""Spans around the program's layers, and the reduction of a profiled slice.

`Spans` wraps a method of an instance, or a function of a module, by
name, without editing the program: each call adds its host-clock time
and its count, and, while a slice is profiled, runs inside a
torch.profiler range named "span:<name>" so that the kernels it launches
can be told apart. A name that finds nothing to wrap raises.

`profile` runs a few steps under torch.profiler (CPU and CUDA), and
`reduce_trace` reads its Chrome trace: the device's busy time (the union
of every kernel, copy and set on the device), the device time of the
kernels launched inside each span, the operations that took most time and
the longest gaps with no device work, each named by what the host was
doing when it began.
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SLICE = "bench:slice"


class Spans:
    def __init__(self):
        self.host = collections.defaultdict(float)
        self.calls = collections.Counter()
        self.profiling = False
        self._undo = []

    def wrap(self, owner, attr: str, name: str, hook=None) -> None:
        """Wraps owner.attr as span `name`; hook(args, kwargs, result), if
        given, sees each call and returns its result."""
        fn = getattr(owner, attr, None)
        if not callable(fn):
            raise RuntimeError(f"span {name}: {owner!r} has no callable "
                               f"{attr!r} to wrap")

        def wrapped(*args, **kwargs):
            t = time.perf_counter()
            if self.profiling:
                with torch.profiler.record_function("span:" + name):
                    out = fn(*args, **kwargs)
            else:
                out = fn(*args, **kwargs)
            self.host[name] += time.perf_counter() - t
            self.calls[name] += 1
            return out if hook is None else hook(args, kwargs, out)

        had = attr in vars(owner)
        self._undo.append((owner, attr, fn if had else None))
        setattr(owner, attr, wrapped)

    def reset(self) -> None:
        self.host.clear()
        self.calls.clear()

    def unwrap(self) -> None:
        for owner, attr, fn in reversed(self._undo):
            if fn is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, fn)
        self._undo.clear()


def profile(step, n: int, device) -> dict:
    """Runs step() n times under torch.profiler, synchronized at the end,
    and returns the Chrome trace it exported (written to and removed from
    the temporary directory). Off the card it traces the host alone."""
    from torch.profiler import ProfilerActivity, record_function

    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with torch.profiler.profile(activities=acts) as prof:
        with record_function(SLICE):
            for _ in range(n):
                step()
            if cuda:
                torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.remove(path)


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _innermost(events, t):
    """The shortest of `events` (ts, end, name) holding time t, or None."""
    best = None
    for a, b, name in events:
        if a <= t <= b and (best is None or b - a < best[1] - best[0]):
            best = (a, b, name)
    return None if best is None else best[2]


def reduce_trace(trace: dict, top: int = 10) -> dict:
    """-> {"window_s", "busy_s", "span_device_s": {span: s},
    "breakdown": {"device_ops": [[name, s]], "idle_gaps": [[name, s]]}}
    over the profiled slice. Times in seconds."""
    ev = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    sl = [e for e in ev if e.get("name") == SLICE
          and e.get("cat") == "user_annotation"]
    if not sl:
        raise RuntimeError("the profiled slice is missing from the trace")
    t0 = float(sl[0]["ts"])
    t1 = t0 + float(sl[0]["dur"])
    dev = [e for e in ev if e.get("cat") in DEVICE_CATS]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
              e["name"][len("span:"):]) for e in ev
             if e.get("cat") == "user_annotation"
             and e["name"].startswith("span:")]
    launches = {e["args"]["correlation"]: float(e["ts"]) for e in ev
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    per_span = collections.defaultdict(float)
    per_op = collections.defaultdict(float)
    intervals = []
    for e in dev:
        a = max(float(e["ts"]), t0)
        b = min(float(e["ts"]) + float(e["dur"]), t1)
        if b <= a:
            continue
        intervals.append((a, b))
        per_op[e["name"]] += (b - a) * 1e-6
        at = launches.get(e.get("args", {}).get("correlation"))
        name = None if at is None else _innermost(spans, at)
        if name is not None:
            per_span[name] += (b - a) * 1e-6
    busy = _union(intervals)
    gaps, prev = [], t0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = b
    if t1 > prev:
        gaps.append((prev, t1))
    cpu = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
           for e in ev if e.get("cat") in ("cpu_op", "cuda_runtime")]
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        span = _innermost(spans, a) or "outside spans"
        op = _innermost(cpu, a) or "python"
        named.append([f"{span}: {op}", (b - a) * 1e-6])
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    return {"window_s": (t1 - t0) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "span_device_s": dict(per_span),
            "breakdown": {"device_ops": [[k, v] for k, v in ops],
                          "idle_gaps": named}}
