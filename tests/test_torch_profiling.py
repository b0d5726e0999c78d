"""The port's profiling helpers (utils/profiling.py) and ops/nms.batched_nms
against the JAX package's: timed's result and fences, trace's files,
debug_nans raising FloatingPointError on a forward NaN and restoring the
anomaly state, batched_nms equal to the reference's and per-problem
independent."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multipathnet_tpu.ops import nms as jnms
from multipathnet_tpu_torch.ops import nms as tnms
from multipathnet_tpu_torch.utils import profiling


def test_timed_returns_plausible_time(monkeypatch):
    """Seconds per call and the last output; CPU outputs need no fence,
    so torch.cuda.synchronize is never called."""
    def no_sync(*a, **k):
        raise AssertionError("synchronized a CPU result")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    calls = []

    def f(x):
        calls.append(1)
        return {"sum": (x * 2).sum(), "shape": x.shape}

    sec, out = profiling.timed(f, torch.ones(64, 64), iters=3, warmup=1)
    assert sec > 0 and len(calls) == 4
    assert float(out["sum"]) == 64 * 64 * 2


def test_trace_writes_files(tmp_path):
    with profiling.trace(str(tmp_path)):
        (torch.ones(8) + 1).sum()
    files = [f for _, _, fs in os.walk(tmp_path) for f in fs]
    assert files and all(f.endswith(".pt.trace.json") for f in files)
    assert os.path.getsize(os.path.join(tmp_path, files[0])) > 0


@pytest.mark.parametrize("anomaly_before", [False, True])
def test_debug_nans_raises_and_restores(anomaly_before):
    """The reference's case: zeros / 0.0 raises FloatingPointError in the
    forward (anomaly detection alone checks only the backward); the
    previous anomaly state comes back, and finite work passes."""
    torch.autograd.set_detect_anomaly(anomaly_before)
    try:
        with pytest.raises(FloatingPointError, match="div"):
            with profiling.debug_nans():
                assert torch.is_anomaly_enabled()
                torch.zeros(4) / 0.0
        assert torch.is_anomaly_enabled() == anomaly_before
        with profiling.debug_nans():
            x = torch.ones(3, requires_grad=True)
            (torch.empty(1000).fill_(1.0).sum() * x).sum().backward()
            assert torch.equal(x.grad, torch.full((3,), 1000.0))
        with profiling.debug_nans(enable=False):
            assert not torch.is_anomaly_enabled()
            assert torch.isnan(torch.zeros(4) / 0.0).all()
        assert torch.is_anomaly_enabled() == anomaly_before
    finally:
        torch.autograd.set_detect_anomaly(False)


def test_debug_nans_checks_the_backward():
    """A NaN born in the backward (sqrt's derivative at 0 times 0) raises
    too: the operator check and anomaly detection both see it."""
    x = torch.zeros(1, requires_grad=True)
    with pytest.raises((FloatingPointError, RuntimeError), match="nan"):
        with profiling.debug_nans():
            (torch.sqrt(x) * 0.0).sum().backward()
    assert not torch.is_anomaly_enabled()


RNG = np.random.default_rng(1)


def _rand_dets(n, span=60):
    x1 = RNG.uniform(0, span, n)
    y1 = RNG.uniform(0, span, n)
    w = RNG.uniform(5, 40, n)
    h = RNG.uniform(5, 40, n)
    boxes = np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)
    return boxes, RNG.uniform(0, 1, n).astype(np.float32)


@pytest.mark.parametrize("with_valid", [False, True])
def test_batched_nms_matches_reference(with_valid):
    """tests/test_nms.py's per-class case (two problems of 30 boxes, IoU
    0.4) and a third with most boxes masked: indices and keep equal the
    reference's, and each problem's result is nms on it alone."""
    dets = [_rand_dets(30) for _ in range(3)]
    boxes = np.stack([b for b, _ in dets])
    scores = np.stack([s for _, s in dets])
    valid = RNG.random((3, 30)) < 0.5 if with_valid else None
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else torch.from_numpy(valid)
    want_i, want_k = jnms.batched_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                      0.4, 30, valid=jv)
    got_i, got_k = tnms.batched_nms(torch.from_numpy(boxes),
                                    torch.from_numpy(scores), 0.4, 30,
                                    valid=tv)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_k.numpy(), np.asarray(want_k))
    for c in range(3):
        i, k = tnms.nms(torch.from_numpy(boxes[c]),
                        torch.from_numpy(scores[c]), 0.4, 30,
                        None if tv is None else tv[c])
        assert torch.equal(i, got_i[c]) and torch.equal(k, got_k[c])
