"""The device's idle share is read against the untraced window's time a
batch or step, so the profiler's own host cost is not counted as idle."""

from __future__ import annotations

import pytest

from benchmark import harness

LAYERS = {
    "serve": {"kind": "serve", "batches": 12, "busy_s": 0.36,
              "window_s": 0.6, "batch_s": 0.04},
    "train": {"kind": "train", "steps": 8, "busy_s": 0.32, "window_s": 0.6,
              "step_s": 0.05},
}


@pytest.mark.parametrize("kind,idle", [("serve", 25.0), ("train", 20.0)])
def test_idle_share_of_the_untraced_window(kind, idle):
    read = harness.load_reader("device_idle_pct." + kind)
    assert read(LAYERS[kind]) == pytest.approx(idle)
    other = "train" if kind == "serve" else "serve"
    assert read(LAYERS[other]) is None


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_idle_share_reads_nothing_without_device_work(kind):
    read = harness.load_reader("device_idle_pct." + kind)
    assert read(dict(LAYERS[kind], busy_s=0.0)) is None
    assert read(None) is None
