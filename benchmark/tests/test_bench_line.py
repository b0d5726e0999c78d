"""A whole run of the tiny cells on the CPU: the result line's keys."""

from __future__ import annotations

import time

import torch

from benchmark import harness

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def run(root, cell, trace):
    metrics, out = harness.run_cell(root, cell, 2**40 + 3, 0.1, trace,
                                    torch.device("cpu"), time.perf_counter())
    return harness.result_line(metrics, out, {"platform": "cpu"})


def test_serve_line(tiny):
    line = run(tiny, "tiny", False)
    assert list(line) == KEYS
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"img_per_s", "batch_p95_ms", "setup_s"}
    assert set(line["checks"]) == {"prob_err", "box_err", "nms_mismatch"}


def test_serve_traced_line(tiny):
    line = run(tiny, "tiny", True)
    assert list(line) == KEYS[:5] + ["breakdown", "checks"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # off the card no kernel is traced: the rooflines read nothing
    assert {"mfu.serve", "nms_ms.serve"} <= set(line["metrics"])
    assert not any("roofline" in k for k in line["metrics"])


def test_train_line(tiny_train):
    line = run(tiny_train, "tiny_train", False)
    assert list(line) == KEYS
    assert line["correct"] is True
    assert set(line["metrics"]) == {"train_step_ms", "setup_s"}
    assert set(line["checks"]) == {"loss_gap", "grad_gap", "update_gap"}
