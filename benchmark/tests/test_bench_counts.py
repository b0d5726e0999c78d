"""The work counts against hand counts at a small size."""

from __future__ import annotations

import torch

from benchmark.counts import multipath as counts

MODEL = {"skip_reduce_dim": 16, "skip_levels": ["c3", "c4", "c5"],
         "roi_output_size": 2, "roi_samples_per_bin": 2, "fc_dim": 8,
         "fc6_rank": 4, "fc7_rank": 0, "foveal_scales": [1.0, 2.0],
         "foveal_topology": "reference", "num_classes": 3,
         "integral_thresholds": [0.5, 0.6], "class_specific_bbox": True,
         "head_quant": "int8"}


def test_trunk_by_hand():
    got = counts.trunk(MODEL, 32, 2)
    convs = [(32, 3, 64), (32, 64, 64), (16, 64, 128), (16, 128, 128),
             (8, 128, 256), (8, 256, 256), (8, 256, 256), (4, 256, 512),
             (4, 512, 512), (4, 512, 512), (2, 512, 512), (2, 512, 512),
             (2, 512, 512)]
    ops = sum(2 * s * s * i * o * 9 for s, i, o in convs)
    ops += 2 * 16 * (8 * 8 * 256 + 4 * 4 * 512 + 2 * 2 * 512)
    assert got["ops"] == 2 * ops
    w = sum(i * o * 9 + o for _, i, o in convs) + 16 * (256 + 512 + 512)
    out = 2 * 16 * (64 + 16 + 4)
    assert got["bytes"] == 2 * w + 2 * (32 * 32 * 3 * 4 + out)
    frozen = counts.trunk(MODEL, 32, 1, first_block=3)
    assert frozen["ops"] == ops - sum(2 * s * s * i * o * 9
                                      for s, i, o in convs[:4])


def test_head_by_hand():
    rows = 5
    k = 2 * 2 * 16
    macs = 2 * (k * 4 + 4 * 8 + 8 * 8) + 2 * 8 * (2 * 3 + 4 * 3)
    got = counts.head(MODEL, rows)
    assert got["ops"] == 2 * rows * macs
    assert got["bytes"] == macs + rows * 2 * (k + 4) + rows * 18 * 2


def test_pool_one_view_by_hand():
    """One proposal of 8 x 8 canvas pixels at (4, 4) on a 64 canvas with
    one level (c3, stride 4) and one view: 2 x 2 cells at scale 0 (span
    1 cell a bin at G = 2), samples in rows/cols 1.25..2.75 -> cells 1..3."""
    m = dict(MODEL, skip_levels=["c3"], foveal_scales=[1.0])
    rois = torch.tensor([[[4.0, 4.0, 12.0, 12.0]]])
    got = counts.pool(m, 64, rois)
    g, c = 2, 16
    assert got["ops"] == 2 * g * c * 3 * 3 + 2 * g * g * c * 3
    assert got["bytes"] == 9 * c * 2 + (g * g * c + 4) + 16


def test_pool_union_counts_each_cell_once():
    m = dict(MODEL, skip_levels=["c3"], foveal_scales=[1.0])
    one = torch.tensor([[[4.0, 4.0, 12.0, 12.0]]])
    two = torch.tensor([[[4.0, 4.0, 12.0, 12.0], [4.0, 4.0, 12.0, 12.0]]])
    a, b = counts.pool(m, 64, one), counts.pool(m, 64, two)
    assert b["ops"] == 2 * a["ops"]
    assert b["bytes"] - a["bytes"] == (2 * 2 * 16 + 4) + 16


def test_train_ops():
    m = dict(MODEL, head_quant="none")
    got = counts.train(m, 32, 2, 6, 2)["ops"]
    full = counts.trunk(m, 32, 2)["ops"]
    part = counts.trunk(m, 32, 2, 3)["ops"]
    head = counts.head(m, 6)["ops"]
    assert got == full + head + 2 * (part + head)
