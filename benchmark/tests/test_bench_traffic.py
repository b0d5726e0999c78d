"""The traffic generator: deterministic per seed, the stated shapes and
extents."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from benchmark import traffic

from conftest import REPO

MIXES = sorted(f[:-5] for f in os.listdir(os.path.join(
    REPO, "benchmark", "traffic")) if f.endswith(".json"))


def load(name):
    return json.load(open(os.path.join(REPO, "benchmark", "traffic",
                                       name + ".json")))


@pytest.mark.parametrize("name", MIXES)
def test_deterministic_and_shaped(name):
    mix = dict(load(name), pool=2)
    a = traffic.batches(mix, 2**40 + 7)
    b = traffic.batches(mix, 2**40 + 7)
    c = traffic.batches(mix, 2**40 + 8)
    assert len(a) == 2
    for x, y in zip(a[0], b[0]):
        np.testing.assert_array_equal(x, y)
    assert not np.array_equal(a[0][2], c[0][2])
    images, hws, props, pmask = a[0][:4]
    bsz, s, p = mix["batch"], mix["canvas"], mix["proposals"]
    assert images.shape == (bsz, s, s, 3) and images.dtype == np.uint8
    assert props.shape == (bsz, p, 4) and props.dtype == np.float32
    assert pmask.all()
    lo, hi = mix["short_side"]
    for img, (h, w), pr in zip(images, hws, props):
        assert max(h, w) == mix["long_side"] and lo <= min(h, w) <= hi
        assert not img[int(h):].any() and not img[:, int(w):].any()
        assert (pr[:, 0] >= 0).all() and (pr[:, 2] <= w).all()
        assert (pr[:, 1] >= 0).all() and (pr[:, 3] <= h).all()
        side = np.minimum(pr[:, 2] - pr[:, 0], pr[:, 3] - pr[:, 1])
        assert (side >= mix["side"][0] - 1e-3).all()
    if mix["kind"] == "train":
        gt, cls, gmask = a[0][4:]
        n = gmask.sum(1)
        assert gt.shape == (bsz, mix["max_gt"], 4)
        assert ((n >= mix["gt"][0]) & (n <= mix["gt"][1])).all()
        assert ((cls[gmask] >= mix["gt_classes"][0])
                & (cls[gmask] < mix["gt_classes"][1])).all()
        assert not cls[~gmask].any()
