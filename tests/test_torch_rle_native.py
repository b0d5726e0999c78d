"""The port's native RLE and box-IoU codec (data/rle_native.py, built from
multipathnet_tpu_torch/native/rle.cpp) against the port's NumPy codec and
the JAX package's native one: byte for byte, the dispatch active, malformed
input rejected, the build kept under build/rle."""

import numpy as np
import pytest

from multipathnet_tpu.data import rle as jrle
from multipathnet_tpu.data import rle_native as jnative
from multipathnet_tpu_torch.data import rle, rle_native
from multipathnet_tpu_torch.eval import coco_eval

RNG = np.random.default_rng(11)


def test_native_codec_builds_and_dispatches(monkeypatch):
    """g++ is on the test host: the codec must build (a failure does not
    hide behind the NumPy fallback), into build/rle/<hash>/, and the
    codec's entry points run it."""
    assert rle_native.available(), rle_native.load_error()
    assert rle_native.load_error() is None and rle.codec() == "native"
    lib = rle_native.build()
    assert lib.parent.parent == rle_native.BUILD_ROOT
    assert lib.name == "librle.so" and lib.exists()
    assert rle_native.SOURCE.parent.name == "native"
    assert rle_native.SOURCE.parent.parent.name == "multipathnet_tpu_torch"

    calls = []
    real = rle_native.decode_string
    monkeypatch.setattr(rle_native, "decode_string",
                        lambda s: calls.append(s) or real(s))
    assert rle.decode_counts("52203") == rle.decode_counts_np("52203")
    assert calls == ["52203"]


def test_string_codec_exact():
    for _ in range(20):
        counts = RNG.integers(0, 100_000, int(RNG.integers(1, 40))).tolist()
        s_np = rle.encode_counts_np(counts)
        assert rle_native.encode_string(counts) == s_np
        assert jnative.encode_string(counts) == s_np
        assert rle_native.decode_string(s_np) == counts
        assert rle.decode_counts_np(s_np) == counts
        assert rle.encode_counts(counts) == s_np
        assert rle.decode_counts(s_np) == counts


@pytest.mark.parametrize("p", [0.0, 0.4, 1.0])
def test_mask_codec_exact(p):
    for _ in range(10):
        h, w = int(RNG.integers(1, 60)), int(RNG.integers(1, 60))
        mask = (RNG.random((h, w)) < p).astype(np.uint8)
        c_np = rle.mask_to_counts_np(mask)
        assert rle_native.mask_to_counts(mask) == c_np
        assert jnative.mask_to_counts(mask) == c_np
        assert rle.mask_to_counts(mask) == c_np
        got = rle_native.counts_to_mask(c_np, (h, w))
        assert got.dtype == np.uint8 and got.shape == (h, w)
        np.testing.assert_array_equal(got, rle.counts_to_mask_np(c_np,
                                                                 (h, w)))
        np.testing.assert_array_equal(got, mask)
        r = rle.encode(mask)
        assert r == jrle.encode(mask)
        assert rle.area(r) == rle.area_np(r) == int(mask.sum())
        np.testing.assert_array_equal(rle.to_bbox(r), rle.to_bbox_np(r))
        assert rle.to_bbox(r).dtype == rle.to_bbox_np(r).dtype


def test_area_bbox_exact():
    for _ in range(10):
        h, w = int(RNG.integers(4, 50)), int(RNG.integers(4, 50))
        mask = np.zeros((h, w), np.uint8)
        y1, x1 = RNG.integers(0, h - 1), RNG.integers(0, w - 1)
        y2 = RNG.integers(y1 + 1, h + 1)
        x2 = RNG.integers(x1 + 1, w + 1)
        mask[y1:y2, x1:x2] = 1
        counts = rle.mask_to_counts_np(mask)
        area, bbox = rle_native.area_bbox(counts, h)
        assert area == int(mask.sum())
        np.testing.assert_array_equal(bbox, [x1, y1, x2 - x1, y2 - y1])
        j_area, j_bbox = jnative.area_bbox(counts, h)
        assert j_area == area
        np.testing.assert_array_equal(j_bbox, bbox)


def test_box_iou_native_equals_numpy():
    """bb_iou equals the NumPy box IoU bit for bit, crowd GT included (the
    evaluator's metrics then equal too: tests/test_torch_eval.py)."""
    for n_dt, n_gt in ((9, 7), (1, 1), (40, 3)):
        dt = RNG.uniform(0, 50, (n_dt, 4))
        dt[:, 2:] = RNG.uniform(1, 30, (n_dt, 2))
        gt = RNG.uniform(0, 50, (n_gt, 4))
        gt[:, 2:] = RNG.uniform(1, 30, (n_gt, 2))
        crowd = RNG.random(n_gt) < 0.3
        got = coco_eval.box_iou_xywh(dt, gt, crowd)
        np.testing.assert_array_equal(
            got, coco_eval.box_iou_xywh_np(dt, gt, crowd))
        np.testing.assert_array_equal(
            got, jnative.box_iou_xywh(dt, gt, crowd.astype(np.uint8)))
    assert coco_eval.box_iou_xywh(np.zeros((0, 4)), gt, crowd).shape == (
        0, n_gt)


def test_native_malformed_input_errors():
    with pytest.raises(ValueError, match="cover"):
        rle_native.counts_to_mask([5, 5], (2, 2))   # 10 px for a 2x2 mask
    with pytest.raises(ValueError, match="cover"):
        rle_native.counts_to_mask([1, -1, 4], (2, 2))
    with pytest.raises(ValueError, match="malformed"):
        rle_native.decode_string("a")               # a varint cut short
    with pytest.raises(ValueError, match="iscrowd"):
        rle_native.box_iou_xywh(np.ones((2, 4)), np.ones((3, 4)),
                                np.zeros(2, np.uint8))
