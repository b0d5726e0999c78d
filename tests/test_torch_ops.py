"""Port parity, ops layer: multipathnet_tpu_torch.ops / .data against the JAX
package on the same numpy inputs (boxes, resize, pyramid, view geometry,
the K1/K2 pool kernels' plain versions against the Pallas kernels in
interpret mode, NMS)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multipathnet_tpu.data import transforms as jtf
from multipathnet_tpu.ops import boxes as jbox
from multipathnet_tpu.ops import nms as jnms
from multipathnet_tpu.ops import roi_pallas as jrk
from multipathnet_tpu.ops import roi_pyramid as jrp
from multipathnet_tpu_torch.data import transforms as ttf
from multipathnet_tpu_torch.ops import boxes as tbox
from multipathnet_tpu_torch.ops import nms as tnms
from multipathnet_tpu_torch.ops import roi_pool as trk
from multipathnet_tpu_torch.ops import roi_pyramid as trp
from multipathnet_tpu_torch.utils import profiling

torch.set_num_threads(2)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _boxes(rng, shape, lo=0.0, hi=60.0, min_wh=1.0, max_wh=30.0):
    x1 = rng.uniform(lo, hi, shape)
    y1 = rng.uniform(lo, hi, shape)
    w = rng.uniform(min_wh, max_wh, shape)
    h = rng.uniform(min_wh, max_wh, shape)
    return np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)


# ---------------------------------------------------------------- boxes ---

def test_boxes_match_reference():
    rng = np.random.default_rng(0)
    a = _boxes(rng, (3, 12))
    b = _boxes(rng, (3, 9))
    a[0, 0] = [5, 5, 5, 9]            # zero-area (padded) box
    deltas = rng.normal(0, 1, (3, 12, 4)).astype(np.float32)
    deltas[1, 2] = [1e4, -1e4, 1e4, 1e4]   # garbage padded row
    means, stds = (0.1, -0.1, 0.0, 0.05), (0.1, 0.1, 0.2, 0.2)
    ta, tb, td = (torch.from_numpy(x) for x in (a, b, deltas))
    pairs = [
        (tbox.area(ta), jbox.area(a)),
        (tbox.to_center_form(ta), jbox.to_center_form(a)),
        (tbox.from_center_form(ta), jbox.from_center_form(a)),
        (tbox.iou_matrix(ta, tb), jbox.iou_matrix(a, b)),
        (tbox.encode(ta, ta.flip(1), means, stds),
         jbox.encode(a, a[:, ::-1], means, stds)),
        (tbox.decode(ta, td, means, stds), jbox.decode(a, deltas, means, stds)),
        (tbox.clip(ta, 40, 50), jbox.clip(a, 40, 50)),
        (tbox.expand(ta, 1.5), jbox.expand(a, 1.5)),
        (tbox.expand(ta, 4.0, 48, 56), jbox.expand(a, 4.0, 48, 56)),
    ]
    for got, want in pairs:
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(_np(got), want, atol=1e-5, rtol=1e-6)
    assert np.isfinite(_np(pairs[5][0])).all()


# ------------------------------------------------------------ transforms ---

@pytest.mark.parametrize("canvas", [(64, 72), (24, 20)],
                         ids=["upscale", "downscale"])
def test_resize_matches_reference(canvas):
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, (2, 40, 52, 3), dtype=np.uint8)
    src_hws = np.asarray([[40, 52], [31, 45]], np.float32)
    want, want_s = jax.jit(
        lambda im, hw: jtf.batch_resize_to_canvas(im, canvas, hw))(
        images, src_hws)
    got, got_s = ttf.batch_resize_to_canvas(
        torch.from_numpy(images), canvas, torch.from_numpy(src_hws))
    np.testing.assert_array_equal(_np(got_s), np.asarray(want_s))
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("side", ["height", "width"])
@pytest.mark.parametrize("jit", [True, False], ids=["jit", "eager"])
def test_resize_scale_matches_reference(side, jit):
    """The canvas scale min(ch / sh, cw / sw), bit for bit, for every
    source size 1..1200 against canvases 48, 64, 600, 640 and 1000, each
    side the limiting one: the reference jitted and eager. The other side
    gets a canvas of 1 and a source of 1e-4, so it never limits and the
    resized images stay one pixel wide."""
    src = np.arange(1, 1201, dtype=np.float32)
    other = np.full_like(src, 1e-4)
    hw = np.stack([src, other] if side == "height" else [other, src], -1)
    images = np.zeros((len(src), 1, 1, 3), np.uint8)
    for c in (48, 64, 600, 640, 1000):
        canvas = (c, 1) if side == "height" else (1, c)

        def ref(im, hw, canvas=canvas):
            return jtf.batch_resize_to_canvas(im, canvas, hw)[1]

        want = np.asarray((jax.jit(ref) if jit else ref)(images, hw))
        got = ttf.batch_resize_to_canvas(torch.from_numpy(images), canvas,
                                         torch.from_numpy(hw))[1]
        np.testing.assert_array_equal(_np(got), want, err_msg=str(c))
        np.testing.assert_array_equal(want, np.float32(c) / src)


def test_normalize_and_single_resize_match_reference():
    rng = np.random.default_rng(2)
    image = rng.integers(0, 256, (30, 22, 3), dtype=np.uint8)
    np.testing.assert_allclose(_np(ttf.normalize(torch.from_numpy(image))),
                               np.asarray(jtf.normalize(image)), atol=1e-6)
    want, want_s = jtf.resize_to_canvas(image, (48, 48))
    got, got_s = ttf.resize_to_canvas(torch.from_numpy(image), (48, 48))
    assert float(got_s) == float(want_s)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


# --------------------------------------------------------------- pyramid ---

def _pyramids(feats, scale):
    jflat, jmeta = jax.jit(jrp.build_pyramid_batch, static_argnums=1)(
        jnp.asarray(feats), scale)
    tflat, tmeta = trp.build_pyramid_batch(torch.from_numpy(feats), scale)
    return (jflat, jmeta), (tflat, tmeta)


def test_pyramid_matches_reference():
    feats = np.random.default_rng(3).normal(
        size=(2, 21, 27, 6)).astype(np.float32)   # odd dims: partial cells
    (jflat, jmeta), (tflat, tmeta) = _pyramids(feats, 0.25)
    assert tflat.shape == jflat.shape
    np.testing.assert_allclose(_np(tflat), np.asarray(jflat), atol=1e-6)
    for field in ("row_offsets", "heights", "widths"):
        np.testing.assert_array_equal(_np(getattr(tmeta, field)),
                                      np.asarray(getattr(jmeta, field)))
    assert tmeta.num_scales == jmeta.num_scales
    assert tmeta.flat.shape == jmeta.flat.shape
    one = trp.build_pyramid(torch.from_numpy(feats[1]), 0.25)
    want = jax.jit(jrp.build_pyramid, static_argnums=1)(
        jnp.asarray(feats[1]), 0.25)
    np.testing.assert_allclose(_np(one.flat), np.asarray(want.flat),
                               atol=1e-6)
    np.testing.assert_array_equal(_np(one.row_offsets),
                                  np.asarray(want.row_offsets))
    assert trp.window_sizes(7) == jrp.window_sizes(7)
    assert (trp.WINDOW, trp.WINDOW_X) == (jrp.WINDOW, jrp.WINDOW_X)
    assert trp.num_scales_for(160, 160) == jrp.num_scales_for(160, 160)


# ------------------------------------------------------- view geometry ---

def _views(rng, n, hw):
    """ROIs of every size class, including ones on the image border, kept
    away from the level rule's power-of-two boundaries (a ULP of log2 there
    picks another level in the two frameworks)."""
    h, w = hw
    out = []
    while len(out) < n:
        bw, bh = np.exp(rng.uniform(np.log(2.0), np.log(max(h, w)), 2))
        x1 = rng.uniform(-0.2 * bw, w - 0.8 * bw)
        y1 = rng.uniform(-0.2 * bh, h - 0.8 * bh)
        box = np.clip([x1, y1, x1 + bw, y1 + bh], 0, [w, h, w, h])
        out.append(box)
    return np.asarray(out, np.float32)


def _safe(rois, scale, g=7, tol=1e-3):
    b = rois.astype(np.float64) * scale
    span = np.maximum(np.maximum(b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]),
                      1e-6) / g
    l2 = np.log2(np.maximum(span, 1.0))
    return (l2 == 0) | (np.abs(l2 - np.round(l2)) > tol)


def test_view_geometry_matches_reference():
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(1, 24, 30, 4)).astype(np.float32)
    scale = 0.25
    (_, jmeta), (_, tmeta) = _pyramids(feats, scale)
    rois = _views(rng, 96, (96, 120))
    rois = rois[_safe(rois, scale)]
    want = jax.jit(jrk.view_geometry)(jmeta, jnp.asarray(rois))
    got = trk.view_geometry(tmeta, torch.from_numpy(rois))
    for name, g_, w_ in zip(("row0", "x0", "wy", "wx"), got, want):
        w_ = np.asarray(w_)
        assert g_.shape == w_.shape, name
        if name in ("row0", "x0"):
            assert g_.dtype == torch.int32
            np.testing.assert_array_equal(_np(g_), w_, err_msg=name)
        else:
            np.testing.assert_allclose(_np(g_), w_, atol=1e-6, err_msg=name)
    # the views cover every pyramid scale
    levels = np.searchsorted(np.asarray(jmeta.row_offsets),
                             np.asarray(want[0]), side="right") - 1
    assert set(levels.tolist()) == set(range(jmeta.num_scales))


# ------------------------------------------------- K1 / K2 plain versions ---

LEVEL_HW = {"c3": (32, 40), "c4": (16, 20), "c5": (8, 10)}
STRIDE = {"c3": 4, "c4": 8, "c5": 16}


def _level_inputs(seed, b=2, c=8):
    rng = np.random.default_rng(seed)
    feats = {lv: rng.normal(size=(b, *hw, c)).astype(np.float32)
             for lv, hw in LEVEL_HW.items()}
    return rng, feats


def test_window_pool_multi_plain_matches_pallas():
    rng, feats = _level_inputs(5)
    b, n_per = 2, 12
    rois = _views(rng, 3 * b * n_per, (128, 160))
    rois = rois[_safe(rois, 0.25) & _safe(rois, 0.125) & _safe(rois, 1 / 16)]
    rois = rois[:b * n_per]
    img_idx = np.repeat(np.arange(b, dtype=np.int32), n_per)
    jargs, targs = [[], [], [], [], []], [[], [], [], [], []]
    for lv in ("c3", "c4", "c5"):
        (jflat, jmeta), (tflat, tmeta) = _pyramids(feats[lv], 1 / STRIDE[lv])
        row0, x0, wy, wx = jax.jit(jrk.view_geometry)(jmeta,
                                                      jnp.asarray(rois))
        row0 = row0 + jnp.asarray(img_idx) * jmeta.flat.shape[0]
        for dst, v in zip(jargs, (jflat, row0, x0, wy, wx)):
            dst.append(v)
        for dst, v in zip(targs, (tflat, row0, x0, wy, wx)):
            dst.append(v if isinstance(v, torch.Tensor)
                       else torch.from_numpy(np.array(v)))
    want = jax.jit(lambda *a: jrk.pallas_window_pool_multi(
        *a, tile=8, interpret=True))(*jargs)
    got = trk.window_pool_multi(*targs)
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4)
    # the batched entry point computes its own geometry: same result
    got_b = trk.batched_pyramid_pool_multi(
        targs[0], [trp.build_pyramid_batch(torch.from_numpy(feats[lv]),
                                           1 / STRIDE[lv])[1]
                   for lv in ("c3", "c4", "c5")],
        torch.from_numpy(rois), torch.from_numpy(img_idx))
    np.testing.assert_allclose(_np(got_b), np.asarray(want), atol=1e-4)


def test_resident_pool_plain_matches_pallas():
    rng, feats = _level_inputs(6)
    b, v = 2, 12
    rois = _views(rng, 3 * b * v, (128, 160))
    rois = rois[_safe(rois, 1 / 16)][:b * v]
    (jflat, jmeta), (tflat, tmeta) = _pyramids(feats["c5"], 1 / 16)
    rows, wmax, c = jmeta.flat.shape
    row0, x0, wy, wx = jax.jit(jrk.view_geometry)(jmeta, jnp.asarray(rois))
    jargs = (jflat.reshape(b, rows, wmax, c), row0.reshape(b, v),
             x0.reshape(b, v), wy.reshape(b, v, 7, 10), wx.reshape(b, v, 7, 16))
    want = jax.jit(lambda *a: jrk.pallas_resident_pool(
        *a, tile=8, interpret=True))(*jargs)
    got = trk.resident_pool(*(torch.from_numpy(np.array(a)) for a in jargs))
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-4)
    got_b = trk.batched_pyramid_pool_resident(tflat, tmeta,
                                              torch.from_numpy(rois), b)
    np.testing.assert_allclose(_np(got_b),
                               np.asarray(want).reshape(b * v, 7, 7, c),
                               atol=1e-4)


def test_pool_wrappers_take_plain_version_on_cpu():
    """On CPU tensors the wrappers run their plain versions and count no
    kernel launch."""
    rng, feats = _level_inputs(7, b=1)
    flat, meta = trp.build_pyramid_batch(torch.from_numpy(feats["c5"]), 1 / 16)
    rois = torch.from_numpy(_views(rng, 4, (128, 160)))
    before = profiling.counters()
    trk.batched_pyramid_pool_resident(flat, meta, rois, 1)
    trk.batched_pyramid_pool_multi([flat], [meta], rois,
                                   torch.zeros(4, dtype=torch.int32))
    launched = profiling.kernel_launches(before)
    assert (launched["window_pool_multi"], launched["resident_pool"]) == (0, 0)


# ------------------------------------------------------------------- NMS ---

def _nms_inputs(seed, n=40, c=5, shared=False):
    rng = np.random.default_rng(seed)
    base = _boxes(rng, (n,), hi=40.0, min_wh=4.0, max_wh=20.0)
    boxes = base if shared else (
        base[:, None, :] + rng.normal(0, 2, (n, c, 4)).astype(np.float32))
    # coarse scores: many exact ties exercise the top-k tie order
    scores = (rng.integers(0, 20, (n, c)) / 20.0).astype(np.float32)
    valid = rng.uniform(size=n) > 0.15
    return boxes, scores, valid


@pytest.mark.parametrize("shared,max_det,pre", [
    (False, 10, 8), (True, 10, 8), (False, 60, 8)],
    ids=["per-class", "shared-boxes", "padded"])
def test_multiclass_nms_matches_reference(shared, max_det, pre):
    kw = dict(score_threshold=0.1, iou_threshold=0.5,
              pre_nms_per_class=pre, max_detections=max_det)
    per_image = [_nms_inputs(s, shared=shared) for s in (8, 9)]
    want = [jax.jit(lambda b, s, v: jnms.multiclass_nms(b, s, v, **kw))(*x)
            for x in per_image]
    got = tnms.multiclass_nms(
        *(torch.from_numpy(np.stack(a)) for a in zip(*per_image)), **kw)
    for i, w in enumerate(want):
        for key in ("valid", "classes", "indices"):
            np.testing.assert_array_equal(_np(got[key][i]), np.asarray(w[key]),
                                          err_msg=key)
        np.testing.assert_array_equal(_np(got["scores"][i]),
                                      np.asarray(w["scores"]))
        np.testing.assert_allclose(_np(got["boxes"][i]), np.asarray(w["boxes"]),
                                   atol=1e-6)
    assert got["classes"].dtype == torch.int32


def test_nms_sorted_matches_greedy_and_reference():
    rng = np.random.default_rng(10)
    boxes = _boxes(rng, (3, 30), hi=30.0, min_wh=5.0, max_wh=25.0)
    scores = np.sort(rng.uniform(size=(3, 30)).astype(np.float32))[:, ::-1]
    scores = np.ascontiguousarray(scores)
    scores[:, -4:] = -1e10        # sentinel: not candidates
    keep = tnms.nms_sorted(torch.from_numpy(boxes), torch.from_numpy(scores),
                           0.4)
    for i in range(3):
        want = jnms.nms_sorted(boxes[i], scores[i], 0.4)
        np.testing.assert_array_equal(_np(keep[i]), np.asarray(want))
        idx, ok = tnms.nms(torch.from_numpy(boxes[i]),
                           torch.from_numpy(scores[i]), 0.4, 30)
        greedy = np.zeros(30, bool)
        greedy[_np(idx)[_np(ok)]] = True
        np.testing.assert_array_equal(_np(keep[i]), greedy)
        jidx, jok = jnms.nms(boxes[i], scores[i], 0.4, 30)
        np.testing.assert_array_equal(_np(idx), np.asarray(jidx))
        np.testing.assert_array_equal(_np(ok), np.asarray(jok))
