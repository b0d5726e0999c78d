"""Port parity, the reference-exact max route: multipathnet_tpu_torch/ops/
roi.py (roi_pool_max, the exact route in two chunked stages) and the max
half of ops/roi_pyramid.py (max pyramids, the windowed exact_max route)
against the JAX package's, jitted as its models run them, and caffe_bgr
preprocessing. Max is exact, so every comparison is bit for bit (NaN
positions included)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multipathnet_tpu.data import transforms as jtf
from multipathnet_tpu.ops import roi as jroi
from multipathnet_tpu.ops import roi_pyramid as jrp
from multipathnet_tpu_torch.data import transforms as ttf
from multipathnet_tpu_torch.ops import roi as troi
from multipathnet_tpu_torch.ops import roi_pyramid as trp

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _feat(rng, shape, jdt, tdt, nan=False):
    """One map in both packages' dtypes, equal values (bf16 through
    float32, which holds every bf16 value)."""
    f = rng.normal(size=shape).astype(np.float32)
    if nan:
        f[3, 4, 1] = np.nan
        f[5, 2, 0] = np.inf
    j = jnp.asarray(f, jdt)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)
    return j, t


def _rois(rng, n, hi=90.0, size=60.0):
    """Image-coordinate ROIs: random ones, partly off the map, plus an
    all-zero padded row, a degenerate (zero-width) one, one wholly past
    the map and one with x2 < x1."""
    x1 = rng.uniform(-10, hi, n)
    y1 = rng.uniform(-10, hi * 0.8, n)
    w = rng.uniform(0, size, n)
    h = rng.uniform(0, size, n)
    rois = np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)
    rois[:4] = [[0, 0, 0, 0], [20, 8, 20, 30], [400, 400, 420, 430],
                [50, 10, 30, 40]]
    return rois


def _same(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want).astype(np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("max_elements", [3000, troi.MAX_ELEMENTS])
def test_roi_pool_max_matches_reference(dtype, max_elements):
    """Every bin of 300 ROIs at scale 1/4 on a (20, 24, 5) map with a NaN
    and an inf: empty bins and non-finite results 0, degenerate, padded
    and off-map ROIs included, in chunks of 1 ROI or all at once. The bin
    edges follow the reference as XLA compiles it (ops/roi.py)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    jf, tf = _feat(rng, (20, 24, 5), jdt, tdt, nan=True)
    rois = _rois(rng, 300)
    want = jax.jit(lambda f, r: jroi.roi_pool_max(
        f, r, spatial_scale=0.25))(jf, jnp.asarray(rois))
    got = troi.roi_pool_max(tf, torch.from_numpy(rois), spatial_scale=0.25,
                            max_elements=max_elements)
    assert got.dtype == tdt
    _same(got, want)
    assert (got == 0).any() and (got != 0).any()


def test_bin_edges_follow_the_compiled_reference():
    """ROIs whose extent is a multiple of G put bin edges exactly on cell
    boundaries: there the reference's compiled arithmetic (a multiply by
    float32(1/G) fused with the add) moves edges by one cell against a
    true division, and the port follows the compiled form, edge for edge,
    over 4000 ROIs in both dtypes."""
    rng = np.random.default_rng(1)
    rois = _rois(rng, 4000)

    def edges(r, dt):
        b = r * 0.25
        x1, y1 = jnp.floor(b[:, 0]), jnp.floor(b[:, 1])
        x2, y2 = jnp.ceil(b[:, 2]), jnp.ceil(b[:, 3])
        rh, rw = jnp.maximum(y2 - y1, 1.0), jnp.maximum(x2 - x1, 1.0)
        bins = jnp.arange(7, dtype=dt)
        return (jnp.clip(jnp.floor(y1[:, None] + bins * rh[:, None] / 7),
                         0, 20),
                jnp.clip(jnp.ceil(y1[:, None] + (bins + 1) * rh[:, None] / 7),
                         0, 20),
                jnp.clip(jnp.floor(x1[:, None] + bins * rw[:, None] / 7),
                         0, 24),
                jnp.clip(jnp.ceil(x1[:, None] + (bins + 1) * rw[:, None] / 7),
                         0, 24))

    for jdt, tdt in DTYPES.values():
        want = jax.jit(edges, static_argnums=1)(jnp.asarray(rois), jdt)
        got = troi.bin_edges(torch.from_numpy(rois), 0.25, 7, 20, 24, tdt)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    eager = [np.asarray(e) for e in edges(jnp.asarray(rois), jnp.float32)]
    assert any((np.asarray(w) != e).any() for w, e in zip(want, eager))


def test_roi_pool_max_gradient_matches_reference():
    """float32 gradient through the chunked two-stage route against jax's
    gradient of the one-shot oracle: the cotangent of each bin goes to its
    argmax cell (random maps have no ties), summed where a cell is the max
    of several bins; rtol 1e-6."""
    rng = np.random.default_rng(2)
    f = rng.normal(size=(16, 20, 4)).astype(np.float32)
    rois = _rois(rng, 40, hi=70.0)
    cot = rng.normal(size=(40, 7, 7, 4)).astype(np.float32)
    want = jax.jit(jax.grad(lambda x: (jroi.roi_pool_max(
        x, jnp.asarray(rois), spatial_scale=0.25) * cot).sum()))(
        jnp.asarray(f))
    x = torch.from_numpy(f).requires_grad_(True)
    (troi.roi_pool_max(x, torch.from_numpy(rois), spatial_scale=0.25,
                       max_elements=2000) * torch.from_numpy(cot)
     ).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert (x.grad != 0).any()


def test_roi_pool_max_gradient_splits_ties_as_reference():
    """A map with flat regions (a constant block, as an image's padding
    reads, and a quantized ramp): each bin's cotangent is split evenly over
    all of its cells that equal its max, as the reference's one masked max
    splits it, not per stage; rtol 1e-6."""
    rng = np.random.default_rng(9)
    f = np.round(rng.normal(size=(16, 20, 3)) * 2).astype(np.float32)
    f[8:, 10:] = 1.5
    rois = _rois(rng, 60, hi=70.0)
    cot = rng.normal(size=(60, 7, 7, 3)).astype(np.float32)
    want = jax.jit(jax.grad(lambda x: (jroi.roi_pool_max(
        x, jnp.asarray(rois), spatial_scale=0.25) * cot).sum()))(
        jnp.asarray(f))
    x = torch.from_numpy(f).requires_grad_(True)
    (troi.roi_pool_max(x, torch.from_numpy(rois), spatial_scale=0.25,
                       max_elements=5000) * torch.from_numpy(cot)
     ).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # the flat block's cells share their bins' cotangents
    assert (x.grad[8:, 10:] != 0).sum() > 20


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_multilevel_foveal_roi_features_matches_reference(dtype):
    """exact_max over c3/c4/c5 (strides 4/8/16) and four foveal views
    clipped to the image, levels concatenated: bit for bit."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(3)
    c = 6
    maps = {lv: _feat(rng, (64 // s, 64 // s, c), jdt, tdt) for lv, s in
            (("c3", 4), ("c4", 8), ("c5", 16))}
    scales = {"c3": 0.25, "c4": 0.125, "c5": 0.0625}
    rois = _rois(rng, 24, hi=50.0, size=30.0)
    want = jax.jit(lambda f, r: jroi.multilevel_foveal_roi_features(
        f, r, scales=scales, image_hw=(64, 64), mode="exact_max",
        combine="concat"))({k: v[0] for k, v in maps.items()},
                           jnp.asarray(rois))
    got = troi.multilevel_foveal_roi_features(
        {k: v[1] for k, v in maps.items()}, torch.from_numpy(rois),
        scales=scales, image_hw=(64, 64), mode="exact_max")
    _same(got, want)


# ------------------------------------------------------ windowed route ---

@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_max_pyramid_and_windowed_route_match_reference(dtype):
    """build_pyramid(mode="max") (2x max pooling, _NEG padding) and
    pyramid_roi_align(mode="exact_max") on 300 views at every pyramid
    scale, NaN and inf included: bit for bit; in chunks of 7 views too."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(4)
    jf, tf = _feat(rng, (20, 24, 5), jdt, tdt, nan=True)
    jp = jrp.build_pyramid(jf, 0.25, mode="max")
    tp = trp.build_pyramid(tf, 0.25, mode="max")
    _same(tp.flat, jp.flat)
    for field in ("row_offsets", "heights", "widths"):
        np.testing.assert_array_equal(getattr(tp, field).numpy(),
                                      np.asarray(getattr(jp, field)))
    rois = _rois(rng, 300)
    want = jax.jit(lambda p, r: jrp.pyramid_roi_align(
        p, r, mode="exact_max"))(jp, jnp.asarray(rois))
    for max_elements in (7 * 10 * 16 * 5 * 7, 1 << 27):
        got = trp.pyramid_roi_align(tp, torch.from_numpy(rois),
                                    mode="exact_max",
                                    max_elements=max_elements)
        assert got.dtype == torch.float32
        _same(got, want)


def test_batched_max_pyramid_matches_reference():
    rng = np.random.default_rng(5)
    f = rng.normal(size=(2, 30, 26, 8)).astype(np.float32)
    jflat, _ = jax.jit(lambda x: jrp.build_pyramid_batch(
        x, 0.125, mode="max"))(jnp.asarray(f))
    tflat, tmeta = trp.build_pyramid_batch(torch.from_numpy(f), 0.125,
                                           mode="max")
    _same(tflat, jflat)
    assert tmeta.num_scales == 4


def test_windowed_route_equals_exact_route_on_small_views():
    """Views whose bins span at most one base cell (ROIs up to 7 cells)
    read level 0 of the max pyramid: there the windowed route equals
    roi_pool_max bit for bit (the reference's exactness contract); larger
    views snap bin edges to the coarser scale's cells and may differ."""
    rng = np.random.default_rng(6)
    f = torch.from_numpy(rng.normal(size=(40, 48, 6)).astype(np.float32))
    x1 = rng.uniform(0, 160, 200)
    y1 = rng.uniform(0, 130, 200)
    wh = rng.uniform(1, 28, (200, 2))
    small = torch.from_numpy(np.stack([x1, y1, x1 + wh[:, 0],
                                       y1 + wh[:, 1]], -1).astype(np.float32))
    pyr = trp.build_pyramid(f, 0.25, mode="max")
    exact = troi.roi_pool_max(f, small, spatial_scale=0.25)
    windowed = trp.pyramid_roi_align(pyr, small, mode="exact_max")
    np.testing.assert_array_equal(windowed.numpy(), exact.numpy())
    large = small.clone()
    large[:, 2:] += 60.0
    assert not torch.equal(trp.pyramid_roi_align(pyr, large,
                                                 mode="exact_max"),
                           troi.roi_pool_max(f, large, spatial_scale=0.25))


def test_multilevel_foveal_pyramid_features_matches_reference():
    rng = np.random.default_rng(7)
    maps = {lv: _feat(rng, (64 // s, 64 // s, 4), jnp.float32,
                      torch.float32) for lv, s in
            (("c3", 4), ("c4", 8), ("c5", 16))}
    scales = {"c3": 0.25, "c4": 0.125, "c5": 0.0625}
    rois = _rois(rng, 16, hi=50.0, size=30.0)
    want = jax.jit(lambda f, r: jrp.multilevel_foveal_pyramid_features(
        {lv: jrp.build_pyramid(f[lv], scales[lv], mode="max") for lv in f},
        r, image_hw=(64, 64), mode="exact_max", combine="concat"))(
        {k: v[0] for k, v in maps.items()}, jnp.asarray(rois))
    got = trp.multilevel_foveal_pyramid_features(
        {lv: trp.build_pyramid(v[1], scales[lv], mode="max")
         for lv, v in maps.items()}, torch.from_numpy(rois),
        image_hw=(64, 64), mode="exact_max")
    _same(got, want)


# ------------------------------------------------------------ caffe_bgr ---

def test_caffe_bgr_matches_reference():
    """BGR order, 0-255 minus the Caffe mean pixel in float32, no scale:
    normalize bit for bit. The canvas resize of those pixels within 1e-5
    of the 0-255 range (the rgb_unit resize is held to atol 1e-5 on its
    unit range, tests/test_torch_ops.py), and its scale bit for bit (48 /
    30 is 1.6 on both sides: a true float32 division)."""
    rng = np.random.default_rng(8)
    image = rng.integers(0, 256, (2, 30, 22, 3), dtype=np.uint8)
    got = ttf.normalize(torch.from_numpy(image), "caffe_bgr")
    want = jtf.normalize(image, "caffe_bgr")
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[..., 0].numpy(),
                                  image[..., 2] - np.float32(102.9801))
    src = np.asarray([[30, 22], [24, 20]], np.float32)
    want, want_s = jax.jit(lambda im, hw: jtf.batch_resize_to_canvas(
        im, (48, 48), hw, preprocess="caffe_bgr"))(image, src)
    got, got_s = ttf.batch_resize_to_canvas(
        torch.from_numpy(image), (48, 48), torch.from_numpy(src),
        preprocess="caffe_bgr")
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * 255)
