"""Port parity, the detector's plain align routes: roi_impl="direct" (the
gather-based bilinear roi_align on each level's reduced map, the levels
summed) and "pyramid" (the window sampler over each image's avg pyramids,
the reference's oracle of its kernels), in the fused feature op, the
model's pool_rois, serving (bf16, int8, int8 + SVD, ROIs in chunks of
eval.roi_chunk) and training (train_roi_impl="direct", and "pyramid",
which trains as "direct"), against the JAX package's own functions on the
same numpy inputs at the `tiny` preset. Also the repaired defaults of the
pyramid functions (mode="avg", as the reference's)."""

import dataclasses
import warnings
from functools import partial

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multipathnet_tpu.core.config import preset as jpreset
from multipathnet_tpu.core.mesh import make_mesh
from multipathnet_tpu.data import sampler as jsampler
from multipathnet_tpu.data import transforms as jtf
from multipathnet_tpu.eval import detect as jdetect
from multipathnet_tpu.models.multipath import MultiPathNet as JNet
from multipathnet_tpu.models.multipath import build_model as jbuild
from multipathnet_tpu.ops import quant as jquant
from multipathnet_tpu.ops import roi as jroi
from multipathnet_tpu.ops import roi_pyramid as jrp
from multipathnet_tpu.train import loop as jloop
from multipathnet_tpu_torch.core.config import preset
from multipathnet_tpu_torch.data import sampler as tsampler
from multipathnet_tpu_torch.eval import detect as tdetect
from multipathnet_tpu_torch.models import convert
from multipathnet_tpu_torch.models.multipath import (build_model,
                                                     check_supported)
from multipathnet_tpu_torch.ops import quant as tquant
from multipathnet_tpu_torch.ops import roi as troi
from multipathnet_tpu_torch.ops import roi_pyramid as trp
from multipathnet_tpu_torch.train import loop as tloop

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
LEVELS = (("c3", 4), ("c4", 8), ("c5", 16))
SCALES = {lv: 1.0 / s for lv, s in LEVELS}
B, P = 2, 16


def _feat(rng, shape, dtype):
    """One map in both packages' dtypes, equal values (bf16 through
    float32, which holds every bf16 value)."""
    jdt, tdt = DTYPES[dtype]
    j = jnp.asarray(rng.normal(size=shape).astype(np.float32), jdt)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)


def _rois(rng, shape, hi=50.0, size=30.0):
    """Image-coordinate ROIs on a 64^2 canvas, partly off the map, with an
    all-zero padded row, a zero-width one and one wholly past the map."""
    x1 = rng.uniform(-10, hi, shape)
    y1 = rng.uniform(-10, hi * 0.8, shape)
    w = rng.uniform(0, size, shape)
    h = rng.uniform(0, size, shape)
    rois = np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)
    flat = rois.reshape(-1, 4)
    flat[:3] = [[0, 0, 0, 0], [20, 8, 20, 30], [400, 400, 420, 430]]
    return rois


def _close(got, want):
    """float32 outputs within 1e-5 x max(1, max |want|)."""
    want = np.asarray(want, np.float32)
    got = got.numpy()
    assert got.shape == want.shape
    tol = 1e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


# ------------------------------------------------ the fused feature op ---

@pytest.mark.parametrize("combine", ["concat", "sum"])
@pytest.mark.parametrize("mode", ["avg", "max", "exact_max"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_multilevel_foveal_roi_features_matches_reference(dtype, mode,
                                                          combine):
    """Every mode x combine on c3/c4/c5 of one 64^2 image, four foveal
    views clipped to it. The bilinear modes return float32 (a bf16 map
    times float32 weights, as jnp promotes it), within 1e-5 x max;
    exact_max keeps the map's dtype and is bit-equal, its bf16 level sum
    included. The port's ROIs go in chunks of 5 (max_elements), the
    reference's in one pass."""
    rng = np.random.default_rng(3)
    maps = {lv: _feat(rng, (64 // s, 64 // s, 6), dtype) for lv, s in LEVELS}
    rois = _rois(rng, (24,))
    kw = dict(scales=SCALES, image_hw=(64, 64), samples_per_bin=2,
              mode=mode, combine=combine)
    want = jax.jit(lambda f, r: jroi.multilevel_foveal_roi_features(
        f, r, **kw))({k: v[0] for k, v in maps.items()}, jnp.asarray(rois))
    got = troi.multilevel_foveal_roi_features(
        {k: v[1] for k, v in maps.items()}, torch.from_numpy(rois),
        max_elements=5 * 14 * 14 * 6 * 7, **kw)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    if mode == "exact_max":
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
    else:
        _close(got, want)


def test_multilevel_foveal_roi_features_defaults_match_reference():
    """Called with the defaults (mode="avg", combine="concat", S = 2,
    no image clip) on both sides."""
    rng = np.random.default_rng(4)
    maps = {lv: _feat(rng, (64 // s, 64 // s, 5), "float32")
            for lv, s in LEVELS}
    rois = _rois(rng, (12,))
    want = jax.jit(lambda f, r: jroi.multilevel_foveal_roi_features(
        f, r, scales=SCALES))({k: v[0] for k, v in maps.items()},
                              jnp.asarray(rois))
    got = troi.multilevel_foveal_roi_features(
        {k: v[1] for k, v in maps.items()}, torch.from_numpy(rois),
        scales=SCALES)
    assert got.shape == (4, 12, 7, 7, 15)
    _close(got, want)


def test_multilevel_foveal_roi_features_rejects_unknown_options():
    f = {"c5": torch.zeros(4, 4, 2)}
    rois = torch.zeros(1, 4)
    with pytest.raises(ValueError, match="mode"):
        troi.multilevel_foveal_roi_features(f, rois, scales=SCALES,
                                            mode="median")
    with pytest.raises(ValueError, match="combine"):
        troi.multilevel_foveal_roi_features(f, rois, scales=SCALES,
                                            combine="mean")


def test_batched_roi_align_chunks_equal_one_pass():
    """ROIs in chunks (max_elements of two ROIs' samples, then of 3) give
    the one-pass forward bit for bit. The gradient sums the chunks'
    scatters in chunk order, so it equals the one-pass gradient within
    1e-6 x max, and each chunking repeats its own bit for bit."""
    gen = torch.Generator().manual_seed(0)
    feat = torch.randn(2, 16, 12, 3, generator=gen)
    rois = torch.from_numpy(_rois(np.random.default_rng(2), (2, 7)))
    cot = torch.randn(2, 7, 7, 7, 3, generator=gen)

    def run(max_elements):
        x = feat.clone().requires_grad_(True)
        out = troi.batched_roi_align(x, rois, spatial_scale=0.25,
                                     max_elements=max_elements)
        (out * cot).sum().backward()
        return out.detach(), x.grad

    one_out, one_grad = run(1 << 27)
    for max_elements in (2 * 2 * 14 * 14 * 3, 3 * 2 * 14 * 14 * 3):
        out, grad = run(max_elements)
        assert torch.equal(out, one_out)
        torch.testing.assert_close(grad, one_grad, rtol=0,
                                   atol=1e-6 * float(one_grad.abs().max()))
        assert torch.equal(run(max_elements)[1], grad)


# ----------------------------------------------- the repaired defaults ---

def test_pyramid_functions_default_to_avg_as_reference():
    """pyramid_roi_align and multilevel_foveal_pyramid_features called
    with their default arguments on avg pyramids equal the reference's
    default (mode="avg") calls within 1e-6 x max (the window contractions
    sum in another order), and differ from the exact_max route."""
    rng = np.random.default_rng(5)
    maps = {lv: _feat(rng, (64 // s, 64 // s, 4), "float32")
            for lv, s in LEVELS}
    rois = _rois(rng, (20,))
    jpyr = {lv: jrp.build_pyramid(v[0], SCALES[lv]) for lv, v in maps.items()}
    tpyr = {lv: trp.build_pyramid(v[1], SCALES[lv]) for lv, v in maps.items()}
    want_one = jax.jit(jrp.pyramid_roi_align)(jpyr["c4"], jnp.asarray(rois))
    got_one = trp.pyramid_roi_align(tpyr["c4"], torch.from_numpy(rois))
    want = jax.jit(jrp.multilevel_foveal_pyramid_features)(
        jpyr, jnp.asarray(rois))
    got = trp.multilevel_foveal_pyramid_features(tpyr,
                                                 torch.from_numpy(rois))
    for g, w in ((got_one, want_one), (got, want)):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-6 * np.abs(w).max())
    exact = trp.pyramid_roi_align(trp.build_pyramid(
        maps["c4"][1], SCALES["c4"], mode="max"), torch.from_numpy(rois),
        mode="exact_max")
    assert not torch.allclose(got_one, exact)


# ----------------------------------------------------- MultiPathNet ---

def _cfg(make_preset, dtype="float32", **model):
    cfg = make_preset("tiny")
    return cfg.replace(model=dataclasses.replace(cfg.model, dtype=dtype,
                                                 **model))


def _random_tree(jmodel, seed=7):
    """A float tree for jmodel from numpy `seed`, scores spread out."""
    shapes = jax.eval_shape(
        jmodel.init, jax.random.key(0), jnp.zeros((1, 64, 64, 3)),
        jnp.asarray([[[0.0, 0.0, 16.0, 16.0]]]))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            fan_in = int(np.prod(s.shape[:-1]))
            gain = 8.0 if "cls_bbox" in name else 2.0  # spread the scores
            return (rng.normal(size=s.shape) * np.sqrt(gain / fan_in)
                    ).astype(np.float32)
        return (rng.normal(size=s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _pooled_pair(impl, topology, dtype, seed=0):
    """Both sides' pool_rois on one set of reduced maps (B = 2 images of
    64^2, C = 32) and ROIs -> (port, reference)."""
    jcfg = _cfg(jpreset, dtype, roi_impl=impl, foveal_topology=topology)
    tcfg = _cfg(preset, dtype, roi_impl=impl, foveal_topology=topology)
    jmodel = jbuild(jcfg.model)
    params = _random_tree(jmodel)
    rng = np.random.default_rng(seed)
    c = tcfg.model.skip_reduce_dim
    maps = {lv: _feat(rng, (B, 64 // s, 64 // s, c), dtype)
            for lv, s in LEVELS}
    rois = _rois(rng, (B, P))
    want = jax.jit(lambda p, f, r: jmodel.apply(
        p, f, r, (64, 64), method=JNet.pool_rois))(
        params, {k: v[0] for k, v in maps.items()}, jnp.asarray(rois))
    tmodel = build_model(tcfg.model, device="cpu")
    with torch.no_grad():
        got = tmodel.pool_rois({k: v[1] for k, v in maps.items()},
                               torch.from_numpy(rois), (64, 64))
    return got, want, tmodel


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("topology", ["reference", "dense"])
@pytest.mark.parametrize("impl", ["direct", "pyramid"])
def test_pool_rois_matches_reference(impl, topology, dtype):
    """MultiPathNet.pool_rois under roi_impl "direct" and "pyramid", both
    foveal topologies, on float32 and bf16 maps: (B, F, R, G, G, C)
    float32 on both sides, within 1e-5 x max."""
    got, want, tmodel = _pooled_pair(impl, topology, dtype)
    assert tmodel.roi_route() == impl
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert got.shape == (B, 4, P, 7, 7, 32)
    _close(got, want)


def test_pyramid_route_differs_from_direct():
    """The two plain routes are other algorithms: equal on the small
    views that sample the base scale, apart where a view reads a pooled
    scale of its pyramid."""
    direct, _, _ = _pooled_pair("direct", "reference", "float32")
    pyramid, _, _ = _pooled_pair("pyramid", "reference", "float32")
    assert not torch.allclose(direct, pyramid, atol=1e-3)


def test_check_supported_and_quant_bias_rules():
    """An unknown roi_impl or train_roi_impl raises in both modes; the
    int8 pool epilogue (quant_bias) raises on every route but the
    kernels, as the reference's assert does."""
    for mode in ("align", "max"):
        for field in ("roi_impl", "train_roi_impl"):
            cfg = _cfg(preset, roi_mode=mode, **{field: "gather"})
            with pytest.raises(ValueError, match="unknown roi_impl"):
                check_supported(cfg.model)
    for impl in ("direct", "pyramid"):
        model = build_model(_cfg(preset, roi_impl=impl).model, device="cpu")
        feats = {lv: torch.zeros(1, 64 // s, 64 // s, 32) for lv, s in LEVELS}
        rois = torch.tensor([[[0.0, 0.0, 16.0, 16.0]]])
        with pytest.raises(ValueError, match="int8 pool epilogue"):
            model.pool_rois_quantized(feats, rois, (64, 64),
                                      model.head.skip_bias)
    routes = {(impl, train): build_model(_cfg(
        preset, roi_impl=impl, train_roi_impl=impl).model,
        device="cpu").roi_route(train)
        for impl in ("auto", "pallas", "direct", "pyramid")
        for train in (False, True)}
    assert routes == {("auto", False): "kernels", ("auto", True): "kernels",
                      ("pallas", False): "kernels",
                      ("pallas", True): "kernels",
                      ("direct", False): "direct", ("direct", True): "direct",
                      ("pyramid", False): "pyramid",
                      ("pyramid", True): "direct"}


# ------------------------------------------------------------ serving ---

def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (B, 48, 56, 3), dtype=np.uint8)
    src_hws = np.asarray([[48, 56], [40, 50]], np.float32)
    x1 = rng.uniform(0, 34, (B, P))
    y1 = rng.uniform(0, 28, (B, P))
    w = rng.uniform(4, 22, (B, P))
    h = rng.uniform(4, 20, (B, P))
    proposals = np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)
    prop_mask = np.ones((B, P), bool)
    prop_mask[1, -3:] = False
    return images, src_hws, proposals, prop_mask


SERVING = {"bf16": ("bfloat16", "none", 0, 0),
           "int8": ("float32", "int8", 0, 0),
           "int8_svd": ("float32", "int8", 16, 8)}


@pytest.mark.parametrize("form", sorted(SERVING))
def test_direct_serving_matches_reference(form):
    """score_batch and detect_batch with roi_impl="direct" and
    eval.roi_chunk = 6 < P = 16 (three chunks, the last padded): bf16,
    int8 and int8 + SVD, each side's Detector transforming one float tree
    at load. The int8 heads quantize their own pooled rows on this route
    (no pool epilogue) on both sides. Tolerances: bf16 probabilities
    within 2e-3 and boxes 5e-2 px (a float32 pooled value an ulp apart
    can round to another bf16 in the head); int8 the same (a flipped code
    moves a score by one code step, tests/test_torch_detect.py)."""
    dtype, quant, r6, r7 = SERVING[form]

    def make(make_preset):
        cfg = _cfg(make_preset, dtype, roi_impl="direct", head_quant=quant,
                   fc6_rank=r6, fc7_rank=r7)
        return cfg.replace(eval=dataclasses.replace(cfg.eval, roi_chunk=6))

    jcfg, tcfg = make(jpreset), make(preset)
    params = _random_tree(jbuild(dataclasses.replace(
        jcfg.model, head_quant="none", fc6_rank=0, fc7_rank=0)))
    jmodel = jbuild(jcfg.model)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # random weights: a flat spectrum
        jparams = (jdetect.Detector(jmodel, params, jcfg).params
                   if quant != "none" else params)
        tdet = tdetect.Detector(build_model(tcfg.model, device="cpu"), tcfg,
                                params=params)
    images, src_hws, proposals, prop_mask = _inputs()
    want_b, want_p = jax.jit(partial(jdetect.score_batch, model=jmodel,
                                     cfg=jcfg))(
        jparams, images_u8=images, src_hws=src_hws, proposals=proposals)
    got_b, got_p = tdetect.score_batch(
        tdet.model, tcfg, *(torch.from_numpy(x) for x in
                            (images, src_hws, proposals)))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=2e-3)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), atol=5e-2)
    # the scores spread well past the tolerance (the rank-16/8 head's
    # least: a std of 0.035)
    assert np.asarray(want_p).std() > 0.02
    want = jax.jit(lambda p, *a: jdetect.detect_batch(p, jmodel, jcfg, *a))(
        jparams, images, src_hws, proposals, prop_mask)
    got = tdet(images, src_hws, proposals, prop_mask)
    np.testing.assert_array_equal(got["valid"], np.asarray(want["valid"]))
    assert got["valid"].any()
    np.testing.assert_allclose(got["scores"], np.asarray(want["scores"]),
                               atol=2e-3)


def test_chunked_scores_equal_one_pass():
    """roi_chunk only splits the work: chunks of 6 (padded to 18) give
    the scores of one pass (roi_chunk >= P) bit for bit."""
    tcfg = _cfg(preset, roi_impl="direct")
    model = convert.load_flax_params(build_model(tcfg.model, device="cpu"),
                                     _random_tree(jbuild(_cfg(
                                         jpreset).model))).eval()
    args = [torch.from_numpy(x) for x in _inputs()[:3]]
    runs = [tdetect.score_batch(model, tcfg.replace(eval=dataclasses.replace(
        tcfg.eval, roi_chunk=n)), *args) for n in (6, 64)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_int8_codes_equal_where_pooled_rows_equal():
    """The int8 head's input stage on the direct route, bf16: each side
    adds the skip bias to its own pooled rows in the head dtype, applies
    ReLU and quantizes per (image, view, ROI) row. Wherever the two
    sides' rows are equal the codes and scales are equal bit for bit;
    most rows are equal."""
    got, want, tmodel = _pooled_pair("direct", "reference", "bfloat16",
                                     seed=1)
    bias = np.random.default_rng(2).normal(size=32).astype(np.float32) * 0.1
    jb = jnp.asarray(bias, jnp.bfloat16)
    x_j = jax.nn.relu(want.astype(jnp.bfloat16) + jb).reshape(B, 4, P, -1)
    x_t = torch.relu(got.to(torch.bfloat16) + torch.from_numpy(
        np.array(jb.astype(jnp.float32))).to(torch.bfloat16)).reshape(
        B, 4, P, -1)
    q_j, s_j = jax.jit(jquant.quantize_rows)(x_j)
    q_t, s_t = tquant.quantize_rows(x_t)
    rows = (x_t.float().numpy() == np.asarray(x_j.astype(jnp.float32))
            ).all(-1)
    assert rows.mean() > 0.5
    np.testing.assert_array_equal(q_t.numpy()[rows], np.asarray(q_j)[rows])
    np.testing.assert_array_equal(s_t.numpy()[rows], np.asarray(s_j)[rows])


# ----------------------------------------------------------- training ---

def _batch(rng, cfg):
    h, w = cfg.data.image_size
    images = rng.integers(0, 256, (B, h - 4, w, 3), dtype=np.uint8)
    src_hws = np.asarray([[h - 4, w], [h - 14, w - 23]], np.float32)
    g = cfg.data.max_gt_per_image
    xy = rng.uniform(0, 40, (B, g, 2))
    wh = rng.uniform(8, 24, (B, g, 2))
    gt = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    classes = rng.integers(1, 5, (B, g)).astype(np.int32)
    gt_mask = np.arange(g)[None, :] < np.asarray([5, 3])[:, None]
    p = cfg.data.max_proposals
    near = gt[np.arange(B)[:, None], rng.integers(0, g, (B, p // 2))]
    near = near + rng.normal(0, 3.0, near.shape).astype(np.float32)
    pxy = rng.uniform(0, 50, (B, p - p // 2, 2))
    pwh = rng.uniform(4, 24, (B, p - p // 2, 2))
    props = np.concatenate(
        [near, np.concatenate([pxy, pxy + pwh], -1)], 1).astype(np.float32)
    prop_mask = np.ones(props.shape[:2], bool)
    prop_mask[-1, -4:] = False
    return tloop.Batch(images, src_hws, props, prop_mask, gt, classes,
                       gt_mask)


def _no_flip(cfg):
    return cfg.replace(data=dataclasses.replace(cfg.data, hflip_prob=0.0))


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5),
                                        ("bfloat16", 1e-2)])
def test_direct_train_step_matches_reference_trainer(dtype, rtol,
                                                     monkeypatch):
    """The port's Trainer with train_roi_impl="direct" against the
    reference's own Trainer on its default config, which trains through
    the direct roi_align off the TPU: one step from the reference's
    initial parameters, the sample injected into both sides, no flips,
    dropout off. Loss and metrics within rel `rtol` (float32 1e-5; bf16
    1e-2, where the trunk's bf16 roundings differ in order)."""
    jcfg = _no_flip(_cfg(jpreset, dtype))
    tcfg = _no_flip(_cfg(preset, dtype, train_roi_impl="direct"))
    rng = np.random.default_rng(6)
    batch = _batch(rng, tcfg)
    d, m = jcfg.data, jcfg.model
    canvases, scales = jax.jit(lambda im, hw: jtf.batch_resize_to_canvas(
        im, d.image_size, hw))(batch.images, batch.src_hws)
    s = np.asarray(scales)[:, None, None]
    sample = jax.jit(lambda *a: jsampler.sample_batch(
        jax.random.key(9), *a, rois_per_image=d.rois_per_image,
        fg_fraction=d.fg_fraction, fg_iou_threshold=d.fg_iou_threshold,
        bg_iou_range=d.bg_iou_range, bbox_reg_means=m.bbox_reg_means,
        bbox_reg_stds=m.bbox_reg_stds))(
        batch.proposals * s, batch.prop_mask, batch.gt_boxes * s,
        batch.gt_classes, batch.gt_mask)
    monkeypatch.setattr(jsampler, "sample_batch", lambda *a, **k: sample)
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    jtrainer = jloop.Trainer(jcfg, mesh=make_mesh(n_data=1))
    assert jtrainer.cfg.model.train_roi_impl == "direct"
    jstate = jtrainer.init_state(0)
    params = jax.tree.map(np.asarray, jstate.params)
    _, want = jtrainer.step(jstate, jloop.Batch(*batch))

    tsample = tsampler.RoiSample(*(torch.from_numpy(np.array(x))
                                   for x in sample))
    monkeypatch.setattr(tsampler, "sample_batch", lambda *a, **k: tsample)
    trainer = tloop.Trainer(tcfg, device="cpu")
    state = trainer.init_state(0)
    convert.load_flax_params(trainer.model, params)
    trainer.model.head.dropout_rate = 0.0
    _, got = trainer.step(state, batch)
    assert set(got) == set(want)
    assert float(got["num_fg"]) > 0
    for name in want:
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=rtol, atol=1e-6, err_msg=name)


def test_pyramid_trains_as_direct():
    """train_roi_impl="pyramid" trains through the direct route, as the
    reference maps it: the same step bit for bit (loss, every gradient
    and parameter), dropout and sampling drawn from the same seed."""
    batch = _batch(np.random.default_rng(8), preset("tiny"))
    runs = []
    for impl in ("direct", "pyramid"):
        trainer = tloop.Trainer(_cfg(preset, train_roi_impl=impl),
                                device="cpu")
        _, metrics = trainer.step(trainer.init_state(0), batch)
        runs.append((metrics["loss"], {
            n: (p.detach().clone(), p.grad)
            for n, p in trainer.model.named_parameters()}))
    (loss_a, a), (loss_b, b) = runs
    assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(a[n][0], b[n][0]) and torch.equal(a[n][1],
                                                             b[n][1])
               for n in a)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_direct_train_step_repeats_from_a_snapshot(dtype):
    """Two direct-route steps from one saved state give equal loss and
    parameters, bit for bit (gather_rows' fixed-order backward)."""
    cfg = _cfg(preset, dtype, train_roi_impl="direct")
    batch = _batch(np.random.default_rng(9), cfg)
    trainer = tloop.Trainer(cfg, device="cpu")
    state, _ = trainer.step(trainer.init_state(0), batch)
    saved = tloop.snapshot_train_state(trainer, state)
    runs = []
    for _ in range(2):
        state = tloop.restore_train_state(trainer, saved)
        _, metrics = trainer.step(state, batch)
        runs.append((metrics["loss"], {
            n: p.detach().clone()
            for n, p in trainer.model.named_parameters()}))
    (loss_a, a), (loss_b, b) = runs
    assert torch.equal(loss_a, loss_b)
    assert all(torch.equal(a[n], b[n]) for n in a)
