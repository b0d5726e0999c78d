"""Port parity, BASELINE configs 1 and 2 and the "dense" foveal topology,
at the `tiny` preset's depth and widths with each configuration's
structural fields taken from its preset:

  - `fastrcnn_vgg16_single` (config 1): one view (1x), one level (c5), one
    integral head (threshold 0.5), batch 1. Eval pools its one group
    through K2 (roi_pool.batched_pyramid_pool_resident), training through
    K1 at L = 1 (WindowPoolMulti);
  - `multipath_vgg16_b1` (config 2): the reference topology at batch 1 (K1
    over the 1x view x c3/c4/c5, K2 over the context views x c5);
  - "dense": `multipath_vgg16_batched` with foveal_topology="dense", every
    view over every level (12 windows a ROI), one K1 group of 4 views x 3
    levels, at 2 images.

The inputs and weights come from numpy seeds. The JAX side runs
roi_impl="pallas" and train_roi_impl="pallas" (its Pallas kernels in
interpret mode on the CPU), the port its kernel route (their plain
versions on the CPU). Also the port's K2 route against the reference's
K1-at-L = 1 route on single-level groups whose per-image pyramid passes
the reference's 4 MB resident budget, and the weight paths (convert,
the head contract, serving transforms, bundles) of a c5-only model with
one branch and one integral head."""

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
from multipathnet_tpu.data import sampler as jsampler
from multipathnet_tpu.data import transforms as jtf
from multipathnet_tpu.eval import detect as jdetect
from multipathnet_tpu.models import import_weights as JIW
from multipathnet_tpu.models.multipath import MultiPathNet as JNet
from multipathnet_tpu.models.multipath import build_model as jbuild
from multipathnet_tpu.ops import roi_pallas as jroi_pallas
from multipathnet_tpu.train import loop as jloop
from multipathnet_tpu.train import schedule as jschedule
from multipathnet_tpu_torch.core.config import preset
from multipathnet_tpu_torch.data import sampler as tsampler
from multipathnet_tpu_torch.eval import detect as tdetect
from multipathnet_tpu_torch.eval import serving
from multipathnet_tpu_torch.models import convert
from multipathnet_tpu_torch.models import import_weights as IW
from multipathnet_tpu_torch.models.multipath import build_model
from multipathnet_tpu_torch.ops import roi_pool, roi_pyramid
from multipathnet_tpu_torch.train import loop as tloop

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
CONFIGS = ("fastrcnn_vgg16_single", "multipath_vgg16_b1", "dense")
# images a batch: the preset's own for configs 1 and 2; two for dense (the
# batched preset's 8 cut to keep the interpreted kernels quick)
DENSE_BATCH = 2
P = 16   # proposals an image
# the reference's resident budget (multipathnet_tpu/models/multipath.py:204)
RESIDENT_BUDGET = 4 * 1024 * 1024


def _t(x):
    """A jax or numpy array as a torch tensor (bf16 through float32, which
    holds every bf16 value exactly)."""
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(np.array(a))


def _structure(make_preset, name):
    """-> (model field overrides, batch) of a configuration, read from its
    preset in either package."""
    src = make_preset("multipath_vgg16_batched" if name == "dense" else name)
    m = src.model
    model = dict(foveal_scales=m.foveal_scales, skip_levels=m.skip_levels,
                 integral_thresholds=m.integral_thresholds,
                 foveal_topology="dense" if name == "dense"
                 else m.foveal_topology)
    return model, DENSE_BATCH if name == "dense" else src.train.batch_size


def _cfg(make_preset, name, dtype="float32", **model):
    """`tiny` with the configuration's structure, the kernel routes, and
    its batch as the train batch size."""
    struct, batch = _structure(make_preset, name)
    cfg = make_preset("tiny")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, dtype=dtype, roi_impl="pallas",
                                  train_roi_impl="pallas",
                                  **{**struct, **model}),
        train=dataclasses.replace(cfg.train, batch_size=batch))


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


def _rois(rng, b, r=P, canvas=64):
    """Image-coordinate ROIs on a canvas: most inside it, some over its
    border (the context views clip there), one tiny."""
    x1 = rng.uniform(-6, canvas * 0.8, (b, r))
    y1 = rng.uniform(-6, canvas * 0.75, (b, r))
    w = rng.uniform(3, canvas * 0.45, (b, r))
    h = rng.uniform(3, canvas * 0.45, (b, r))
    rois = np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)
    rois[:, 0] = [10.0, 12.0, 11.0, 12.5]
    return rois


BF16_POOL_SHARE = 1e-4


def _assert_bf16_pool_close(got, want, share=BF16_POOL_SHARE):
    """bf16 pooled values: at most `share` of them differ from the
    reference's, each by at most one bf16 step at the larger of the two
    magnitudes or, where a bin's sum cancels to a small value, 1/256 of
    the largest pooled magnitude (tests/test_torch_quant.py's rule).
    Returns the number that differ."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
    step = torch.maximum(torch.ldexp(torch.ones_like(got), e - 8),
                         want.abs().max() / 256)
    n = int((diff > 0).sum())
    assert bool((diff <= step).all()), float(diff.max())
    assert n <= share * got.numel(), (n, got.numel())
    return n


def _assert_pool_close(got, want, dtype):
    """float32 within 1e-5 x max(1, max |want|); bf16 by
    _assert_bf16_pool_close."""
    want = _t(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if dtype == "bfloat16":
        return _assert_bf16_pool_close(got, want)
    tol = 1e-5 * max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, rtol=0, atol=tol)
    return int((got != want).sum())


class _Routes:
    """Records the port's pool entry points that MultiPathNet.pool_rois
    calls: ("resident", 1) for K2, ("multi", L) for K1 over L levels."""

    def __init__(self, monkeypatch):
        self.calls = []
        resident = roi_pool.batched_pyramid_pool_resident
        multi = roi_pool.batched_pyramid_pool_multi

        def rec_resident(*a, **k):
            self.calls.append(("resident", 1))
            return resident(*a, **k)

        def rec_multi(flats, *a, **k):
            self.calls.append(("multi", len(flats)))
            return multi(flats, *a, **k)

        monkeypatch.setattr(roi_pool, "batched_pyramid_pool_resident",
                            rec_resident)
        monkeypatch.setattr(roi_pool, "batched_pyramid_pool_multi",
                            rec_multi)


# each configuration's pool groups in eval and in training
EVAL_ROUTES = {"fastrcnn_vgg16_single": [("resident", 1)],
               "multipath_vgg16_b1": [("multi", 3), ("resident", 1)],
               "dense": [("multi", 3)]}
TRAIN_ROUTES = {"fastrcnn_vgg16_single": [("multi", 1)],
                "multipath_vgg16_b1": [("multi", 3), ("multi", 1)],
                "dense": [("multi", 3)]}


# ------------------------------------------------------- the structure ---

def test_presets_carry_the_configurations():
    """Both packages' presets carry BASELINE configs 1 and 2's structure
    (config 1: one 1x view, c5 only, one integral head, batch 1; config
    2: the reference topology at batch 1), and each package's view x
    level plan for the three configurations is the other's."""
    for make_preset in (jpreset, preset):
        c1 = make_preset("fastrcnn_vgg16_single")
        assert (c1.model.foveal_scales, c1.model.skip_levels,
                c1.model.integral_thresholds, c1.train.batch_size) == (
            (1.0,), ("c5",), (0.5,), 1)
        c2 = make_preset("multipath_vgg16_b1")
        assert (c2.model.foveal_scales, c2.model.skip_levels,
                c2.model.foveal_topology, c2.train.batch_size) == (
            (1.0, 1.5, 2.0, 4.0), ("c3", "c4", "c5"), "reference", 1)
    plans = {}
    for name in CONFIGS:
        want = jbuild(_cfg(jpreset, name).model)._view_level_plan()
        got = build_model(_cfg(preset, name).model,
                          device="cpu")._view_level_plan()
        assert [tuple(map(tuple, g)) for g in got] == [
            tuple(map(tuple, g)) for g in want], name
        plans[name] = got
    assert plans["fastrcnn_vgg16_single"] == [((1.0,), ("c5",))]
    assert plans["dense"] == [((1.0, 1.5, 2.0, 4.0), ("c3", "c4", "c5"))]
    assert len(plans["multipath_vgg16_b1"]) == 2


# ------------------------------------------------------------ pool_rois ---

def _maps(rng, cfg, b, dtype, canvas=64, c=None):
    """Reduced maps of each skip level, (B, canvas / stride, ..., C), in
    both packages' dtypes with equal values."""
    jdt, tdt = DTYPES[dtype]
    c = c or cfg.model.skip_reduce_dim
    strides = {"c3": 4, "c4": 8, "c5": 16}
    out = {}
    for lv in cfg.model.skip_levels:
        s = canvas // strides[lv]
        j = jnp.asarray(rng.normal(size=(b, s, s, c)).astype(np.float32),
                        jdt)
        out[lv] = (j, torch.from_numpy(np.array(j.astype(jnp.float32)))
                   .to(tdt))
    return out


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", CONFIGS)
def test_pool_rois_matches_reference(name, dtype, monkeypatch):
    """MultiPathNet.pool_rois on one set of reduced maps and ROIs (64^2
    canvas, C = 32): the port's kernel route against the reference's
    Pallas route in interpret mode. float32 within 1e-5 x max, bf16 within
    one bf16 step in at most 1e-4 of the values. The port sends each
    group to the entry point the configuration names (EVAL_ROUTES)."""
    jcfg, tcfg = _cfg(jpreset, name, dtype), _cfg(preset, name, dtype)
    b = tcfg.train.batch_size
    jmodel = jbuild(jcfg.model)
    params = _random_tree(jmodel)
    rng = np.random.default_rng(1)
    maps = _maps(rng, tcfg, b, dtype)
    rois = _rois(rng, b)
    want = jax.jit(lambda p, f, r: jmodel.apply(
        p, f, r, (64, 64), method=JNet.pool_rois))(
        params, {k: v[0] for k, v in maps.items()}, jnp.asarray(rois))
    tmodel = build_model(tcfg.model, device="cpu")
    routes = _Routes(monkeypatch)
    with torch.no_grad():
        got = tmodel.pool_rois({k: v[1] for k, v in maps.items()},
                               torch.from_numpy(rois), (64, 64))
    assert routes.calls == EVAL_ROUTES[name]
    assert got.shape == (b, len(tcfg.model.foveal_scales), P, 7, 7, 32)
    _assert_pool_close(got, want, dtype)
    assert float(got.float().abs().max()) > 0.1


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_dense_pool_rois_quantized_matches_reference(dtype):
    """The dense topology's int8 pool (K1 over 4 views x 3 levels with the
    epilogue: the skip bias, ReLU, one int8 scale a view), as the dense
    `multipath_vgg16_int8` runs it. The reference's own pooled output
    through the port's plain epilogue equals its pool_rois_quantized bit
    for bit (the reference's bit rules). The port's whole quantized pool
    against the reference's, as tests/test_torch_quant.py holds them:
    codes within 1 in at most 1e-4 of them; scales rtol 1e-6 in float32,
    2^-7 in bf16 (amax / 127 of values one bf16 step apart)."""
    jcfg = _cfg(jpreset, "dense", dtype, head_quant="int8")
    tcfg = _cfg(preset, "dense", dtype, head_quant="int8")
    b = tcfg.train.batch_size
    jmodel = jbuild(jcfg.model)
    float_model = jbuild(dataclasses.replace(jcfg.model, head_quant="none"))
    rng = np.random.default_rng(2)
    maps = _maps(rng, tcfg, b, dtype)
    rois = _rois(rng, b)
    bias = rng.normal(size=32).astype(np.float32) * 0.5
    jb = jnp.asarray(bias, DTYPES[dtype][0])
    jmaps = {k: v[0] for k, v in maps.items()}
    params = _random_tree(float_model)
    pooled = jax.jit(lambda p, f, r: float_model.apply(
        p, f, r, (64, 64), method=JNet.pool_rois))(params, jmaps, rois)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        qparams = jdetect.Detector(jmodel, params, jcfg).params
    pq, ps = jax.jit(lambda p, f, r, bi: jmodel.apply(
        p, f, r, (64, 64), bi, method=JNet.pool_rois_quantized))(
        qparams, jmaps, rois, jb)
    n = b * 4 * P
    q, s = roi_pool.quant_view_ref(_t(pooled).reshape(n, 7, 7, 32), _t(jb))
    np.testing.assert_array_equal(q.reshape(pq.shape).numpy(),
                                  np.asarray(pq))
    np.testing.assert_array_equal(s.reshape(ps.shape).numpy(),
                                  np.asarray(ps))
    assert np.asarray(pq).any()

    tmodel = build_model(tcfg.model, device="cpu")
    with torch.no_grad():
        got_q, got_s = tmodel.pool_rois_quantized(
            {k: v[1] for k, v in maps.items()}, torch.from_numpy(rois),
            (64, 64), _t(jb))
    assert got_q.dtype == torch.int8 and got_q.shape == pq.shape
    assert got_s.shape == ps.shape == (b, 4, P, 1)
    diff = np.abs(got_q.numpy().astype(np.int32) - np.asarray(pq, np.int32))
    assert diff.max() <= 1 and diff.mean() <= BF16_POOL_SHARE
    np.testing.assert_allclose(
        got_s.numpy(), np.asarray(ps), atol=0,
        rtol=2 ** -7 if dtype == "bfloat16" else 1e-6)


# ---------------------------------------------- score_batch, detect_batch ---

def _inputs(b, seed=0):
    """uint8 images of 48 x 56 (valid extents up to that) and P proposals
    an image in their coordinates; the last three of image 1 masked."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (b, 48, 56, 3), dtype=np.uint8)
    src_hws = np.asarray([[48, 56], [40, 50]][:b], np.float32)
    x1 = rng.uniform(0, 34, (b, P))
    y1 = rng.uniform(0, 28, (b, P))
    w = rng.uniform(4, 22, (b, P))
    h = rng.uniform(4, 20, (b, P))
    proposals = np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)
    prop_mask = np.ones((b, P), bool)
    prop_mask[-1, -3:] = False
    return images, src_hws, proposals, prop_mask


_PAIRS = {}


def _pair(name, dtype):
    """(jax model, params, cfg) and (torch eval model, cfg) on one tree,
    built once per configuration and dtype."""
    key = (name, dtype)
    if key not in _PAIRS:
        jcfg, tcfg = _cfg(jpreset, name, dtype), _cfg(preset, name, dtype)
        jmodel = jbuild(jcfg.model)
        params = _random_tree(jmodel)
        tmodel = convert.load_flax_params(
            build_model(tcfg.model, device="cpu"), params).eval()
        _PAIRS[key] = (jmodel, params, jcfg), (tmodel, tcfg)
    return _PAIRS[key]


# bf16 and int8 serving: a pooled value one bf16 step apart (the bf16
# pool's rule), or an int8 code one apart (a float32 pooled sum one ULP
# apart at a rounding tie), moves its proposal's scores past rtol 1e-5. In
# those forms at least CLOSE_SHARE of the proposals (detections) are held
# to rtol 1e-5 and every one to PROB_OFF and BOX_OFF (px); seen on dense
# bf16: 2 of 32 proposals past rtol 1e-5, by up to 3.4e-4, and on dense
# int8 one, by 2.3e-3.
CLOSE_SHARE, PROB_OFF, BOX_OFF = 0.75, 5e-3, 5e-2


def _assert_close_rows(got, want, rtol, atol, off=None):
    """got/want (B, N, ...): every row (b, n) within rtol and atol, or,
    given `off`, at least CLOSE_SHARE of the rows so and every value
    within atol `off`."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if off is None:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
        return
    close = np.abs(got - want) <= atol + rtol * np.abs(want)
    rows = close.reshape(*close.shape[:2], -1).all(-1)
    assert rows.mean() >= CLOSE_SHARE, rows
    np.testing.assert_allclose(got, want, rtol=0, atol=off)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", CONFIGS)
def test_score_batch_matches_reference(name, dtype):
    """Images and proposals -> class probabilities and boxes at the
    configuration's batch: probabilities rtol 1e-5, boxes within 1e-3 px.
    In bf16 that holds for at least CLOSE_SHARE of the proposals and the
    rest are held to PROB_OFF and BOX_OFF (a pooled value one bf16 step
    apart). With one integral head (config 1) the mean of the K softmaxes
    is the one softmax."""
    (jmodel, params, jcfg), (tmodel, tcfg) = _pair(name, dtype)
    images, src_hws, proposals, _ = _inputs(tcfg.train.batch_size)
    want_b, want_p = jax.jit(partial(jdetect.score_batch, model=jmodel,
                                     cfg=jcfg))(
        params, images_u8=images, src_hws=src_hws, proposals=proposals)
    got_b, got_p = tdetect.score_batch(
        tmodel, tcfg, *(torch.from_numpy(x) for x in
                        (images, src_hws, proposals)))
    assert got_p.shape == want_p.shape == (len(images), P, 5)
    assert got_b.shape == want_b.shape == (len(images), P, 5, 4)
    bf16 = dtype == "bfloat16"
    _assert_close_rows(got_p, want_p, 1e-5, 1e-7, PROB_OFF if bf16 else None)
    _assert_close_rows(got_b, want_b, 0, 1e-3, BOX_OFF if bf16 else None)
    assert np.asarray(want_p).std() > 0.05


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", CONFIGS)
def test_detect_batch_matches_reference(name, dtype):
    """The Detector (numpy in and out, batch 1 for configs 1 and 2)
    against the reference's detect_batch: the same kept detections
    (valid, classes, indices), scores rtol 1e-5 and boxes within 1e-3 px;
    in bf16 as test_score_batch_matches_reference holds them."""
    (jmodel, params, jcfg), (tmodel, tcfg) = _pair(name, dtype)
    inputs = _inputs(tcfg.train.batch_size)
    want = jax.jit(lambda p, *a: jdetect.detect_batch(p, jmodel, jcfg, *a))(
        params, *inputs)
    got = tdetect.Detector(tmodel, tcfg, "cpu")(*inputs)
    assert set(got) == set(want)
    for key in ("valid", "classes", "indices"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                      err_msg=key)
    bf16 = dtype == "bfloat16"
    _assert_close_rows(got["scores"], want["scores"], 1e-5, 1e-7,
                       PROB_OFF if bf16 else None)
    _assert_close_rows(got["boxes"], want["boxes"], 0, 1e-3,
                       BOX_OFF if bf16 else None)
    b, d = len(inputs[0]), tcfg.eval.max_detections
    assert got["boxes"].shape == (b, d, 4) and got["valid"].any()


@pytest.mark.parametrize("name", ["fastrcnn_vgg16_single", "dense"])
def test_int8_serving_matches_reference(name):
    """int8 serving of one float tree, each side's Detector quantizing it
    at load: config 1's quantized pool is K2 with the epilogue on its one
    c5 group and a head of one branch and one integral classifier (its
    fused N = 5 + 20 is no multiple of 8); dense's K1 with the epilogue
    over 4 views x 3 levels. Probabilities rtol 1e-5 and boxes within
    1e-3 px for at least CLOSE_SHARE of the proposals, the rest (a code
    one apart) within PROB_OFF and BOX_OFF."""
    jcfg = _cfg(jpreset, name, head_quant="int8")
    tcfg = _cfg(preset, name, head_quant="int8")
    params = _random_tree(jbuild(dataclasses.replace(jcfg.model,
                                                     head_quant="none")))
    jmodel = jbuild(jcfg.model)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jdet = jdetect.Detector(jmodel, params, jcfg)
        tdet = tdetect.Detector(build_model(tcfg.model, device="cpu"), tcfg,
                                params=params)
    images, src_hws, proposals, prop_mask = _inputs(tcfg.train.batch_size)
    want_b, want_p = jax.jit(partial(jdetect.score_batch, model=jmodel,
                                     cfg=jcfg))(
        jdet.params, images_u8=images, src_hws=src_hws, proposals=proposals)
    got_b, got_p = tdetect.score_batch(
        tdet.model, tcfg, *(torch.from_numpy(x) for x in
                            (images, src_hws, proposals)))
    _assert_close_rows(got_p, want_p, 1e-5, 1e-7, PROB_OFF)
    _assert_close_rows(got_b, want_b, 0, 1e-3, BOX_OFF)
    assert np.asarray(want_p).std() > 0.05
    got = tdet(images, src_hws, proposals, prop_mask)
    assert got["boxes"].shape == (len(images), tcfg.eval.max_detections, 4)
    assert got["valid"].any()


# ------------------------------------------------------------- training ---

def _train_batch(rng, cfg, b):
    h, w = cfg.data.image_size
    images = rng.integers(0, 256, (b, h - 4, w, 3), dtype=np.uint8)
    src_hws = np.asarray([[h - 4, w], [h - 14, w - 23]][:b], np.float32)
    g = cfg.data.max_gt_per_image
    xy = rng.uniform(0, 40, (b, g, 2))
    wh = rng.uniform(8, 24, (b, g, 2))
    gt = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    classes = rng.integers(1, 5, (b, g)).astype(np.int32)
    gt_mask = np.arange(g)[None, :] < np.asarray([5, 3][:b])[:, None]
    p = cfg.data.max_proposals
    near = gt[np.arange(b)[:, None], rng.integers(0, g, (b, p // 2))]
    near = near + rng.normal(0, 3.0, near.shape).astype(np.float32)
    pxy = rng.uniform(0, 50, (b, p - p // 2, 2))
    pwh = rng.uniform(4, 24, (b, p - p // 2, 2))
    props = np.concatenate(
        [near, np.concatenate([pxy, pxy + pwh], -1)], 1).astype(np.float32)
    prop_mask = np.ones(props.shape[:2], bool)
    prop_mask[-1, -4:] = False
    return tloop.Batch(images, src_hws, props, prop_mask, gt, classes,
                       gt_mask)


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5),
                                        ("bfloat16", 1e-2)])
@pytest.mark.parametrize("name", ["fastrcnn_vgg16_single", "dense"])
def test_train_step_matches_reference(name, dtype, rtol, monkeypatch):
    """One Trainer.step at the configuration's batch (config 1: one image;
    dense: two), conv1-2 frozen, no flips, dropout off, the reference's
    ROI sample injected into both sides, from the reference's parameters,
    against the reference's step rebuilt with train_roi_impl="pallas" (its
    Trainer pins "direct" off the TPU, ROADMAP.md §C). Config 1 trains
    through K1 at L = 1 and its one integral head (the vanilla Fast R-CNN
    loss); dense through K1 over 4 views x 3 levels. Loss and metrics
    within rel `rtol` (float32 1e-5; bf16 1e-2, where the bf16 backward
    sums in another order on each side)."""
    def configure(make_preset):
        cfg = _cfg(make_preset, name, dtype)
        return cfg.replace(
            data=dataclasses.replace(cfg.data, hflip_prob=0.0),
            train=dataclasses.replace(cfg.train, warmup_steps=0,
                                      freeze_backbone_stages=2))

    jcfg, tcfg = configure(jpreset), configure(preset)
    b = tcfg.train.batch_size
    rng = np.random.default_rng(6)
    batch = _train_batch(rng, tcfg, b)
    jmodel = jbuild(jcfg.model, freeze_stages=2)
    params = _random_tree(jmodel, seed=11)
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
    tx, _ = jschedule.make_optimizer(jcfg.train)
    jstate = jloop.TrainState(jnp.zeros((), jnp.int32), params,
                              tx.init(params), jax.random.key(1))
    _, want = jax.jit(jloop.make_train_step(jmodel, jcfg, tx))(
        jstate, jloop.Batch(*batch))

    tsample = tsampler.RoiSample(*(torch.from_numpy(np.array(x))
                                   for x in sample))
    monkeypatch.setattr(tsampler, "sample_batch", lambda *a, **k: tsample)
    trainer = tloop.Trainer(tcfg, device="cpu")
    state = trainer.init_state(0)
    convert.load_flax_params(trainer.model, params)
    trainer.model.head.dropout_rate = 0.0
    routes = _Routes(monkeypatch)
    _, got = trainer.step(state, batch)
    assert routes.calls == TRAIN_ROUTES[name]
    assert set(got) == set(want)
    assert float(got["num_fg"]) > 0
    heads = len(tcfg.model.integral_thresholds)
    assert sum(k.startswith("loss_cls_h") for k in got) == heads
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=rtol, atol=1e-6, err_msg=key)


# ------------------------------------ K2 past the reference's 4 MB budget ---

# (dtype, canvas, C): the smallest canvas (a multiple of 16) whose one-image
# c5 pyramid passes the budget at the full model's C = 512 in bf16, and the
# smallest C (a multiple of 8) that passes it at the main path's 640^2 in
# float32
PAST_BUDGET = (("bfloat16", 688, 512), ("float32", 640, 328))


@pytest.mark.parametrize("dtype,canvas,c", PAST_BUDGET,
                         ids=[f"{d}-{s}-C{c}" for d, s, c in PAST_BUDGET])
def test_single_level_group_past_the_resident_budget(dtype, canvas, c,
                                                     monkeypatch):
    """Config 1's eval group over one image whose c5 pyramid passes the
    reference's 4 MB resident budget: the reference then pools it with K1
    at L = 1 (batched_pyramid_pool_multi), the port with K2 as always
    (batched_pyramid_pool_resident). The two kernels compute the same
    function, so the results agree as pool_rois does under one kernel:
    float32 within 1e-5 x max, bf16 within one bf16 step in at most 1e-4
    of the values. One canvas step or channel step less stays under the
    budget, where the reference takes its resident kernel too."""
    jcfg = _cfg(jpreset, "fastrcnn_vgg16_single", dtype, skip_reduce_dim=c)
    tcfg = _cfg(preset, "fastrcnn_vgg16_single", dtype, skip_reduce_dim=c)
    h = canvas // 16
    for s, ch, past in ((canvas, c, True), (canvas - 16, c, False),
                        (canvas, c - 8, False)):
        flat, _ = roi_pyramid.build_pyramid_batch(
            torch.zeros(1, s // 16, s // 16, 1), 1 / 16)
        n_bytes = flat.shape[0] * flat.shape[1] * ch * (
            2 if dtype == "bfloat16" else 4)
        assert (n_bytes > RESIDENT_BUDGET) == past, (s, ch, n_bytes)
    jmodel = jbuild(jcfg.model)
    params = _random_tree(jmodel)
    jcalls = []
    for fn in ("batched_pyramid_pool_multi", "batched_pyramid_pool_resident"):
        orig = getattr(jroi_pallas, fn)

        def rec(*a, _fn=fn, _orig=orig, **k):
            jcalls.append(_fn)
            return _orig(*a, **k)

        monkeypatch.setattr(jroi_pallas, fn, rec)
    rng = np.random.default_rng(4)
    jdt, tdt = DTYPES[dtype]
    feat = jnp.asarray(rng.normal(size=(1, h, h, c)).astype(np.float32), jdt)
    rois = _rois(rng, 1, r=12, canvas=canvas)
    want = jax.jit(lambda p, f, r: jmodel.apply(
        p, {"c5": f}, r, (canvas, canvas), method=JNet.pool_rois))(
        params, feat, jnp.asarray(rois))
    assert jcalls == ["batched_pyramid_pool_multi"]
    tmodel = build_model(tcfg.model, device="cpu")
    routes = _Routes(monkeypatch)
    with torch.no_grad():
        got = tmodel.pool_rois(
            {"c5": torch.from_numpy(np.array(feat.astype(jnp.float32)))
             .to(tdt)}, torch.from_numpy(rois), (canvas, canvas))
    assert routes.calls == [("resident", 1)]
    assert got.shape == (1, 1, 12, 7, 7, c)
    _assert_pool_close(got, want, dtype)


# ----------------------------------------------------------- weight paths ---

def test_c5_only_model_weight_paths(tmp_path):
    """A model with no reduce_c3 / reduce_c4, one foveal branch and one
    integral head through every weight path: the port's flax tree has the
    reference's names and shapes and carries both ways bit for bit; the
    Torch head contract of one branch and one classifier imports to the
    same entries on both sides and installs into the model; and an int8 +
    SVD bundle of config 1 saves, loads and detects as the Detector it was
    made from."""
    jcfg = _cfg(jpreset, "fastrcnn_vgg16_single")
    tcfg = _cfg(preset, "fastrcnn_vgg16_single")
    jmodel = jbuild(jcfg.model)
    params = _random_tree(jmodel)
    tmodel = build_model(tcfg.model, device="cpu")
    names = set(tmodel.state_dict())
    assert "reduce_c5.weight" in names and not any(
        n.startswith(("reduce_c3", "reduce_c4", "head.fc6_f1")) for n in names)
    convert.load_flax_params(tmodel, params)
    tree = convert.flax_from_state_dict(tmodel.state_dict())
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    got = dict(jax.tree_util.tree_leaves_with_path(tree))
    assert set(map(jax.tree_util.keystr, got)) == set(
        map(jax.tree_util.keystr, want))
    for path, w in want.items():
        np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(w),
                                      err_msg=jax.tree_util.keystr(path))

    rng = np.random.default_rng(3)
    g, d, fc, ncls = 7, 32, 64, 5
    c5 = tmodel.backbone.feature_channels["c5"]
    state = {"reduce.weight": rng.normal(size=(d, c5, 1, 1)),
             "reduce.bias": rng.normal(size=d),
             "fc6.0.weight": rng.normal(size=(fc, g * g * d)),
             "fc6.0.bias": rng.normal(size=fc),
             "fc7.0.weight": rng.normal(size=(fc, fc)),
             "fc7.0.bias": rng.normal(size=fc),
             "classifier.0.weight": rng.normal(size=(ncls, fc)),
             "classifier.0.bias": rng.normal(size=ncls),
             "bbox.weight": rng.normal(size=(4 * ncls, fc)),
             "bbox.bias": rng.normal(size=4 * ncls)}
    state = {k: v.astype(np.float32) for k, v in state.items()}
    head = IW.multipath_head_params_from_state_dict(
        state, skip_channels={"c5": c5})
    ref = convert.state_dict_from_flax({"params": JIW.
                                        multipath_head_params_from_state_dict(
                                            state, skip_channels={"c5": c5})})
    assert set(head) == set(ref)
    for k in head:
        assert torch.equal(head[k], ref[k]), k
    IW.install_params(tmodel, head)
    assert tmodel.head.cls_bbox.weight.shape == (ncls + 4 * ncls, fc)
    assert torch.equal(tmodel.reduce_c5.weight.detach(),
                       head["reduce_c5.weight"])

    qcfg = _cfg(preset, "fastrcnn_vgg16_single", head_quant="int8",
                fc6_rank=16, fc7_rank=8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # random weights: a flat spectrum
        det = tdetect.Detector(build_model(qcfg.model, device="cpu"), qcfg,
                               params=params)
        serving.save_bundle(str(tmp_path), qcfg, params)
    inputs = _inputs(1)
    want_det = det(*inputs)
    again = serving.load_detector(str(tmp_path), device="cpu")(*inputs)
    assert want_det["valid"].any()
    for key in want_det:
        np.testing.assert_array_equal(again[key], want_det[key], err_msg=key)
