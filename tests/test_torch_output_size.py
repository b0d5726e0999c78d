"""Port parity at roi_output_size G below 7: the pool's G bins a side, 1..7,
through the port's kernel route (on the CPU the kernels' plain versions),
held to the JAX package's roi_impl="pyramid", the XLA oracle of its
kernels, at the `tiny` preset in float32 on a 256^2 canvas, whose c5
pyramid's coarsest scale has 4 rows: fewer than the kernels' 10-row
window (ROADMAP C12: the port read past the pyramid there and raised
IndexError at every G < 7).

The reference's own kernel route computes another function at G < 7: its
pyramid gives a scale G + 3 rows and its kernels read 10, so the coarsest
scale's window runs past its buffer (in interpret mode the slice start is
clamped back, which moves the window against its weights; a buffer of
fewer than 10 rows does not trace). The port is held to the oracle, the
function that route computes at G = 7, and
test_reference_kernel_route_deviates_below_g7 records the difference.

Tolerances: pooled values, the features' gradient, probabilities and boxes
within 1e-5 x max |reference| (float32 sums in another order); the int8
epilogue bit for bit against its plain version on the port's own pooled
output, and codes within 1 / scales rtol 1e-5 of the reference's
quantize_rows on the oracle's pooled output (a float32 sum one ULP apart
can move a code at a rounding tie); a train step's losses rtol 1e-5."""

import dataclasses

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
from multipathnet_tpu.models import t7_import as jt7i
from multipathnet_tpu.models.multipath import MultiPathNet as JNet
from multipathnet_tpu.models.multipath import build_model as jbuild
from multipathnet_tpu.ops import quant as jquant
from multipathnet_tpu.train import losses as jlosses
from multipathnet_tpu_torch.core.config import preset
from multipathnet_tpu_torch.data import sampler as tsampler
from multipathnet_tpu_torch.eval import detect as tdetect
from multipathnet_tpu_torch.models import convert
from multipathnet_tpu_torch.models import import_weights as IW
from multipathnet_tpu_torch.models import t7_import as tt7i
from multipathnet_tpu_torch.models.multipath import build_model
from multipathnet_tpu_torch.ops import roi_pool, roi_pyramid
from multipathnet_tpu_torch.train import loop as tloop
from test_torch_import import _graph_bytes, _head_state

torch.set_num_threads(2)

BINS = [7, 6, 5, 4, 1]
CANVAS = 256
HW = (CANVAS, CANVAS)
LEVELS = (("c3", 4), ("c4", 8), ("c5", 16))
B, P, C = 2, 12, 32


def _cfg(make_preset, g, impl, **model):
    """`tiny` in float32 at G bins on a 256^2 canvas, roi_impl and
    train_roi_impl `impl`, no flips or warm-up."""
    cfg = make_preset("tiny")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, dtype="float32",
                                  roi_output_size=g, roi_impl=impl,
                                  train_roi_impl=impl, **model),
        data=dataclasses.replace(cfg.data, image_size=HW, hflip_prob=0.0),
        train=dataclasses.replace(cfg.train, warmup_steps=0))


def _random_tree(jmodel, seed=7):
    """A float tree for jmodel from numpy `seed`, its scores spread."""
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0),
                            jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 1, 4)))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        if "kernel" in name:
            fan_in = int(np.prod(s.shape[:-1]))
            gain = 8.0 if "cls_bbox" in name else 2.0
            return (rng.normal(size=s.shape) * np.sqrt(gain / fan_in)
                    ).astype(np.float32)
        return (rng.normal(size=s.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


_PAIRS = {}


def _pair(g, **model):
    """(reference model on the oracle, its params, cfg) and (the port's
    eval model on the kernel route, cfg) on one tree, once per G."""
    key = (g, tuple(sorted(model.items())))
    if key not in _PAIRS:
        jcfg = _cfg(jpreset, g, "pyramid", **model)
        tcfg = _cfg(preset, g, "pallas", **model)
        jmodel = jbuild(jcfg.model)
        params = _random_tree(jmodel)
        tmodel = convert.load_flax_params(
            build_model(tcfg.model, device="cpu"), params).eval()
        assert tmodel.roi_route() == tmodel.roi_route(True) == "kernels"
        _PAIRS[key] = (jmodel, params, jcfg), (tmodel, tcfg)
    return _PAIRS[key]


def _maps(rng, c=C):
    return {lv: rng.normal(size=(B, CANVAS // s, CANVAS // s, c)).astype(
        np.float32) for lv, s in LEVELS}


def _rois(rng):
    """(B, P, 4): sizes log-uniform from 8 px to the canvas, a third over
    the border, and the whole canvas first, whose 1x view pools c5's
    coarsest scale (4 rows) and whose wider views are clipped to it."""
    wh = np.exp(rng.uniform(np.log(8.0), np.log(CANVAS), (B, P, 2)))
    xy = rng.uniform(-0.2, 1.0, (B, P, 2)) * CANVAS - 0.3 * wh
    boxes = np.clip(np.concatenate([xy, xy + wh], -1), 0, CANVAS)
    boxes[:, 0] = [0, 0, CANVAS, CANVAS]
    return boxes.astype(np.float32)


def _close(got, want, tol=1e-5):
    """float32 outputs within tol x max |want|."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


def _t(maps):
    return {k: torch.from_numpy(v) for k, v in maps.items()}


def _reads_coarsest_short_scale(maps, rois, g):
    """Whether the whole-canvas 1x views pool c5's coarsest scale, which
    holds fewer rows than the 10-row window but lies in a buffer of 10."""
    _, meta = roi_pyramid.build_pyramid_batch(
        torch.from_numpy(maps["c5"]), 1.0 / 16, output_size=g)
    row0 = roi_pool.view_geometry(meta, torch.from_numpy(rois[:, 0]),
                                  output_size=g)[0]
    last = int(meta.row_offsets[-1])
    return (bool((row0 == last).all()) and int(meta.heights[-1]) < 10
            and meta.flat.shape[0] - last == 10)


# ------------------------------------------------------- pool_rois ---

@pytest.mark.parametrize("g", BINS)
def test_pool_rois_kernel_route_matches_oracle(g):
    """MultiPathNet.pool_rois on the kernel route (K1 for the 1x view over
    c3 + c4 + c5, K2 for the context views over c5) against the
    reference's pyramid oracle: (B, 4, P, G, G, C) within 1e-5 x max."""
    (jmodel, params, _), (tmodel, _) = _pair(g)
    rng = np.random.default_rng(g)
    maps, rois = _maps(rng), _rois(rng)
    assert _reads_coarsest_short_scale(maps, rois, g)
    want = jax.jit(lambda p, f, r: jmodel.apply(
        p, f, r, HW, method=JNet.pool_rois))(params, maps, rois)
    with torch.no_grad():
        got = tmodel.pool_rois(_t(maps), torch.from_numpy(rois), HW)
    assert got.shape == (B, 4, P, g, g, C) and got.dtype == torch.float32
    _close(got, want)


def test_pool_rois_at_g7_equals_reference_kernel_route():
    """At G = 7 the port's kernel route also equals the reference's own
    kernel route (roi_impl="pallas", interpret mode), as before."""
    (_, params, _), (tmodel, _) = _pair(7)
    jmodel = jbuild(_cfg(jpreset, 7, "pallas").model)
    rng = np.random.default_rng(7)
    maps, rois = _maps(rng), _rois(rng)
    want = jax.jit(lambda p, f, r: jmodel.apply(
        p, f, r, HW, method=JNet.pool_rois))(params, maps, rois)
    with torch.no_grad():
        got = tmodel.pool_rois(_t(maps), torch.from_numpy(rois), HW)
    _close(got, want)


def test_reference_kernel_route_deviates_below_g7():
    """C12 in the reference: at G = 6 its kernel route (roi_impl="pallas")
    reads a 10-row window from scales of 9 rows, and differs from its own
    pyramid oracle where a view pools c5's coarsest scale; the port's
    kernel route equals the oracle there. The port does not copy the
    reference's G < 7 kernel result (a deliberate deviation, ROADMAP)."""
    (jmodel, params, _), (tmodel, _) = _pair(6)
    jpallas = jbuild(_cfg(jpreset, 6, "pallas").model)
    rng = np.random.default_rng(6)
    maps, rois = _maps(rng), _rois(rng)
    run = jax.jit(lambda m, p, f, r: m.apply(p, f, r, HW,
                                             method=JNet.pool_rois),
                  static_argnums=0)
    oracle = np.asarray(run(jmodel, params, maps, rois))
    kernel = np.asarray(run(jpallas, params, maps, rois))
    with torch.no_grad():
        got = tmodel.pool_rois(_t(maps), torch.from_numpy(rois), HW).numpy()
    scale = float(np.abs(oracle).max())
    # the whole-canvas 1x views (foveal 0, ROI 0) read the short scale
    off = np.abs(kernel - oracle)
    assert off[:, 0, 0].max() > 0.05 * scale
    _close(got, oracle)


# ----------------------------------------------------------- serving ---

def _inputs(seed):
    """uint8 images of 240 x 256 (valid extents up to that) and P
    proposals an image, the first the whole image; the last three of
    image 1 masked."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (B, 240, 256, 3), dtype=np.uint8)
    src_hws = np.asarray([[240, 256], [200, 230]], np.float32)
    wh = np.exp(rng.uniform(np.log(8.0), np.log(200.0), (B, P, 2)))
    xy = rng.uniform(0, 1, (B, P, 2)) * (src_hws[:, None, ::-1] - wh)
    props = np.concatenate([xy, xy + wh], -1)
    props[:, 0] = np.concatenate([np.zeros((B, 2)), src_hws[:, ::-1]], -1)
    prop_mask = np.ones((B, P), bool)
    prop_mask[1, -3:] = False
    return images, src_hws, props.astype(np.float32), prop_mask


@pytest.mark.parametrize("g", BINS)
def test_detect_batch_kernel_route_matches_oracle(g):
    """score_batch and the Detector on the kernel route against the
    reference's on its oracle: the same kept detections (valid, classes,
    indices), probabilities, scores and boxes within 1e-5 x max."""
    (jmodel, params, jcfg), (tmodel, tcfg) = _pair(g)
    images, src_hws, props, prop_mask = _inputs(g)
    want_b, want_p = jax.jit(lambda p, *a: jdetect.score_batch(
        p, jmodel, jcfg, *a))(params, images, src_hws, props)
    got_b, got_p = tdetect.score_batch(
        tmodel, tcfg, *(torch.from_numpy(x) for x in
                        (images, src_hws, props)))
    _close(got_p, want_p)
    _close(got_b, want_b)
    assert np.asarray(want_p).std() > 0.05
    want = jax.jit(lambda p, *a: jdetect.detect_batch(p, jmodel, jcfg, *a))(
        params, images, src_hws, props, prop_mask)
    got = tdetect.Detector(tmodel, tcfg, "cpu")(images, src_hws, props,
                                                prop_mask)
    for key in ("valid", "classes", "indices"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                      err_msg=key)
    _close(got["scores"], want["scores"])
    _close(got["boxes"], want["boxes"])
    assert got["valid"].any()


@pytest.mark.parametrize("g", BINS)
def test_int8_epilogue_at_every_bin_count(g):
    """pool_rois with the int8 epilogue (quant_bias) on the kernel route:
    each view's scale over its G^2 x C values; codes and scales bit for bit
    the plain epilogue (quant_view_ref) of the port's own pooled output,
    and codes within 1, scales rtol 1e-5 of the reference's quantize_rows
    of relu(oracle + bias)."""
    (jmodel, params, _), (tmodel, _) = _pair(g)
    rng = np.random.default_rng(20 + g)
    maps, rois = _maps(rng), _rois(rng)
    bias = (rng.normal(size=C) * 0.5).astype(np.float32)
    with torch.no_grad():
        q, s = tmodel.pool_rois(_t(maps), torch.from_numpy(rois), HW,
                                quant_bias=torch.from_numpy(bias))
        pooled = tmodel.pool_rois(_t(maps), torch.from_numpy(rois), HW)
    n = B * 4 * P
    assert q.shape == (B, 4, P, g, g, C) and s.shape == (B, 4, P, 1)
    own_q, own_s = roi_pool.quant_view_ref(pooled.reshape(n, g, g, C),
                                           torch.from_numpy(bias))
    assert torch.equal(q.reshape(n, g, g, C), own_q)
    assert torch.equal(s.reshape(n), own_s)
    oracle = jax.jit(lambda p, f, r: jmodel.apply(
        p, f, r, HW, method=JNet.pool_rois))(params, maps, rois)
    want_q, want_s = jquant.quantize_rows(
        jnp.maximum(oracle.reshape(n, -1) + jnp.tile(bias, g * g), 0.0))
    assert np.abs(q.reshape(n, -1).int().numpy()
                  - np.asarray(want_q, np.int32)).max() <= 1
    np.testing.assert_allclose(s.reshape(n).numpy(),
                               np.asarray(want_s).reshape(n), rtol=1e-5,
                               atol=0)


# ---------------------------------------------------------- training ---

@pytest.mark.parametrize("g", BINS)
def test_pool_backward_matches_vjp_of_oracle(g):
    """pool_rois(train=True) on the kernel route (WindowPoolMulti for both
    groups; on the CPU K3's and K4's plain versions and the placement)
    against jax.vjp of the reference's pyramid oracle: the gradient of
    each level's features under one random cotangent, within 1e-5 x max."""
    (jmodel, params, _), (tmodel, _) = _pair(g)
    rng = np.random.default_rng(30 + g)
    maps, rois = _maps(rng), _rois(rng)
    cot = rng.normal(size=(B, 4, P, g, g, C)).astype(np.float32)
    _, vjp = jax.vjp(lambda f: jmodel.apply(params, f, rois, HW,
                                            method=JNet.pool_rois), maps)
    (want,) = vjp(jnp.asarray(cot))
    feats = {k: v.requires_grad_() for k, v in _t(maps).items()}
    out = tmodel.pool_rois(feats, torch.from_numpy(rois), HW, train=True)
    (out * torch.from_numpy(cot)).sum().backward()
    for lv, _ in LEVELS:
        assert float(np.abs(np.asarray(want[lv])).max()) > 0, lv
        _close(feats[lv].grad, want[lv])


def _train_batch(rng, cfg):
    h, w = cfg.data.image_size
    images = rng.integers(0, 256, (B, h - 16, w, 3), dtype=np.uint8)
    src_hws = np.asarray([[h - 16, w], [h - 40, w - 30]], np.float32)
    n_gt = cfg.data.max_gt_per_image
    gt = np.zeros((B, n_gt, 4), np.float32)
    classes = np.zeros((B, n_gt), np.int32)
    gt_mask = np.zeros((B, n_gt), bool)
    for i, n in enumerate((5, 3)):
        xy = rng.uniform(0, 120, (n, 2))
        wh = rng.uniform(24, 110, (n, 2))
        gt[i, :n] = np.concatenate([xy, xy + wh], -1)
        classes[i, :n] = rng.integers(1, cfg.model.num_classes, n)
        gt_mask[i, :n] = True
    p = cfg.data.max_proposals
    jitter = rng.normal(scale=8.0, size=(B, p, 4))
    props = gt[:, rng.integers(0, 3, p)] + jitter
    props[:, p // 2:] = np.concatenate(
        [rng.uniform(0, 120, (B, p - p // 2, 2)),
         rng.uniform(130, 230, (B, p - p // 2, 2))], -1)
    props[:, 0] = [0, 0, w, h - 16]
    props = np.clip(props, 0, None).astype(np.float32)
    props[..., 2:] = np.maximum(props[..., 2:], props[..., :2] + 4)
    return tloop.Batch(images, src_hws, props, np.ones((B, p), bool), gt,
                       classes, gt_mask)


@pytest.mark.parametrize("g", BINS)
def test_train_step_loss_matches_oracle_forward(g, monkeypatch):
    """One Trainer.step on the kernel route (its pool through
    WindowPoolMulti, the sample injected, dropout off) against the
    reference's forward through its pyramid oracle on the same canvases,
    sample and weights: loss, loss_cls and loss_bbox rtol 1e-5 (the
    reference's own train step reads the oracle only in eval: in training
    it takes "direct", another function)."""
    (jmodel, params, jcfg), (_, tcfg) = _pair(g)
    rng = np.random.default_rng(40 + g)
    batch = _train_batch(rng, tcfg)
    canvases, scales = jax.jit(lambda im, hw: jtf.batch_resize_to_canvas(
        im, jcfg.data.image_size, hw))(batch.images, batch.src_hws)
    d, m = jcfg.data, jcfg.model
    s = np.asarray(scales)[:, None, None]
    sample = jax.jit(lambda *a: jsampler.sample_batch(
        jax.random.key(g), *a, rois_per_image=d.rois_per_image,
        fg_fraction=d.fg_fraction, fg_iou_threshold=d.fg_iou_threshold,
        bg_iou_range=d.bg_iou_range, bbox_reg_means=m.bbox_reg_means,
        bbox_reg_stds=m.bbox_reg_stds))(
        batch.proposals * s, batch.prop_mask, batch.gt_boxes * s,
        batch.gt_classes, batch.gt_mask)
    scores, deltas = jax.jit(lambda p, x, r: jmodel.apply(p, x, r))(
        params, canvases, sample.rois)
    _, want = jlosses.detection_loss(
        scores, deltas, sample, integral_thresholds=m.integral_thresholds,
        num_classes=m.num_classes, class_specific_bbox=m.class_specific_bbox,
        integral_agg=m.integral_loss_agg)

    tsample = tsampler.RoiSample(*(torch.from_numpy(np.array(x))
                                   for x in sample))
    monkeypatch.setattr(tsampler, "sample_batch", lambda *a, **k: tsample)
    trainer = tloop.Trainer(tcfg, device="cpu")
    state = trainer.init_state(0)
    convert.load_flax_params(trainer.model, params)
    trainer.model.head.dropout_rate = 0.0
    _, got = trainer.step(state, batch)
    assert float(got["num_fg"]) > 0
    for name in ("loss", "loss_cls", "loss_bbox"):
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


# ------------------------------------------- AlexNet, imported heads ---

def test_alexnet_trunk_at_g6_matches_oracle():
    """The AlexNet trunk (backbone="alexnet", the family whose 6 x 6 pool5
    a converted head expects) at G = 6 on the kernel route against the
    reference on its oracle: score_batch's probabilities and boxes within
    1e-5 x max."""
    (jmodel, params, jcfg), (tmodel, tcfg) = _pair(6, backbone="alexnet")
    images, src_hws, props, _ = _inputs(66)
    want_b, want_p = jax.jit(lambda p, *a: jdetect.score_batch(
        p, jmodel, jcfg, *a))(params, images, src_hws, props)
    got_b, got_p = tdetect.score_batch(
        tmodel, tcfg, *(torch.from_numpy(x) for x in
                        (images, src_hws, props)))
    assert got_p.shape == (B, P, tcfg.model.num_classes)
    _close(got_p, want_p)
    _close(got_b, want_b)


def test_head_imported_at_g6_runs_in_a_g6_model():
    """A head-contract state dict for 6 x 6 pooled maps
    (multipath_head_params_from_state_dict(roi_output_size=6)): the port's
    import equals the reference's followed by convert, bit for bit, and it
    installs into a G = 6 model whose kernel route runs on it."""
    cfg = _cfg(preset, 6, "pallas").model
    model = build_model(cfg, device="cpu").eval()
    skip = {lv: model.backbone.feature_channels[lv] for lv in cfg.skip_levels}
    n_k = len(cfg.integral_thresholds)
    state = _head_state(np.random.default_rng(6), skip,
                        d=cfg.skip_reduce_dim, g=6, fc=cfg.fc_dim,
                        n_f=len(cfg.foveal_scales), n_k=n_k,
                        ncls=cfg.num_classes)
    got = IW.multipath_head_params_from_state_dict(
        state, skip_channels=skip, roi_output_size=6)
    want = convert.state_dict_from_flax({"params": (
        JIW.multipath_head_params_from_state_dict(
            state, skip_channels=skip, roi_output_size=6))})
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in got)
    assert got["head.fc6_f0.weight"].shape == (cfg.fc_dim,
                                               6 * 6 * cfg.skip_reduce_dim)
    IW.install_params(model, got)
    rois = torch.tensor([[[0.0, 0.0, 64.0, 64.0], [4.0, 6.0, 40.0, 50.0]]])
    with torch.no_grad():
        scores, deltas = model(torch.randn(1, 64, 64, 3), rois)
    assert scores.shape == (1, 2, n_k, cfg.num_classes)
    assert torch.isfinite(scores).all() and torch.isfinite(deltas).all()


def test_t7_model_imported_at_g6_matches_reference(tmp_path):
    """import_model_t7(roi_output_size=6) on a Torch7 MultiPath VGG-16
    graph with 6 x 6 ROI pools: every array equal to the reference's
    import after convert, bit for bit; installed into an align-mode
    VGG-16 model at G = 6, whose kernel route runs on it."""
    from multipathnet_tpu_torch.core.config import preset as tpreset

    data, state = _graph_bytes(5, g=6)
    path = tmp_path / "model.t7"
    path.write_bytes(data)
    got = tt7i.import_model_t7(str(path), roi_output_size=6)
    jm = dataclasses.replace(jpreset("multipath_vgg16_reference").model,
                             fc_dim=24, skip_reduce_dim=16, num_classes=5,
                             integral_thresholds=(0.5, 0.6, 0.7),
                             roi_output_size=6, roi_impl="pyramid")
    shapes = jax.eval_shape(jbuild(jm).init, jax.random.key(0),
                            jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 1, 4)))
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    want = convert.state_dict_from_flax(jt7i.import_model_t7(
        str(path), zeros, roi_output_size=6))
    assert set(got) <= set(want)
    assert all(torch.equal(v, want[k]) for k, v in got.items())
    np.testing.assert_array_equal(got["head.fc6_f0.bias"].numpy(),
                                  state["fc6.0.bias"])
    m = dataclasses.replace(tpreset("default").model, fc_dim=24,
                            skip_reduce_dim=16, num_classes=5,
                            integral_thresholds=(0.5, 0.6, 0.7),
                            roi_output_size=6, dtype="float32")
    model = tt7i.import_model_t7(str(path), build_model(m, device="cpu"),
                                 roi_output_size=6).eval()
    assert model.roi_route() == "kernels"
    rois = torch.tensor([[[4.0, 6.0, 40.0, 50.0], [0.0, 0.0, 64.0, 64.0]]])
    with torch.no_grad():
        scores, deltas = model(torch.randn(1, 64, 64, 3), rois)
    assert scores.shape == (1, 2, 3, 5) and deltas.shape == (1, 2, 20)
    assert torch.isfinite(scores).all() and torch.isfinite(deltas).all()


def test_bin_counts_outside_1_to_7_raise():
    """The port's kernel route refuses G = 8 and G = 0 (the reference's
    view_geometry asserts G + 3 <= 10); its pyramids give every scale at
    least the 10-row window below G = 7 and window_sizes(G) rows above."""
    for g in (0, 8):
        with pytest.raises(ValueError, match="bins a side"):
            roi_pool.view_geometry(
                roi_pyramid.build_pyramid(torch.zeros(16, 16, 4), 0.25),
                torch.zeros(1, 4), output_size=g)
    assert [roi_pyramid.scale_rows(g) for g in (1, 4, 6, 7, 8, 28)] == [
        10, 10, 10, 10, 11, 31]
