"""Port parity in bfloat16, the presets' compute dtype, at the `tiny`
preset: the trunk's features, the head from one pooled input, the whole
forward, score_batch and one train step against the JAX package (the
Pallas pool kernels in interpret mode), on one parameter tree.

flax's bf16 `nn.Conv`/`nn.Dense` round the product to bf16 and then add the
bias in bf16; models/layers.py does the same, so these are held bit for
bit wherever both sides run the same roundings (before the split, 62-72%
of the features and 73% of the scores from one pooled input differed).
The train step's gradients are not: both sides sum bf16 cotangents in
their own order, each tolerance below says how far. Also the bf16 pool at
a channel count that is no multiple of 8 (MultiPathNet.pool_rois pads it
to 8 for the card's kernels, with zero bias on the pad lanes)."""

import dataclasses
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
from multipathnet_tpu.models.multipath import MultiPathNet as JNet
from multipathnet_tpu.models.multipath import build_model as jbuild
from multipathnet_tpu.train import loop as jloop
from multipathnet_tpu.train import losses as jlosses
from multipathnet_tpu.train import schedule as jschedule
from multipathnet_tpu_torch.core.config import preset
from multipathnet_tpu_torch.data import sampler as tsampler
from multipathnet_tpu_torch.eval import detect as tdetect
from multipathnet_tpu_torch.models import convert
from multipathnet_tpu_torch.models.multipath import build_model
from multipathnet_tpu_torch.train import loop as tloop

torch.set_num_threads(2)


def _t(x):
    """A jax or numpy array as a torch tensor, bf16 kept (through float32,
    which holds every bf16 value exactly)."""
    a = np.asarray(x)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).bfloat16()
    return torch.from_numpy(np.array(a))


def _cfg(make_preset, **model):
    cfg = make_preset("tiny")
    return cfg.replace(model=dataclasses.replace(cfg.model, roi_impl="pallas",
                                                 **model))


def _tree(jmodel, seed):
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0),
                            jnp.zeros((1, 64, 64, 3)),
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


@pytest.fixture(scope="module")
def bf16_pair():
    """(jax model, params, cfg) and (torch eval model, cfg), bf16."""
    jcfg, tcfg = _cfg(jpreset), _cfg(preset)
    assert jcfg.model.dtype == tcfg.model.dtype == "bfloat16"
    jmodel = jbuild(jcfg.model)
    params = _tree(jmodel, 7)
    tmodel = convert.load_flax_params(
        build_model(tcfg.model, device="cpu"), params)
    return (jmodel, params, jcfg), (tmodel.eval(), tcfg)


def _images(seed=3):
    return np.random.default_rng(seed).normal(size=(2, 64, 64, 3)).astype(
        np.float32)


def _rois(seed=1, r=6):
    rng = np.random.default_rng(seed)
    rois = rng.uniform(2, 34, (2, r, 4)).astype(np.float32)
    rois[..., 2:] += rng.uniform(6, 28, (2, r, 2)).astype(np.float32)
    return rois


def test_bf16_features_match_reference_bit_for_bit(bf16_pair):
    """c3/c4/c5 after the trunk and each level's 1x1 reduce: equal, bit for
    bit (with the bias in the product's rounding, 10,084 of c3's 16,384
    values differed, by up to 0.031)."""
    (jmodel, params, _), (tmodel, _) = bf16_pair
    images = _images()
    want = jax.jit(lambda p, im: jmodel.apply(p, im, method=JNet.features))(
        params, images)
    with torch.no_grad():
        got = tmodel.features(torch.from_numpy(images))
    assert set(got) == set(want)
    for lv in want:
        assert got[lv].dtype == torch.bfloat16
        assert torch.equal(got[lv], _t(want[lv])), lv


def test_bf16_predict_rois_from_one_pooled_input_bit_for_bit(bf16_pair):
    """The head (skip bias, ReLU, fc6/fc7 per view, the fused cls+bbox GEMM)
    on the reference's own pooled tensor: equal scores and deltas, bit for
    bit."""
    (jmodel, params, _), (tmodel, _) = bf16_pair
    feats = jax.jit(lambda p, im: jmodel.apply(p, im, method=JNet.features))(
        params, _images())
    pooled = jax.jit(lambda p, f, r: jmodel.apply(
        p, f, r, (64, 64), method=JNet.pool_rois))(params, feats, _rois())
    want_s, want_d = jax.jit(lambda p, x: jmodel.apply(
        p, x, method=JNet.predict_rois))(params, pooled)
    with torch.no_grad():
        got_s, got_d = tmodel.predict_rois(_t(pooled))
    assert torch.equal(got_s, _t(want_s)) and torch.equal(got_d, _t(want_d))
    assert np.asarray(want_s).std() > 0.05


def test_bf16_forward_matches_reference_bit_for_bit(bf16_pair):
    """{images, rois} -> (scores, deltas), the reference's contract, the
    bf16 pool included: equal, bit for bit, at these inputs (the pool may
    differ in a few values elsewhere, tests/test_torch_quant.py)."""
    (jmodel, params, _), (tmodel, _) = bf16_pair
    images, rois = _images(4), _rois(2)
    want_s, want_d = jax.jit(jmodel.apply)(params, images, rois)
    with torch.no_grad():
        got_s, got_d = tmodel(torch.from_numpy(images),
                              torch.from_numpy(rois))
    assert torch.equal(got_s, _t(want_s)) and torch.equal(got_d, _t(want_d))


def test_bf16_score_batch_matches_reference(bf16_pair):
    """uint8 images and proposals -> class probabilities and boxes: resize,
    trunk, pool and head in bf16 (bit-equal above), then the mean of the
    integral softmaxes and the box decode in float32, each side in its own
    order: probabilities rtol 1e-6 (seen 2.2e-7), boxes rtol 1e-6 and atol
    1e-5 pixels (seen 7.7e-7 and 7.6e-6)."""
    (jmodel, params, jcfg), (tmodel, tcfg) = bf16_pair
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (2, 48, 56, 3), dtype=np.uint8)
    src_hws = np.asarray([[48, 56], [40, 50]], np.float32)
    proposals = _rois(6, 12) * 0.9
    want_b, want_p = jax.jit(partial(jdetect.score_batch, model=jmodel,
                                     cfg=jcfg))(
        params, images_u8=images, src_hws=src_hws, proposals=proposals)
    got_b, got_p = tdetect.score_batch(
        tmodel, tcfg, *(torch.from_numpy(x) for x in
                        (images, src_hws, proposals)))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=1e-6,
                               atol=1e-5)
    assert np.asarray(want_p).std() > 0.05


def _assert_bf16_pool_close(got, want, share=1e-4):
    """bf16 pooled values as tests/test_torch_quant.py holds them: at most
    `share` of them differ, each by at most one bf16 step at the larger
    magnitude or 1/256 of the largest pooled magnitude. Returns the number
    that differ."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
    step = torch.maximum(torch.ldexp(torch.ones_like(got), e - 8),
                         want.abs().max() / 256)
    n = int((diff > 0).sum())
    assert bool((diff <= step).all()) and n <= share * got.numel()
    return n


def _train_batch(rng, cfg, b=2):
    """tests/test_torch_train.py's batch: 5 and 3 GT boxes, proposals half
    jittered around them, the last 4 of image 1 masked."""
    def boxes(shape, hi=50.0, lo_wh=4.0, hi_wh=24.0):
        xy = rng.uniform(0, hi, (*shape, 2))
        wh = rng.uniform(lo_wh, hi_wh, (*shape, 2))
        return np.concatenate([xy, xy + wh], -1).astype(np.float32)

    h, w = cfg.data.image_size
    g, p = cfg.data.max_gt_per_image, cfg.data.max_proposals
    images = rng.integers(0, 256, (b, h - 4, w, 3), dtype=np.uint8)
    src_hws = np.asarray([[h - 4, w], [h - 14, w - 23]], np.float32)[:b]
    gt = boxes((b, g), hi=40.0, lo_wh=8.0)
    classes = rng.integers(1, 5, (b, g)).astype(np.int32)
    gt_mask = np.arange(g)[None, :] < np.asarray([5, 3][:b])[:, None]
    near = gt[np.arange(b)[:, None], rng.integers(0, g, (b, p // 2))]
    near = near + rng.normal(0, 3.0, near.shape).astype(np.float32)
    props = np.concatenate([near, boxes((b, p - p // 2))], 1)
    prop_mask = np.ones(props.shape[:2], bool)
    prop_mask[-1, -4:] = False
    return tloop.Batch(images, src_hws, props, prop_mask, gt, classes,
                       gt_mask)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def test_bf16_train_step_matches_reference(monkeypatch):
    """One Trainer.step at tiny in bf16 (float32 parameters, bf16 compute),
    conv1-2 frozen, dropout off, the reference's sample injected into both
    sides. The forward is bit-equal (above), so the loss and metrics agree
    to float32 reduction order: rtol 1e-5 (grad_norm, a float32 norm of
    gradients that differ as below, rtol 1e-3; seen 3.8e-5). The gradients
    run through
    bf16 backward passes whose sums each side takes in its own order and
    rounds to bf16: each kernel's gradient within 1e-2 of its largest
    magnitude (seen 3.3e-3), each bias's within 2e-2 (seen 1.5e-2) and the
    skip bias's within 0.25 (seen 0.145: it sums 6,272 bf16 cotangents per
    channel that largely cancel). Parameters after the SGD step atol 1e-3
    (seen 3.9e-4)."""
    def configure(make_preset):
        cfg = make_preset("tiny")
        return cfg.replace(
            model=dataclasses.replace(cfg.model, train_roi_impl="pallas"),
            data=dataclasses.replace(cfg.data, hflip_prob=0.0),
            train=dataclasses.replace(cfg.train, warmup_steps=0,
                                      freeze_backbone_stages=2))

    jcfg, tcfg = configure(jpreset), configure(preset)
    assert tcfg.model.dtype == "bfloat16"
    rng = np.random.default_rng(6)
    batch = _train_batch(rng, tcfg)
    jmodel = jbuild(jcfg.model, freeze_stages=2)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0),
                            jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 1, 4)))

    def leaf(path, s):
        if "kernel" in jax.tree_util.keystr(path):
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape) * np.sqrt(2.0 / fan_in)
                    ).astype(np.float32)
        return (rng.normal(size=s.shape) * 0.1).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    canvases, scales = jax.jit(lambda im, hw: jtf.batch_resize_to_canvas(
        im, jcfg.data.image_size, hw))(batch.images, batch.src_hws)
    d, m = jcfg.data, jcfg.model
    sample = jax.jit(lambda *a: jsampler.sample_batch(
        jax.random.key(9), *a, rois_per_image=d.rois_per_image,
        fg_fraction=d.fg_fraction, fg_iou_threshold=d.fg_iou_threshold,
        bg_iou_range=d.bg_iou_range, bbox_reg_means=m.bbox_reg_means,
        bbox_reg_stds=m.bbox_reg_stds))(
        batch.proposals * np.asarray(scales)[:, None, None], batch.prop_mask,
        batch.gt_boxes * np.asarray(scales)[:, None, None], batch.gt_classes,
        batch.gt_mask)
    monkeypatch.setattr(jsampler, "sample_batch", lambda *a, **k: sample)
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    loss_kw = dict(integral_thresholds=m.integral_thresholds,
                   num_classes=m.num_classes,
                   class_specific_bbox=m.class_specific_bbox,
                   integral_agg=m.integral_loss_agg)

    def loss_fn(p):
        scores, deltas = jmodel.apply(p, canvases, sample.rois, train=True)
        return jlosses.detection_loss(scores, deltas, sample, **loss_kw)[0]

    want_grads = dict(_leaves(jax.jit(jax.grad(loss_fn))(params)))
    tx, _ = jschedule.make_optimizer(jcfg.train)
    jstate = jloop.TrainState(jnp.zeros((), jnp.int32), params,
                              tx.init(params), jax.random.key(1))
    jstate, want_m = jax.jit(jloop.make_train_step(jmodel, jcfg, tx))(
        jstate, jloop.Batch(*batch))

    tsample = tsampler.RoiSample(*(torch.from_numpy(np.array(x))
                                   for x in sample))
    monkeypatch.setattr(tsampler, "sample_batch", lambda *a, **k: tsample)
    trainer = tloop.Trainer(tcfg, device="cpu")
    state = trainer.init_state(0)
    convert.load_flax_params(trainer.model, params)
    trainer.model.head.dropout_rate = 0.0
    state, got_m = trainer.step(state, batch)

    assert set(got_m) == set(want_m)
    for name in want_m:
        rtol = 1e-3 if name == "grad_norm" else 1e-5
        np.testing.assert_allclose(float(got_m[name]), float(want_m[name]),
                                   rtol=rtol, atol=1e-6, err_msg=name)
    assert float(got_m["num_fg"]) > 0
    got_grads = dict(_leaves(convert.flax_from_state_dict(
        {n: (p.grad if p.grad is not None else torch.zeros_like(p))
         for n, p in trainer.model.named_parameters()})))
    assert set(got_grads) == set(want_grads)
    for name, want in want_grads.items():
        scale = np.abs(want).max()
        if "conv1" in name or "conv2" in name:     # frozen
            assert scale == 0 and not got_grads[name].any(), name
            continue
        tol = (0.25 if "skip_bias" in name
               else 2e-2 if name.endswith("bias") else 1e-2)
        err = np.abs(got_grads[name] - want).max() / scale
        assert err < tol, (name, err)
    got_params = dict(_leaves(convert.flax_from_state_dict(
        trainer.model.state_dict())))
    for name, want in _leaves(jstate.params):
        np.testing.assert_allclose(got_params[name], want, atol=1e-3,
                                   rtol=0, err_msg=name)


def test_bf16_gradients_no_further_from_float32_than_reference(
        monkeypatch):
    """The bf16 step's gradients differ between the two sides (above); here
    each side's are held against the float32 gradient of the same weights
    and sample (the reference's, which the port's float32 step equals to
    1e-4, tests/test_torch_train.py). For every trainable tensor the port's
    relative RMS error from float32 is at most 1.1 x the reference's plus
    1e-3 (seen at most 1.02 x; the skip bias's 0.04 against the
    reference's 0.14): the port's bf16 backward loses no more than the
    reference's does, so a bf16 run that ends apart from the reference's is
    rounding, not a port loss of precision."""
    def configure(make_preset, dtype):
        cfg = make_preset("tiny")
        return cfg.replace(
            model=dataclasses.replace(cfg.model, train_roi_impl="pallas",
                                      dtype=dtype),
            data=dataclasses.replace(cfg.data, hflip_prob=0.0),
            train=dataclasses.replace(cfg.train, warmup_steps=0,
                                      freeze_backbone_stages=2))

    rng = np.random.default_rng(6)
    batch = _train_batch(rng, configure(preset, "bfloat16"))
    jcfg = configure(jpreset, "float32")
    shapes = jax.eval_shape(jbuild(jcfg.model).init, jax.random.key(0),
                            jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 1, 4)))

    def leaf(path, s):
        if "kernel" in jax.tree_util.keystr(path):
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape) * np.sqrt(2.0 / fan_in)
                    ).astype(np.float32)
        return (rng.normal(size=s.shape) * 0.1).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    canvases, scales = jtf.batch_resize_to_canvas(
        batch.images, jcfg.data.image_size, batch.src_hws)
    d, m = jcfg.data, jcfg.model
    sample = jsampler.sample_batch(
        jax.random.key(9), batch.proposals * np.asarray(scales)[:, None, None],
        batch.prop_mask, batch.gt_boxes * np.asarray(scales)[:, None, None],
        batch.gt_classes, batch.gt_mask, rois_per_image=d.rois_per_image,
        fg_fraction=d.fg_fraction, fg_iou_threshold=d.fg_iou_threshold,
        bg_iou_range=d.bg_iou_range, bbox_reg_means=m.bbox_reg_means,
        bbox_reg_stds=m.bbox_reg_stds)
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    loss_kw = dict(integral_thresholds=m.integral_thresholds,
                   num_classes=m.num_classes,
                   class_specific_bbox=m.class_specific_bbox,
                   integral_agg=m.integral_loss_agg)

    def reference_grads(dtype):
        jmodel = jbuild(configure(jpreset, dtype).model, freeze_stages=2)

        def loss_fn(p):
            scores, deltas = jmodel.apply(p, canvases, sample.rois,
                                          train=True)
            return jlosses.detection_loss(scores, deltas, sample,
                                          **loss_kw)[0]

        return dict(_leaves(jax.jit(jax.grad(loss_fn))(params)))

    want32, ref16 = reference_grads("float32"), reference_grads("bfloat16")
    tsample = tsampler.RoiSample(*(torch.from_numpy(np.array(x))
                                   for x in sample))
    monkeypatch.setattr(tsampler, "sample_batch", lambda *a, **k: tsample)
    trainer = tloop.Trainer(configure(preset, "bfloat16"), device="cpu")
    state = trainer.init_state(0)
    convert.load_flax_params(trainer.model, params)
    trainer.model.head.dropout_rate = 0.0
    trainer.step(state, batch)
    port16 = dict(_leaves(convert.flax_from_state_dict(
        {n: (p.grad if p.grad is not None else torch.zeros_like(p))
         for n, p in trainer.model.named_parameters()})))
    checked = 0
    for name, want in want32.items():
        if not np.abs(want).any():      # frozen
            continue
        norm = np.linalg.norm(want)
        port = np.linalg.norm(port16[name] - want) / norm
        ref = np.linalg.norm(ref16[name] - want) / norm
        assert port <= 1.1 * ref + 1e-3, (name, port, ref)
        checked += 1
    assert checked == 26


@pytest.mark.parametrize("quantized", [False, True], ids=["pool", "int8"])
def test_bf16_pool_at_channels_not_a_multiple_of_8(quantized):
    """skip_reduce_dim = 20: the port pads the reference's own bf16
    features to 24 channels, with a zero skip bias on the 4 pad lanes, and
    slices them off again; against the reference's pool_rois and
    pool_rois_quantized at 20 channels (which pads to the TPU's lanes only
    on a TPU). Pooled values held as tests/test_torch_quant.py holds bf16
    pools; int8 codes within 1 in at most 1e-4 of them, scales rtol 2^-7.
    Every value and code is equal here."""
    model = dict(skip_reduce_dim=20, head_quant="int8" if quantized
                 else "none")
    jcfg, tcfg = _cfg(jpreset, **model), _cfg(preset, **model)
    jmodel = jbuild(jcfg.model)
    fmodel = jbuild(dataclasses.replace(jcfg.model, head_quant="none"))
    params = _tree(fmodel, 11)
    feats = jax.jit(lambda p, im: fmodel.apply(p, im, method=JNet.features))(
        params, _images(8))
    assert all(f.shape[-1] == 20 for f in feats.values())
    rois = _rois(9)
    tmodel = build_model(tcfg.model, device="cpu")
    tfeats = {k: _t(v) for k, v in feats.items()}
    if not quantized:
        want = jax.jit(lambda p, f, r: fmodel.apply(
            p, f, r, (64, 64), method=JNet.pool_rois))(params, feats, rois)
        got = tmodel.pool_rois(tfeats, torch.from_numpy(rois), (64, 64))
        assert got.shape == want.shape and got.shape[-1] == 20
        assert _assert_bf16_pool_close(got, _t(want)) == 0
        return
    bias = jnp.asarray(np.random.default_rng(12).normal(size=20) * 0.5,
                       jnp.bfloat16)
    pq, ps = jax.jit(lambda p, f, r, b: jmodel.apply(
        p, f, r, (64, 64), b, method=JNet.pool_rois_quantized))(
        params, feats, rois, bias)
    q, s = tmodel.pool_rois_quantized(tfeats, torch.from_numpy(rois),
                                      (64, 64), _t(bias))
    assert q.shape == pq.shape and q.shape[-1] == 20 and s.shape == ps.shape
    diff = np.abs(q.numpy().astype(np.int32) - np.asarray(pq, np.int32))
    assert diff.max() == 0 and np.asarray(pq).any()
    np.testing.assert_array_equal(s.numpy(), np.asarray(ps))
