"""Port parity, the whole slice 8: the reference's own models through the
port's entry points against the JAX package, in float32 at 64^2.

`multipath_resnet18_integral` (ResNet-18 with frozen BN, fc_dim 64, skip
reduce 32, 5 classes; the JAX side through its Pallas pool kernels in
interpret mode) and `multipath_vgg16_reference` (VGG-16, roi_mode="max",
caffe_bgr, the exact max route; fc_dim 64, skip reduce 32, 5 classes): one
variable tree (params and, for ResNet, batch_stats) carried across by
models/convert.py; score_batch and detect_batch, then one train step each
from the same weights, the sample injected into both sides and dropout
off. And frozen BN under SGD with weight decay: the running statistics
never move."""

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
from test_torch_backbones import random_variables
from test_torch_detect import _inputs
from test_torch_train import _batch, _tree_leaves

torch.set_num_threads(2)

MODELS = {"resnet18": "multipath_resnet18_integral",
          "vgg16_reference": "multipath_vgg16_reference"}


def _cfg(make_preset, name, **model):
    """`tiny`'s data, eval and train settings around the named preset's
    model, cut to fc_dim 64, skip reduce 32 and 5 classes, in float32."""
    cfg = make_preset("tiny")
    m = dataclasses.replace(
        make_preset(MODELS[name]).model, fc_dim=64, skip_reduce_dim=32,
        num_classes=5, dtype="float32",
        **({"roi_impl": "pallas", "train_roi_impl": "pallas"}
           if name == "resnet18" else {}), **model)
    return cfg.replace(model=m)


def _variables(jmodel, seed):
    """random_variables, with the cls_bbox kernel doubled so the scores
    spread (NMS order not decided by ULPs) and, for a caffe_bgr trunk,
    the first convolution scaled by 1/128 as for pixels in 0-255 (a
    Caffe-trained trunk's first filters are sized so; unscaled, the
    activations reach 1e4 and the softmaxes saturate)."""
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0),
                            jnp.zeros((1, 64, 64, 3)),
                            jnp.asarray([[[0.0, 0.0, 16.0, 16.0]]]))
    variables = random_variables(shapes, seed)
    head = variables["params"]["head"]["cls_bbox"]
    head["kernel"] = head["kernel"] * 2.0
    if jmodel.cfg.preprocess == "caffe_bgr":
        conv = variables["params"]["backbone"]["conv1_1"]
        conv["kernel"] = conv["kernel"] / 128.0
    return variables


@pytest.fixture(scope="module", params=sorted(MODELS))
def slice_pair(request):
    name = request.param
    jcfg, tcfg = _cfg(jpreset, name), _cfg(preset, name)
    jmodel = jbuild(jcfg.model)
    variables = _variables(jmodel, 11)
    tmodel = convert.load_flax_params(build_model(tcfg.model, device="cpu"),
                                      variables)
    return name, (jmodel, variables, jcfg), (tmodel.eval(), tcfg)


def test_score_batch_matches_reference(slice_pair):
    """Probabilities within 1e-5 (as tests/test_torch_detect.py holds the
    `tiny` slice); boxes within 1e-3 + 1e-4 relative: ResNet-18's float32
    convolutions sum in another order than XLA's, and the box decode's
    exp carries the difference to boxes of up to 64 px (seen 1.03e-3 at
    22.3 px)."""
    name, (jmodel, variables, jcfg), (tmodel, tcfg) = slice_pair
    images, src_hws, proposals, _ = _inputs()
    want_b, want_p = jax.jit(partial(jdetect.score_batch, model=jmodel,
                                     cfg=jcfg))(
        variables, images_u8=images, src_hws=src_hws, proposals=proposals)
    got_b, got_p = tdetect.score_batch(
        tmodel, tcfg, *(torch.from_numpy(x) for x in
                        (images, src_hws, proposals)))
    assert got_p.shape == want_p.shape and got_b.shape == want_b.shape
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-5)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), atol=1e-3,
                               rtol=1e-4)
    assert np.asarray(want_p).std() > 0.05, name


def test_detect_batch_matches_reference(slice_pair):
    """Detector against the reference's detect_batch: valid, classes and
    indices equal; scores within 1e-5, boxes within 1e-3 + 1e-4 relative
    (test_score_batch_matches_reference says why)."""
    name, (jmodel, variables, jcfg), (tmodel, tcfg) = slice_pair
    inputs = _inputs()
    want = jax.jit(lambda p, *a: jdetect.detect_batch(p, jmodel, jcfg, *a))(
        variables, *inputs)
    got = tdetect.Detector(tmodel, tcfg, "cpu")(*inputs)
    for key in ("valid", "classes", "indices"):
        np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                      err_msg=key)
    np.testing.assert_allclose(got["scores"], np.asarray(want["scores"]),
                               atol=1e-5)
    np.testing.assert_allclose(got["boxes"], np.asarray(want["boxes"]),
                               atol=1e-3, rtol=1e-4)
    assert got["valid"].any(), name


def test_windowed_max_route_matches_reference():
    """multipath_vgg16_reference with roi_impl="pyramid" on both sides:
    the windowed max route (max pyramids, window masks) end to end."""
    jcfg = _cfg(jpreset, "vgg16_reference", roi_impl="pyramid")
    tcfg = _cfg(preset, "vgg16_reference", roi_impl="pyramid")
    jmodel = jbuild(jcfg.model)
    variables = _variables(jmodel, 12)
    tmodel = convert.load_flax_params(build_model(tcfg.model, device="cpu"),
                                      variables).eval()
    images, src_hws, proposals, _ = _inputs(1)
    want_b, want_p = jax.jit(partial(jdetect.score_batch, model=jmodel,
                                     cfg=jcfg))(
        variables, images_u8=images, src_hws=src_hws, proposals=proposals)
    got_b, got_p = tdetect.score_batch(
        tmodel, tcfg, *(torch.from_numpy(x) for x in
                        (images, src_hws, proposals)))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-5)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), atol=1e-3)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_one_train_step_matches_reference(name, monkeypatch):
    """One step from the same weights (stages 1-2 frozen), the sample
    drawn once and injected into both sides, dropout off; the reference's
    max mode trains through its exact oracle, the port through ops/roi.py.
    For the max route the reference's canvases are injected too: the
    port's resize agrees with it to 1e-5 of the pixel range (tests/
    test_torch_ops.py), but a max's gradient jumps with its input, so such
    a difference moves some bins' argmax cells (conv5_3's gradient then
    differs by 2%; with the canvases injected, within 1e-4).
    Tolerances as tests/test_torch_train.py: metrics rtol 1e-5, but the
    gradient norm rtol 1e-4 as the gradients (VGG-16's 13 float32
    convolutions sum in another order than XLA's: seen 3.4e-5); each
    gradient within 1e-4 of its tensor's largest magnitude; parameters
    atol 1e-6, or lr times that gradient tolerance where it is larger (the
    SGD step carries the gradient's difference into the parameter: seen
    1.14e-6 in ResNet-18's stage3_block0.Conv_0). Frozen parameters get no
    gradient, BN statistics none."""
    from test_torch_train import _t

    def configure(make_preset):
        cfg = _cfg(make_preset, name)
        return cfg.replace(
            data=dataclasses.replace(cfg.data, hflip_prob=0.0),
            train=dataclasses.replace(cfg.train, warmup_steps=0,
                                      freeze_backbone_stages=2))

    jcfg, tcfg = configure(jpreset), configure(preset)
    rng = np.random.default_rng(6)
    batch = _batch(rng, tcfg)
    jmodel = jbuild(jcfg.model, freeze_stages=2)
    variables = _variables(jmodel, 13)

    canvases, scales = jax.jit(lambda im, hw: jtf.batch_resize_to_canvas(
        im, jcfg.data.image_size, hw, preprocess=jcfg.model.preprocess))(
        batch.images, batch.src_hws)
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
        scores, deltas = jmodel.apply({**variables, "params": p}, canvases,
                                      sample.rois, train=True)
        return jlosses.detection_loss(scores, deltas, sample, **loss_kw)[0]

    want_grads = jax.jit(jax.grad(loss_fn))(variables["params"])
    tx, _ = jschedule.make_optimizer(jcfg.train)
    jstate = jloop.TrainState(jnp.zeros((), jnp.int32), variables,
                              tx.init(variables), jax.random.key(1))
    jstate, want_m = jax.jit(jloop.make_train_step(jmodel, jcfg, tx))(
        jstate, jloop.Batch(*batch))

    tsample = tsampler.RoiSample(*map(_t, sample))
    monkeypatch.setattr(tsampler, "sample_batch", lambda *a, **k: tsample)
    if name == "vgg16_reference":
        tcanvases = (_t(canvases), _t(scales))
        monkeypatch.setattr(tloop.transforms, "batch_resize_to_canvas",
                            lambda *a, **k: tcanvases)
    trainer = tloop.Trainer(tcfg, device="cpu")
    state = trainer.init_state(0)
    convert.load_flax_params(trainer.model, variables)
    buffers = {n: b.clone() for n, b in trainer.model.named_buffers()}
    trainer.model.head.dropout_rate = 0.0
    state, got_m = trainer.step(state, batch)

    assert set(got_m) == set(want_m)
    for key in want_m:
        # grad_norm is a gradient: it gets the gradients' 1e-4
        rtol = 1e-4 if key == "grad_norm" else 1e-5
        np.testing.assert_allclose(float(got_m[key]), float(want_m[key]),
                                   rtol=rtol, atol=1e-6, err_msg=key)
    assert float(got_m["num_fg"]) > 0
    got_grads = dict(_tree_leaves(convert.flax_from_state_dict(
        {n: (p.grad if p.grad is not None else torch.zeros_like(p))
         for n, p in trainer.model.named_parameters()})))
    want_grads = dict(_tree_leaves({"params": want_grads}))
    assert set(got_grads) == set(want_grads)
    frozen = {n for n, p in trainer.model.named_parameters()
              if not p.requires_grad}
    assert frozen == trainer.frozen and frozen
    lr = float(trainer.lr_schedule(0))  # no warmup: the base lr
    atol = {}
    for key, want in want_grads.items():
        scale = max(np.abs(want).max(), 1e-30)
        err = np.abs(got_grads[key] - want).max() / scale
        assert err < 1e-4, (key, err)
        atol[key] = max(1e-6, lr * 1e-4 * scale)
    got_params = dict(_tree_leaves(convert.flax_from_state_dict(
        trainer.model.state_dict())))
    for key, want in _tree_leaves(jstate.params):
        np.testing.assert_allclose(got_params[key], want, rtol=0,
                                   atol=atol.get(key, 1e-6), err_msg=key)
    for n, b in trainer.model.named_buffers():
        assert torch.equal(b, buffers[n]), n


def test_bn_running_stats_never_train():
    """The counterpart of tests/test_train.py's
    test_bn_running_stats_never_train: ResNet-18 at `tiny`, no stage
    frozen, weight decay on, two SGD steps with momentum. Every BN running
    mean and variance is bit-identical afterwards (buffers: no gradient, no
    decay, no momentum), while the BN scales and the convolutions train."""
    cfg = preset("tiny")
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, backbone="resnet18"),
        train=dataclasses.replace(cfg.train, freeze_backbone_stages=0))
    assert cfg.train.weight_decay > 0 and cfg.train.momentum > 0
    trainer = tloop.Trainer(cfg, device="cpu")
    state = trainer.init_state(0)
    with torch.no_grad():  # statistics that decay would visibly move
        for n, b in trainer.model.named_buffers():
            b.copy_(torch.rand(b.shape, generator=torch.Generator()
                               .manual_seed(len(n))) + 0.5)
    stats = {n: b.clone() for n, b in trainer.model.named_buffers()}
    params = {n: p.detach().clone()
              for n, p in trainer.model.named_parameters()}
    assert stats and not set(stats) & set(params)
    opt_ids = {id(p) for g in state.optimizer.sgd.param_groups
               for p in g["params"]}
    assert not any(id(b) in opt_ids for b in trainer.model.buffers())
    batch = _batch(np.random.default_rng(3), cfg)
    for _ in range(2):
        state, metrics = trainer.step(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    for n, b in trainer.model.named_buffers():
        assert torch.equal(b, stats[n]), n
    now = dict(trainer.model.named_parameters())
    assert not torch.equal(now["backbone.stem_bn.weight"],
                           params["backbone.stem_bn.weight"])
    assert not torch.equal(now["backbone.stage2_block0.Conv_0.weight"],
                           params["backbone.stage2_block0.Conv_0.weight"])


def test_resnet_bundle_and_checkpoint_restore_exactly(tmp_path):
    """A ResNet-18 model's serving bundle and train checkpoint carry its BN
    buffers: after one train step (BN statistics drawn, no stage frozen),
    a Checkpointer restore into a fresh Trainer and a bundle loaded by
    load_detector both give a model whose every parameter and buffer
    equals the original's, and the bundle's Detector detects what the
    original detects (exact)."""
    from multipathnet_tpu_torch.eval.serving import load_detector, save_bundle
    from multipathnet_tpu_torch.train.checkpoint import Checkpointer

    cfg = preset("tiny")
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, backbone="resnet18"),
        train=dataclasses.replace(cfg.train, freeze_backbone_stages=0))
    trainer = tloop.Trainer(cfg, device="cpu")
    state = trainer.init_state(0)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for _, b in trainer.model.named_buffers():
            b.copy_(torch.rand(b.shape, generator=gen) + 0.5)
    state, _ = trainer.step(state, _batch(np.random.default_rng(2), cfg))
    ckpt = Checkpointer(str(tmp_path / "ck"))
    ckpt.save(trainer, state)
    fresh = tloop.Trainer(cfg, device="cpu")
    restored = ckpt.restore_latest(fresh, fresh.init_state(1))
    assert restored.step == 1
    want = trainer.model.state_dict()
    got = fresh.model.state_dict()
    assert set(got) == set(want) and any("running_var" in k for k in got)
    for k in want:
        assert torch.equal(got[k], want[k]), k

    tree = convert.flax_from_state_dict(want)
    save_bundle(str(tmp_path / "bundle"), cfg, tree)
    det = load_detector(str(tmp_path / "bundle"), device="cpu")
    for k, v in det.model.state_dict().items():
        assert torch.equal(v, want[k].to(v.dtype)), k
    eval_model = build_model(cfg.model, device="cpu")
    convert.load_flax_params(eval_model, tree)
    inputs = _inputs()
    a = tdetect.Detector(eval_model, cfg, "cpu")(*inputs)
    b = det(*inputs)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
