"""Port parity, training: the sampler, integral labels, detection loss, LR
schedule and optimizer of multipathnet_tpu_torch against the JAX package on
the same numpy inputs, frozen stages, and one whole train step at the
`tiny` preset in float32 (the JAX side through its Pallas pool kernels in
interpret mode, the sample injected into both sides, dropout off)."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multipathnet_tpu.core.config import preset as jpreset
from multipathnet_tpu.data import sampler as jsampler
from multipathnet_tpu.data import transforms as jtf
from multipathnet_tpu.models.multipath import build_model as jbuild
from multipathnet_tpu.train import loop as jloop
from multipathnet_tpu.train import losses as jlosses
from multipathnet_tpu.train import schedule as jschedule
from multipathnet_tpu_torch.core.config import TrainConfig, preset
from multipathnet_tpu_torch.data import sampler as tsampler
from multipathnet_tpu_torch.models import convert
from multipathnet_tpu_torch.models.backbones.vgg import VGG16
from multipathnet_tpu_torch.train import loop as tloop
from multipathnet_tpu_torch.train import losses as tlosses
from multipathnet_tpu_torch.train import schedule as tschedule

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _boxes(rng, shape, hi=50.0, lo_wh=4.0, hi_wh=24.0):
    xy = rng.uniform(0, hi, (*shape, 2))
    wh = rng.uniform(lo_wh, hi_wh, (*shape, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _gt(rng, b, g, n_valid):
    gt = _boxes(rng, (b, g), hi=40.0, lo_wh=8.0)
    classes = rng.integers(1, 5, (b, g)).astype(np.int32)
    mask = np.arange(g)[None, :] < np.asarray(n_valid)[:, None]
    return gt, classes, mask


def _proposals(rng, gt, p):
    """Half the proposals jittered around GT (fg exists), half anywhere."""
    b, g = gt.shape[:2]
    near = gt[np.arange(b)[:, None], rng.integers(0, g, (b, p // 2))]
    near = near + rng.normal(0, 3.0, near.shape).astype(np.float32)
    far = _boxes(rng, (b, p - p // 2))
    return np.concatenate([near, far], 1)


def _sample_np(sample):
    return {k: np.asarray(v) for k, v in sample._asdict().items()}


# --------------------------------------------------------------- sampler ---

@pytest.mark.parametrize("p", [20, 200], ids=["pool<k", "pool>k"])
def test_sampler_matches_reference_on_its_draws(p):
    """The pure sampler fed the reference's own uniform draws. With 20
    proposals the pool (24 boxes) is smaller than the 48 bg slots, so the
    -1 scores tie and the slots pad; with 200 the fg pool still is."""
    rng = np.random.default_rng(0)
    b, g = 2, 4
    gt, classes, gt_mask = _gt(rng, b, g, [4, 2])
    props = _proposals(rng, gt, p)
    prop_mask = rng.uniform(size=(b, p)) > 0.1
    kw = dict(rois_per_image=64, fg_fraction=0.25, fg_iou_threshold=0.5,
              bg_iou_range=(0.1, 0.5), bbox_reg_means=(0.0, 0.0, 0.0, 0.0),
              bbox_reg_stds=(0.1, 0.1, 0.2, 0.2))
    key = jax.random.key(3)
    want = _sample_np(jax.jit(lambda *a: jsampler.sample_batch(
        key, *a, **kw))(props, prop_mask, gt, classes, gt_mask))
    # the reference's draws: sample_batch splits per image, sample_rois
    # splits into (fg, bg), each a uniform over the P + G pool
    noise = np.stack([np.stack([np.asarray(jax.random.uniform(k, (p + g,)))
                                for k in jax.random.split(ki)])
                      for ki in jax.random.split(key, b)])
    got = _sample_np(tsampler.sample_rois(
        _t(noise), _t(props), _t(prop_mask), _t(gt), _t(classes),
        _t(gt_mask), **kw))
    for name in ("matched_class", "is_fg", "valid"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    for name in ("rois", "max_iou", "bbox_targets"):
        np.testing.assert_allclose(got[name], want[name], atol=1e-6,
                                   rtol=1e-6, err_msg=name)
    assert got["is_fg"].any() and (~got["valid"]).any() == (p == 20)
    # the generator-driven entry point gives a well-formed sample
    s = tsampler.sample_batch(torch.Generator().manual_seed(0), _t(props),
                              _t(prop_mask), _t(gt), _t(classes),
                              _t(gt_mask), **kw)
    assert s.rois.shape == (b, 64, 4) and s.matched_class.dtype == torch.int32


def test_integral_labels_match_reference():
    rng = np.random.default_rng(1)
    cls = rng.integers(0, 5, (3, 16)).astype(np.int32)
    iou = rng.choice([0.3, 0.5, 0.55, 0.6, 0.62, 0.7, 0.75, 0.9], (3, 16)
                     ).astype(np.float32)
    fg = rng.uniform(size=(3, 16)) > 0.3
    thr = (0.5, 0.55, 0.6, 0.65, 0.7, 0.75)
    want = np.asarray(jsampler.integral_labels(cls, iou, fg, thr))
    got = tsampler.integral_labels(_t(cls), _t(iou), _t(fg), thr)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------------ loss ---

@pytest.mark.parametrize("agg", ["mean", "sum"])
@pytest.mark.parametrize("class_specific", [True, False],
                         ids=["per-class", "shared"])
def test_detection_loss_matches_reference(agg, class_specific):
    rng = np.random.default_rng(2)
    b, s, k, c = 2, 16, 3, 5
    sample = jsampler.RoiSample(
        rois=_boxes(rng, (b, s)),
        matched_class=rng.integers(0, c, (b, s)).astype(np.int32),
        max_iou=rng.uniform(0, 1, (b, s)).astype(np.float32),
        bbox_targets=rng.normal(size=(b, s, 4)).astype(np.float32),
        is_fg=rng.uniform(size=(b, s)) > 0.6,
        valid=rng.uniform(size=(b, s)) > 0.1)
    scores = rng.normal(size=(b, s, k, c)).astype(np.float32) * 3
    deltas = rng.normal(size=(b, s, 4 * c if class_specific else 4)
                        ).astype(np.float32) * 2
    kw = dict(integral_thresholds=(0.5, 0.6, 0.7), num_classes=c,
              class_specific_bbox=class_specific, integral_agg=agg)
    want_l, want_m = jlosses.detection_loss(scores, deltas, sample, **kw)
    got_l, got_m = tlosses.detection_loss(
        _t(scores), _t(deltas), tsampler.RoiSample(*map(_t, sample)), **kw)
    assert set(got_m) == set(want_m)
    for name in want_m:
        np.testing.assert_allclose(float(got_m[name]), float(want_m[name]),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-6)
    x = np.linspace(-3, 3, 13).astype(np.float32)
    np.testing.assert_allclose(tlosses.smooth_l1(_t(x)).numpy(),
                               np.asarray(jlosses.smooth_l1(x)), atol=1e-7)


# ----------------------------------------------------- schedule, optimizer ---

@pytest.mark.parametrize("warmup", [0, 5])
def test_lr_schedule_matches_optax(warmup):
    cfg = TrainConfig(lr=2e-2, warmup_steps=warmup, lr_decay_steps=(20, 40),
                      lr_decay_factor=0.1)
    want = jschedule.make_lr_schedule(cfg)
    got = tschedule.make_lr_schedule(cfg)
    steps = {0, 1, max(warmup - 1, 0), warmup}
    for bound in (20, 40):
        steps |= {bound - 1, bound, bound + 1,
                  warmup + bound - 1, warmup + bound, warmup + bound + 1}
    for step in sorted(steps):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   atol=0, err_msg=f"step {step}")
    if warmup:
        assert got(0) == 0.0


@pytest.mark.parametrize("clip", [0.0, 0.5], ids=["no-clip", "clip"])
def test_optimizer_updates_match_optax_chain(clip):
    """Three steps (the first at lr 0 under warmup) of make_optimizer
    against the reference's chain clip -> add_decayed_weights -> sgd."""
    cfg = TrainConfig(lr=0.1, momentum=0.9, weight_decay=5e-4,
                      warmup_steps=2, lr_decay_steps=(2,),
                      lr_decay_factor=0.5, grad_clip_norm=clip)
    rng = np.random.default_rng(4)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {"params": {k: rng.normal(size=s).astype(np.float32)
                         for k, s in shapes.items()}}
    tx, _ = jschedule.make_optimizer(cfg)
    opt_state = tx.init(params)
    tparams = {k: _t(v).requires_grad_() for k, v in params["params"].items()}
    opt, _ = tschedule.make_optimizer(cfg, list(tparams.values()))
    for _ in range(3):
        grads = {"params": {k: rng.normal(size=s).astype(np.float32)
                            for k, s in shapes.items()}}
        norm = float(optax.global_norm(grads))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        for k, p in tparams.items():
            p.grad = _t(grads["params"][k])
        got_norm = opt.step()
        np.testing.assert_allclose(float(got_norm), norm, rtol=1e-6)
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(params["params"][k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    if clip:
        assert norm > clip   # the clip was exercised


# -------------------------------------------------------- frozen stages ---

def test_vgg16_freeze_stages_detach_blocks():
    vgg = VGG16(dtype=torch.float32, freeze_stages=2)
    assert VGG16.frozen_prefixes(2) == ("conv1_", "conv2_")
    x = torch.randn(1, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    sum(f.sum() for f in vgg(x).values()).backward()
    for name, p in vgg.named_parameters():
        frozen = name.startswith(("conv1_", "conv2_"))
        assert (p.grad is None) == frozen, name
    assert vgg.conv3_1.weight.grad.abs().sum() > 0


def test_trainer_freezes_stages():
    """freeze_backbone_stages=2 on the tiny trunk: no gradient for conv1 and
    conv2, bit-identical parameters after a step, all others moved."""
    cfg = preset("tiny")
    cfg = cfg.replace(train=dataclasses.replace(
        cfg.train, freeze_backbone_stages=2))
    trainer = tloop.Trainer(cfg, device="cpu")
    state = trainer.init_state(0)
    before = {n: p.detach().clone()
              for n, p in trainer.model.named_parameters()}
    batch = _batch(np.random.default_rng(5), cfg)
    state, metrics = trainer.step(state, batch)
    assert state.step == 1 and np.isfinite(float(metrics["loss"]))
    assert trainer.frozen == {f"backbone.conv{i}.{w}" for i in (1, 2)
                              for w in ("weight", "bias")}
    for name, p in trainer.model.named_parameters():
        if name in trainer.frozen:
            assert p.grad is None or not p.grad.any(), name
            assert torch.equal(p, before[name]), name
        else:
            assert not torch.equal(p, before[name]), name


def test_head_dropout_follows_flax_semantics():
    """Train mode keeps each unit with probability 1 - rate and scales it by
    1 / (1 - rate), the mask from the given generator; eval is the
    identity."""
    from multipathnet_tpu_torch.models.heads import MultiPathHead

    head = MultiPathHead(num_classes=3, fc_dim=8, skip_reduce_dim=4,
                         num_integral_heads=1, dtype=torch.float32)
    h = torch.ones(400, 64)
    out = head._dropout(h, True, torch.Generator().manual_seed(7))
    gen = torch.Generator().manual_seed(7)
    keep = torch.rand(h.shape, generator=gen) < 0.5
    torch.testing.assert_close(out, torch.where(keep, 2.0, 0.0))
    assert 0.45 < float(keep.float().mean()) < 0.55
    assert head._dropout(h, False, None) is h


def test_weight_bridge_round_trip_keeps_float32():
    """flax -> torch -> flax is the identity, and a training model (float32
    parameters, bf16 compute) loads the float32 values exactly."""
    from multipathnet_tpu_torch.models.multipath import build_model

    cfg = preset("tiny").model          # bf16 compute
    model = build_model(cfg, param_dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(8)
    tree = convert.flax_from_state_dict(
        {k: torch.from_numpy(rng.normal(size=v.shape).astype(np.float32))
         for k, v in model.state_dict().items()})
    convert.load_flax_params(model, tree)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    back = dict(_tree_leaves(convert.flax_from_state_dict(
        model.state_dict())))
    for name, want in _tree_leaves(tree):
        np.testing.assert_array_equal(back[name], want, err_msg=name)
    conv = tree["params"]["backbone"]["conv1"]["kernel"]
    assert conv.shape == (3, 3, 3, 8)    # HWIO


def test_trainer_is_float_only():
    cfg = preset("tiny")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                head_quant="int8"))
    with pytest.raises(ValueError, match="float-only"):
        tloop.Trainer(cfg, device="cpu")


# ------------------------------------------------------------- one step ---

def _batch(rng, cfg, b=2):
    h, w = cfg.data.image_size
    images = rng.integers(0, 256, (b, h - 4, w, 3), dtype=np.uint8)
    src_hws = np.asarray([[h - 4, w], [h - 14, w - 23]], np.float32)[:b]
    gt, classes, gt_mask = _gt(rng, b, cfg.data.max_gt_per_image, [5, 3][:b])
    props = _proposals(rng, gt, cfg.data.max_proposals)
    prop_mask = np.ones(props.shape[:2], bool)
    prop_mask[-1, -4:] = False
    return tloop.Batch(images, src_hws, props, prop_mask, gt, classes,
                       gt_mask)


def _tree_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _tree_leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


def test_one_train_step_matches_reference(monkeypatch):
    """tiny, float32, train_roi_impl='pallas' on the JAX side, conv1-2
    frozen. Loss and metrics, every gradient (through the weight bridge)
    and every parameter after the SGD step. Tolerances: metrics rtol 1e-5;
    each gradient within 1e-4 of its tensor's largest magnitude (float32
    convolutions and GEMMs sum in another order); parameters atol 1e-6."""
    def configure(make_preset):
        cfg = make_preset("tiny")
        return cfg.replace(
            model=dataclasses.replace(cfg.model, dtype="float32",
                                      train_roi_impl="pallas"),
            data=dataclasses.replace(cfg.data, hflip_prob=0.0),
            train=dataclasses.replace(cfg.train, warmup_steps=0,
                                      freeze_backbone_stages=2))

    jcfg, tcfg = configure(jpreset), configure(preset)
    rng = np.random.default_rng(6)
    batch = _batch(rng, tcfg)
    jmodel = jbuild(jcfg.model, freeze_stages=2)
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0),
                            jnp.zeros((1, 64, 64, 3)),
                            jnp.zeros((1, 1, 4)))

    def leaf(path, s):
        if "kernel" in jax.tree_util.keystr(path):
            fan_in = int(np.prod(s.shape[:-1]))
            return (rng.normal(size=s.shape) * np.sqrt(2.0 / fan_in)
                    ).astype(np.float32)
        return (rng.normal(size=s.shape) * 0.1).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(leaf, shapes)

    # the sample, drawn once on the canvas-scaled boxes, for both sides
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

    want_grads = jax.jit(jax.grad(loss_fn))(params)
    tx, _ = jschedule.make_optimizer(jcfg.train)
    jstate = jloop.TrainState(jnp.zeros((), jnp.int32), params,
                              tx.init(params), jax.random.key(1))
    jstate, want_m = jax.jit(jloop.make_train_step(jmodel, jcfg, tx))(
        jstate, jloop.Batch(*batch))

    tsample = tsampler.RoiSample(*map(_t, sample))
    monkeypatch.setattr(tsampler, "sample_batch", lambda *a, **k: tsample)
    trainer = tloop.Trainer(tcfg, device="cpu")
    state = trainer.init_state(0)
    convert.load_flax_params(trainer.model, params)
    trainer.model.head.dropout_rate = 0.0
    state, got_m = trainer.step(state, batch)

    assert set(got_m) == set(want_m)
    for name in want_m:
        np.testing.assert_allclose(float(got_m[name]), float(want_m[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    assert float(got_m["num_fg"]) > 0
    got_grads = dict(_tree_leaves(convert.flax_from_state_dict(
        {n: (p.grad if p.grad is not None else torch.zeros_like(p))
         for n, p in trainer.model.named_parameters()})))
    want_grads = dict(_tree_leaves(want_grads))
    assert set(got_grads) == set(want_grads)
    for name, want in want_grads.items():
        scale = max(np.abs(want).max(), 1e-30)
        err = np.abs(got_grads[name] - want).max() / scale
        assert err < 1e-4, (name, err)
        assert ("conv1" in name or "conv2" in name) == (scale == 1e-30), name
    got_params = dict(_tree_leaves(convert.flax_from_state_dict(
        trainer.model.state_dict())))
    for name, want in _tree_leaves(jstate.params):
        np.testing.assert_allclose(got_params[name], want, atol=1e-6,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_step_repeats_from_a_snapshot(dtype):
    """snapshot_train_state / restore_train_state: two steps from one saved
    state (parameters, momentum, count, generator; dropout on) give equal
    loss and parameters, bit for bit, and differ from the saved ones."""
    cfg = preset("tiny")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dtype=dtype))
    batch = _batch(np.random.default_rng(8), cfg)
    trainer = tloop.Trainer(cfg, device="cpu")
    state, _ = trainer.step(trainer.init_state(0), batch)
    saved = tloop.snapshot_train_state(trainer, state)
    runs = []
    for _ in range(2):
        state = tloop.restore_train_state(trainer, saved)
        state, metrics = trainer.step(state, batch)
        runs.append((float(metrics["loss"]), state.step,
                     {n: p.detach().clone()
                      for n, p in trainer.model.named_parameters()}))
    (loss_a, step_a, a), (loss_b, step_b, b) = runs
    assert loss_a == loss_b and step_a == step_b == saved["step"] + 1
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert any(not torch.equal(a[n], saved["params"][n]) for n in a)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_float32_train_steps_repeat_with_four_threads(seed):
    """Two float32 `tiny` steps from one snapshot, 4 threads: every
    parameter equal bit for bit. Before the plain pool backwards summed in
    a fixed order (ops/scatter.py), each of these batches gave trunk and
    reduce gradients that differed in their last bits between the two
    runs (ROADMAP C7)."""
    cfg = preset("tiny")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dtype="float32"))
    batch = _batch(np.random.default_rng(seed), cfg)
    torch.set_num_threads(4)
    try:
        trainer = tloop.Trainer(cfg, device="cpu")
        state, _ = trainer.step(trainer.init_state(0), batch)
        saved = tloop.snapshot_train_state(trainer, state)
        runs = []
        for _ in range(2):
            state, _ = trainer.step(tloop.restore_train_state(trainer, saved),
                                    batch)
            runs.append({n: p.detach().clone()
                         for n, p in trainer.model.named_parameters()})
    finally:
        torch.set_num_threads(2)
    for n in runs[0]:
        assert torch.equal(runs[0][n], runs[1][n]), n


def test_train_steps_follow_reference_in_lockstep(tmp_path):
    """Two epochs (8 steps) of the `tiny` overfit fixture in float32 from
    the port's init, flips, ROI sampling and dropout on: the reference's
    train step (its Pallas route in interpret mode), fed the same batches
    and weights and the port's own draws of each step (tests/
    overfit_seeds.lockstep), follows the port's run. Every metric of every
    step within rtol 1e-5 (seen 3.5e-7), every parameter at the end within
    atol 1e-5 (seen 6e-8): momentum, weight decay and the draws' use agree
    over many steps, not only the first."""
    import overfit_seeds

    fx = overfit_seeds.fixture(str(tmp_path))
    (run,) = overfit_seeds.lockstep(fx, [1], dtype="float32", epochs=2,
                                    evaluate=False)
    assert len(run["metrics"]) == 8
    for i, (got, want) in enumerate(run["metrics"]):
        assert set(got) == set(want)
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                       atol=1e-6, err_msg=f"{name}, step {i}")
    assert run["drift"] < 1e-5, run["drift"]
    assert min(m["num_fg"] for m, _ in run["metrics"]) > 0
