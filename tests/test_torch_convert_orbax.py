"""tools/convert_orbax_checkpoint.py: a checkpoint the JAX package's
Checkpointer (orbax) wrote after 2 `tiny` steps converts into the port's
layout; the port's Checkpointer restores it with parameters, momentum,
count and step bit-equal to the reference's state, and one more step from
it matches the reference's next step within
tests/test_torch_train.py's one-step tolerances."""

import dataclasses
import importlib.util
import warnings
from pathlib import Path

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
from multipathnet_tpu.train import checkpoint as jckpt
from multipathnet_tpu.train import loop as jloop
from multipathnet_tpu.train import schedule as jschedule
from multipathnet_tpu_torch.core.config import preset
from multipathnet_tpu_torch.data import sampler as tsampler
from multipathnet_tpu_torch.models import convert
from multipathnet_tpu_torch.train import loop as tloop
from multipathnet_tpu_torch.train.checkpoint import Checkpointer

torch.set_num_threads(2)

_TOOL = Path(__file__).resolve().parents[1] / "tools" / \
    "convert_orbax_checkpoint.py"


def _load_tool():
    spec = importlib.util.spec_from_file_location("convert_orbax", _TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _configure(make_preset):
    cfg = make_preset("tiny")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, dtype="float32",
                                  train_roi_impl="pallas"),
        data=dataclasses.replace(cfg.data, hflip_prob=0.0),
        train=dataclasses.replace(cfg.train, warmup_steps=0,
                                  freeze_backbone_stages=2))


def _batch(rng, cfg, b=2):
    h, w = cfg.data.image_size
    images = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    src_hws = np.asarray([[h, w], [h - 14, w - 23]], np.float32)
    g, p = cfg.data.max_gt_per_image, cfg.data.max_proposals
    xy = rng.uniform(0, 36, (b, g, 2))
    wh = rng.uniform(8, 24, (b, g, 2))
    gt = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    gt_mask = np.zeros((b, g), bool)
    gt_mask[0, :4], gt_mask[1, :2] = True, True
    classes = rng.integers(1, cfg.model.num_classes, (b, g)).astype(np.int32)
    jitter = rng.normal(0, 3, (b, p, 4))
    props = (gt[:, rng.integers(0, 2, p)] + jitter).astype(np.float32)
    props[..., 2:] = np.maximum(props[..., 2:], props[..., :2] + 2)
    return jloop.Batch(images, src_hws, props, np.ones((b, p), bool), gt,
                       classes, gt_mask)


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), np.asarray(v)


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference's train step, its sample fixed and dropout off, 2
    steps then a third; the state after 2 saved by its Checkpointer with
    the run's config.json."""
    mp = pytest.MonkeyPatch()
    jcfg = _configure(jpreset)
    rng = np.random.default_rng(6)
    batch = _batch(rng, jcfg)
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
    _, scales = jax.jit(lambda im, hw: jtf.batch_resize_to_canvas(
        im, jcfg.data.image_size, hw))(batch.images, batch.src_hws)
    d, m = jcfg.data, jcfg.model
    sc = np.asarray(scales)[:, None, None]
    sample = jax.jit(lambda *a: jsampler.sample_batch(
        jax.random.key(9), *a, rois_per_image=d.rois_per_image,
        fg_fraction=d.fg_fraction, fg_iou_threshold=d.fg_iou_threshold,
        bg_iou_range=d.bg_iou_range, bbox_reg_means=m.bbox_reg_means,
        bbox_reg_stds=m.bbox_reg_stds))(
        batch.proposals * sc, batch.prop_mask, batch.gt_boxes * sc,
        batch.gt_classes, batch.gt_mask)
    mp.setattr(jsampler, "sample_batch", lambda *a, **k: sample)
    mp.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    tx, _ = jschedule.make_optimizer(jcfg.train)
    step_fn = jax.jit(jloop.make_train_step(jmodel, jcfg, tx))
    state = jloop.TrainState(jnp.zeros((), jnp.int32), params,
                             tx.init(params), jax.random.key(1))
    for _ in range(2):
        state, _ = step_fn(state, batch)
    run = tmp_path_factory.mktemp("ref_run")
    (run / "config.json").write_text(jcfg.to_json())
    ck = jckpt.Checkpointer(str(run / "ckpt"))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ck.save(state)
        ck.wait()
    third, metrics = step_fn(state, batch)
    mp.undo()
    return run, state, third, metrics, sample, batch


def test_converted_checkpoint_restores_bit_equal(reference_run, tmp_path):
    run, state, _, _, _, _ = reference_run
    tool = _load_tool()
    path = tool.convert_run(str(run), str(tmp_path / "port"))
    assert path == str(tmp_path / "port" / "ckpt" / "step_2.pt")
    assert (tmp_path / "port" / "config.json").read_text() == \
        (run / "config.json").read_text()

    tcfg = _configure(preset)
    trainer = tloop.Trainer(tcfg, device="cpu")
    restored = Checkpointer(str(tmp_path / "port" / "ckpt")).restore_latest(
        trainer, trainer.init_state(0))
    assert restored.step == 2 and restored.optimizer.count == 2
    want = dict(_leaves(state.params))
    got = dict(_leaves(convert.flax_from_state_dict(
        trainer.model.state_dict())))
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)

    def states(kind):
        return [x for x in jax.tree_util.tree_leaves(
            state.opt_state, is_leaf=lambda x: isinstance(x, kind))
            if isinstance(x, kind)]

    (trace,) = [s.trace for s in states(optax.TraceState)]
    (count,) = [s.count for s in states(optax.ScaleByScheduleState)]
    assert int(count) == 2
    opt = restored.optimizer
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    momentum = {names[id(p)]: opt.sgd.state[p]["momentum_buffer"]
                for p in opt.params}
    trainable = {n for n, p in trainer.model.named_parameters()
                 if p.requires_grad}
    assert set(momentum) == trainable and len(trainable) < len(names)
    want_m = convert.state_dict_from_flax(
        {"params": jax.tree.map(np.asarray, trace["params"])})
    for n in trainable:
        assert torch.equal(momentum[n], want_m[n]), n

    # the generator: seeded from the key data, the same on every convert
    tool.convert_run(str(run), str(tmp_path / "again"))
    again = torch.load(tmp_path / "again" / "ckpt" / "step_2.pt",
                       weights_only=True)
    assert again["generator"] == tool.generator_seed(
        jax.random.key_data(state.key))
    assert isinstance(again["generator"], int)


def test_step_after_conversion_follows_reference(reference_run, tmp_path,
                                                 monkeypatch):
    """The reference's third step against the port's first step from the
    converted checkpoint, the same sample: metrics rtol 1e-5, parameters
    atol 1e-6 (test_one_train_step_matches_reference's bars)."""
    run, _, third, want_m, sample, batch = reference_run
    _load_tool().convert_run(str(run), str(tmp_path / "port"))
    tcfg = _configure(preset)
    trainer = tloop.Trainer(tcfg, device="cpu")
    state = Checkpointer(str(tmp_path / "port" / "ckpt")).restore_latest(
        trainer, trainer.init_state(0))
    tsample = tsampler.RoiSample(*(torch.from_numpy(np.array(x))
                                   for x in sample))
    monkeypatch.setattr(tsampler, "sample_batch", lambda *a, **k: tsample)
    trainer.model.head.dropout_rate = 0.0
    state, got_m = trainer.step(state, tloop.Batch(*batch))
    assert state.step == 3 and state.optimizer.count == 3
    for name in want_m:
        np.testing.assert_allclose(float(got_m[name]), float(want_m[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    got = dict(_leaves(convert.flax_from_state_dict(
        trainer.model.state_dict())))
    for name, want in _leaves(third.params):
        np.testing.assert_allclose(got[name], want, atol=1e-6, rtol=0,
                                   err_msg=name)
