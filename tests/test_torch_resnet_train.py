"""Fine-tuning on a bottleneck ResNet trunk (preset multipath_resnet101_train:
multipath_vgg16_train with backbone resnet101, the stem and conv2_x
frozen): the port's Trainer.step against the JAX package's train step on
the CPU over three steps, and the spans features.stage3.backward and
features.stage4.backward that a traced step puts around the training
stages' backward.

The parity test runs ResNet-101 itself (30 bottlenecks, 64-1024 channels)
in float32 on a 64 x 64 canvas, with the head cut to fc_dim 64, skip
reduce 32 and 5 classes; both sides start from one variable tree (He
kernels, BN statistics with positive variances), the sample is drawn once
and injected into both, and dropout and the flip are off, so the three
steps see the same inputs; the rate is the preset's 1e-3, without
warm-up. Tolerances, each for float32 sums taken in another order than
XLA's through 94 convolutions and three SGD steps:
- the losses and the other metrics rtol 1e-5 (seen up to 9.2e-7, the
  gradient norm);
- each training leaf's change over the three steps within 2e-3 of that
  change's largest magnitude (seen up to 3.8e-4, a conv3_x 1x1 kernel:
  its gradient is a sum over the whole 16 x 16 c4 map of products that
  passed through up to 26 bottlenecks, each rounded in its own order).
The JAX step compiles in about 21 s on the CPU, the test about 45 s.
Frozen parameters (stem, stem_bn, conv2_x) and every BN statistic stay
bit-equal, and conv3_x and conv4_x weights and BN scales move.
"""

import dataclasses
import time

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multipathnet_tpu.core.config import preset as jpreset
from multipathnet_tpu.data import sampler as jsampler
from multipathnet_tpu.data import transforms as jtf
from multipathnet_tpu.models.multipath import build_model as jbuild
from multipathnet_tpu.train import loop as jloop
from multipathnet_tpu.train import schedule as jschedule
from multipathnet_tpu_torch.core.config import preset
from multipathnet_tpu_torch.data import sampler as tsampler
from multipathnet_tpu_torch.models import convert
from multipathnet_tpu_torch.train import loop as tloop
from multipathnet_tpu_torch.utils import profiling
from test_torch_backbones import random_variables
from test_torch_train import _batch, _t, _tree_leaves

torch.set_num_threads(2)

PRESET = "multipath_resnet101_train"
STEPS = 3
CANVAS = 64


def _cfg(make_preset, name):
    """`tiny`'s data and schedule around preset `name`'s model (the JAX
    package's multipath_vgg16_train with backbone resnet101 where the
    preset is the port's own), the head cut, float32, the flip off and
    the preset's freeze of the stem and conv2_x."""
    base = make_preset("tiny")
    full = make_preset(name)
    model = dataclasses.replace(
        full.model, backbone="resnet101", fc_dim=64, skip_reduce_dim=32,
        num_classes=5, dtype="float32", roi_impl="pallas",
        train_roi_impl="pallas")
    return base.replace(
        model=model,
        data=dataclasses.replace(base.data, hflip_prob=0.0),
        train=dataclasses.replace(full.train, warmup_steps=0,
                                  batch_size=base.train.batch_size))


def _variables(jmodel, seed):
    """random_variables with each BN scale in [0.2, 0.6] (the benchmark's
    draw): at its [0.5, 1.5] the 30 residual sums grow the c5 tap past
    1e3 and the first loss reaches about 5e5."""
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0),
                            jnp.zeros((1, CANVAS, CANVAS, 3)),
                            jnp.asarray([[[0.0, 0.0, 16.0, 16.0]]]))
    variables = random_variables(shapes, seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, v: v * 0.4 if "'scale'" in jax.tree_util.keystr(path)
        else v, variables)


def test_preset_is_the_vgg16_train_preset_on_resnet101():
    got, want = preset(PRESET), preset("multipath_vgg16_train")
    assert got.model == dataclasses.replace(want.model, backbone="resnet101")
    assert (got.data, got.train, got.eval) == (want.data, want.train,
                                               want.eval)
    assert got.train.freeze_backbone_stages == 2
    assert got.model.head_quant == "none" and got.model.dtype == "bfloat16"


def test_three_steps_match_reference(monkeypatch):
    jcfg = _cfg(jpreset, "multipath_vgg16_train")
    tcfg = _cfg(preset, PRESET)
    assert dataclasses.asdict(jcfg.model) == dataclasses.asdict(tcfg.model)
    rng = np.random.default_rng(5)
    batch = _batch(rng, tcfg)
    jmodel = jbuild(jcfg.model, freeze_stages=2)
    variables = _variables(jmodel, 17)

    # the reference's own sample of the batch, injected into both sides
    d, m = jcfg.data, jcfg.model
    _, scales = jax.jit(lambda im, hw: jtf.batch_resize_to_canvas(
        im, d.image_size, hw, preprocess=m.preprocess))(batch.images,
                                                       batch.src_hws)
    scales = np.asarray(scales)
    sample = jax.jit(lambda *a: jsampler.sample_batch(
        jax.random.key(9), *a, rois_per_image=d.rois_per_image,
        fg_fraction=d.fg_fraction, fg_iou_threshold=d.fg_iou_threshold,
        bg_iou_range=d.bg_iou_range, bbox_reg_means=m.bbox_reg_means,
        bbox_reg_stds=m.bbox_reg_stds))(
        batch.proposals * scales[:, None, None], batch.prop_mask,
        batch.gt_boxes * scales[:, None, None], batch.gt_classes,
        batch.gt_mask)
    monkeypatch.setattr(jsampler, "sample_batch", lambda *a, **k: sample)
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **k: x)
    tsample = tsampler.RoiSample(*map(_t, sample))
    monkeypatch.setattr(tsampler, "sample_batch", lambda *a, **k: tsample)

    tx, _ = jschedule.make_optimizer(jcfg.train)
    jstate = jloop.TrainState(jnp.zeros((), jnp.int32), variables,
                              tx.init(variables), jax.random.key(1))
    jstep = jax.jit(jloop.make_train_step(jmodel, jcfg, tx))
    want_m = []
    for _ in range(STEPS):
        jstate, mets = jstep(jstate, jloop.Batch(*batch))
        want_m.append({k: float(v) for k, v in mets.items()})

    trainer = tloop.Trainer(tcfg, device="cpu")
    state = trainer.init_state(0)
    convert.load_flax_params(trainer.model, variables)
    trainer.model.head.dropout_rate = 0.0
    start = {n: p.detach().clone()
             for n, p in trainer.model.named_parameters()}
    buffers = {n: b.clone() for n, b in trainer.model.named_buffers()}
    got_m = []
    for _ in range(STEPS):
        state, mets = trainer.step(state, batch)
        got_m.append({k: float(v) for k, v in mets.items()})

    for got, want in zip(got_m, want_m):
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       atol=1e-6, err_msg=key)
    assert got_m[0]["num_fg"] > 0
    assert got_m[0]["loss"] != got_m[-1]["loss"]

    now = dict(trainer.model.named_parameters())
    change = {n: now[n].detach() - start[n] for n in now}
    got_change = dict(_tree_leaves(convert.flax_from_state_dict(change)))
    first = dict(_tree_leaves({"params": variables["params"]}))
    want_change = {k: v - first[k] for k, v in _tree_leaves(
        {"params": jstate.params["params"]})}
    assert set(got_change) == set(want_change)
    for key, want in want_change.items():
        scale = np.abs(want).max()
        if scale == 0.0:
            assert not np.any(got_change[key]), key
            continue
        err = np.abs(got_change[key] - want).max() / scale
        assert err < 2e-3, (key, err)

    frozen = trainer.frozen
    assert frozen == {n for n in now if n.startswith(
        ("backbone.stem", "backbone.stage2_"))}
    for n in frozen:
        assert torch.equal(now[n], start[n]), n
    for n, b in trainer.model.named_buffers():
        assert torch.equal(b, buffers[n]), n
    for n in ("backbone.stage3_block0.Conv_0.weight",
              "backbone.stage3_block0.BatchNorm_0.weight",
              "backbone.stage4_block22.Conv_2.weight",
              "backbone.stage4_block22.BatchNorm_2.weight"):
        assert not torch.equal(now[n], start[n]), n


# ------------------------------------------------------ backward spans ---

def _small_trainer(freeze=2):
    """A ResNet-50 trunk (the same bottleneck blocks) at `tiny`'s sizes."""
    cfg = preset("tiny")
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, backbone="resnet50"),
        train=dataclasses.replace(cfg.train, freeze_backbone_stages=freeze))
    trainer = tloop.Trainer(cfg, device="cpu")
    return trainer, trainer.init_state(0), _batch(np.random.default_rng(2),
                                                  cfg)


def _stage_grad_times(trainer) -> tuple:
    """Hooks on every training trunk parameter recording when autograd
    computes its gradient -> ({stage: [ns]}, handles)."""
    times, handles = {}, []
    for n, p in trainer.model.backbone.named_parameters():
        if not p.requires_grad:
            continue
        stage = n.split("_block")[0]

        def hook(grad, stage=stage):
            times.setdefault(stage, []).append(time.perf_counter_ns())
        handles.append(p.register_hook(hook))
    return times, handles


@pytest.mark.parametrize("freeze", [2, 0])
def test_backward_spans_hold_their_stages_gradients(freeze):
    """Each training stage's backward span, a child of train.backward,
    holds the moments autograd computes its parameters' gradients; the
    spans follow one another in autograd's order (stage 4 first) without
    overlapping. With conv2_x frozen the lowest span (conv3_x, whose input
    carries no gradient) closes on its parameters' gradients, the last of
    them its first convolution's; with nothing frozen on its input's."""
    trainer, state, batch = _small_trainer(freeze)
    state, _ = trainer.step(state, batch)
    times, handles = _stage_grad_times(trainer)
    profiling.clear_records()
    try:
        with profiling.tracing():
            state, _ = trainer.step(state, batch)
    finally:
        for h in handles:
            h.remove()
    (root,) = profiling.records()
    spans = {r["name"]: r for r in profiling.walk(root)
             if r["name"].startswith("features.")
             and r["name"].endswith(".backward")}
    stages = ["stage4", "stage3"] + (["stage2"] if freeze < 2 else [])
    assert list(spans) == [f"features.{s}.backward" for s in stages]
    for s in stages:
        span = spans[f"features.{s}.backward"]
        assert span["parent"] == "train.backward" and span["end_ns"]
        assert times[s], s
        assert all(span["start_ns"] <= t <= span["end_ns"]
                   for t in times[s]), s
    ordered = [spans[f"features.{s}.backward"] for s in stages]
    assert all(a["end_ns"] <= b["start_ns"]
               for a, b in zip(ordered, ordered[1:]))
    assert trainer.model.backbone._backward_spans.handle is None


def test_backward_spans_cost_nothing_untraced_and_survive_a_lost_backward():
    """Untraced, a step registers no hook; a traced forward whose backward
    never ran leaves its parameter hook behind, and the next traced
    forward removes it, so the next step still holds one span a stage."""
    trainer, state, batch = _small_trainer()
    state, _ = trainer.step(state, batch)
    assert trainer.model.backbone._backward_spans is None
    canvases = torch.zeros((2, 64, 64, 3))
    rois = torch.as_tensor(batch.proposals[:, :4])
    with profiling.tracing():
        trainer.model(canvases, rois, train=True,
                      generator=torch.Generator().manual_seed(0))
    stale = trainer.model.backbone._backward_spans
    assert stale.handle is not None
    profiling.clear_records()
    with profiling.tracing():
        state, _ = trainer.step(state, batch)
    assert stale.handle is None
    (root,) = profiling.records()
    names = [r["name"] for r in profiling.walk(root)]
    assert names.count("features.stage3.backward") == 1
    assert names.count("features.stage4.backward") == 1
    last = trainer.model.backbone._backward_spans
    with torch.inference_mode(), profiling.tracing():
        trainer.model.features(canvases)
    assert trainer.model.backbone._backward_spans is last


# --------------------------------------------------------- stage graphs ---

@pytest.fixture
def stand_in_capture(monkeypatch):
    """torch.cuda.make_graphed_callables replaced by one that records its
    module and sample and returns the module, so that StageGraphs keys,
    bounds and guards its captures on the CPU as on the card."""
    captured = []

    def capture(module, sample):
        captured.append((module, sample[0].shape))
        return module

    monkeypatch.setattr(torch.cuda, "make_graphed_callables", capture)
    return captured


def _trunk_input(size=64):
    return torch.randn((2, size, size, 3),
                       generator=torch.Generator().manual_seed(size))


def test_a_trainer_graphs_only_a_resnet_trunk_on_the_card():
    trainer, _, _ = _small_trainer()
    assert trainer.graphs is None
    assert tloop.stage_graphs(trainer.model) is None
    vgg = tloop.Trainer(preset("tiny"), device="cpu")
    assert vgg.graphs is None


def test_graphed_step_equals_the_eager_step(stand_in_capture):
    """A Trainer's step with its trunk's StageGraphs (here around a
    stand-in capture) gives the eager step's loss and parameters, and
    captures conv3_x and conv4_x once each, the frozen stages never."""
    trainer, state, batch = _small_trainer()
    trunk = trainer.model.backbone
    saved = tloop.snapshot_train_state(trainer, state)
    _, want = trainer.step(state, batch)
    want_p = {n: p.detach().clone()
              for n, p in trainer.model.named_parameters()}
    graphs = tloop.StageGraphs(trunk)
    trainer._step = tloop.make_train_step(trainer.model, trainer.cfg,
                                          graphs=graphs)
    for _ in range(2):
        st = tloop.restore_train_state(trainer, saved)
        _, got = trainer.step(st, batch)
        assert torch.equal(got["loss"], want["loss"])
        for n, p in trainer.model.named_parameters():
            assert torch.equal(p, want_p[n]), n
    assert sorted(graphs.captures) == [1, 2]
    assert [len(k) for k in graphs.captures.values()] == [1, 1]
    assert len(stand_in_capture) == 2
    assert trunk._graphs is None and graphs.ran is None


def test_stage_graphs_refuse_a_second_forward_in_a_step(stand_in_capture):
    trainer, _, _ = _small_trainer()
    trunk = trainer.model.backbone
    graphs = tloop.StageGraphs(trunk)
    x = _trunk_input()
    with graphs.step():
        trunk(x)
        with pytest.raises(RuntimeError, match="ran twice in one step"):
            trunk(x)
    with graphs.step():   # a step that raised leaves the next one free
        trunk(x)
    trunk(x)              # outside a step: eager, nothing captured
    with torch.no_grad(), graphs.step():
        trunk(x)          # no gradient recorded: eager
    assert len(stand_in_capture) == 2


def test_stage_graphs_capture_anew_for_cudnn_settings_and_storage(
        stand_in_capture):
    """A change of cudnn.deterministic between steps captures each
    training stage anew (the earlier captures stay for the earlier
    setting); a stage whose parameters moved to other storage drops its
    captures, the other stage keeps its own."""
    trainer, _, _ = _small_trainer()
    trunk = trainer.model.backbone
    graphs = tloop.StageGraphs(trunk)
    x = _trunk_input()
    with graphs.step():
        trunk(x)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = not deterministic
    try:
        with graphs.step():
            trunk(x)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    with graphs.step():
        trunk(x)
    assert [len(k) for k in graphs.captures.values()] == [2, 2]
    assert len(stand_in_capture) == 4
    w = trunk.stage4_block0.Conv_0.weight
    w.data = w.data.clone()
    with graphs.step():
        trunk(x)
    assert {si: len(k) for si, k in graphs.captures.items()} == {1: 2, 2: 1}
    assert len(stand_in_capture) == 5


def test_stage_graphs_hold_at_most_their_limit(stand_in_capture):
    """Each new input shape captures until a stage holds LIMIT captures;
    a further shape runs eagerly, to the eager output."""
    trainer, _, _ = _small_trainer()
    trunk = trainer.model.backbone
    graphs = tloop.StageGraphs(trunk)
    sizes = [32 + 8 * i for i in range(graphs.LIMIT + 1)]
    for size in sizes:
        with graphs.step():
            got = trunk(_trunk_input(size))
    assert [len(k) for k in graphs.captures.values()] == [graphs.LIMIT] * 2
    assert len(stand_in_capture) == 2 * graphs.LIMIT
    want = trunk(_trunk_input(sizes[-1]))
    for lv in want:
        assert torch.equal(got[lv], want[lv]), lv
