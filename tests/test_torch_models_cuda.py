"""The reference's own models on the card: a ResNet-18 model at `tiny`
widths against the CPU, the reference-exact max route on the card bit for
bit against the CPU, a ResNet serving bundle and train checkpoint
restoring exactly on the card, and the plain align routes (roi_impl
"direct" and "pyramid") against the CPU, their train step repeating.

Marked `cuda`: each test skips where torch.cuda.is_available() is false
(decided inside the fixture, never at import). Run on a GPU machine with
    python -m pytest tests/test_torch_models_cuda.py --noconftest -m cuda -q
(tests/conftest.py imports jax, which a GPU machine need not have).
"""

import dataclasses

import numpy as np
import pytest
import torch

from multipathnet_tpu_torch.core.config import preset
from multipathnet_tpu_torch.eval.detect import Detector, score_batch
from multipathnet_tpu_torch.eval.serving import load_detector, save_bundle
from multipathnet_tpu_torch.models import convert, layers
from multipathnet_tpu_torch.models.multipath import build_model, init_params_
from multipathnet_tpu_torch.ops import roi as roi_ops
from multipathnet_tpu_torch.ops import roi_pyramid
from multipathnet_tpu_torch.train.checkpoint import Checkpointer
from multipathnet_tpu_torch.train.loop import Batch, Trainer
from multipathnet_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _resnet_cfg(dtype="float32"):
    cfg = preset("tiny")
    return cfg.replace(model=dataclasses.replace(
        cfg.model, backbone="resnet18", dtype=dtype))


@torch.no_grad()
def _random_bn_(model, seed):
    """Non-trivial frozen BN: statistics and affine drawn from a seed."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, layers.FrozenBatchNorm):
            n = mod.weight.shape[0]
            mod.running_mean.copy_(torch.randn(n, generator=gen) * 0.5)
            mod.running_var.copy_(torch.rand(n, generator=gen) * 1.5 + 0.5)
            mod.weight.copy_(torch.rand(n, generator=gen) + 0.5)
            mod.bias.copy_(torch.randn(n, generator=gen) * 0.1)


def _inputs(b=2, p=24, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (b, 60, 64, 3), dtype=np.uint8)
    hws = np.asarray([[60, 64], [50, 41]], np.float32)[:b]
    xy = rng.uniform(0, 40, (b, p, 2))
    wh = rng.uniform(6, 24, (b, p, 2))
    props = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    return images, hws, props


def _train_batch(seed, b=2, p=32, g=8):
    """A `tiny` train batch: images of 60 x 64, GT boxes and proposals
    jittered around them so foreground exists."""
    rng = np.random.default_rng(seed)
    images, hws, far = _inputs(b, p // 2, seed)
    xy = rng.uniform(0, 36, (b, g, 2))
    gt = np.concatenate([xy, xy + rng.uniform(10, 24, (b, g, 2))], -1)
    near = gt[:, rng.integers(0, g, p // 2)]
    near = near + rng.normal(0, 2, near.shape)
    props = np.concatenate([near, far], 1).astype(np.float32)
    return Batch(images, hws, props, np.ones((b, p), bool),
                 gt.astype(np.float32),
                 rng.integers(1, 5, (b, g)).astype(np.int32),
                 np.arange(g)[None, :] < np.asarray([5, 3])[:, None])


def _cpu_model(cfg, seed=0):
    model = build_model(cfg.model, device="cpu", param_dtype=torch.float32)
    init_params_(model, torch.Generator().manual_seed(seed))
    _random_bn_(model, seed)
    return model.eval()


def test_resnet18_tiny_on_gpu_matches_cpu(cuda):
    """ResNet-18 with frozen BN at `tiny` widths, float32: GPU (cuDNN,
    cuBLAS, the pool kernels) against CPU (plain versions) on the same
    weights; probabilities atol 1e-4, boxes atol 1e-2, as the tiny slice's
    GPU test (tests/test_torch_kernels_cuda.py)."""
    cfg = _resnet_cfg()
    cpu_model = _cpu_model(cfg)
    gpu_model = build_model(cfg.model, device=cuda,
                            param_dtype=torch.float32).eval()
    gpu_model.load_state_dict(cpu_model.state_dict())
    inputs = _inputs()
    want = score_batch(cpu_model, cfg, *map(torch.from_numpy, inputs))
    got = score_batch(gpu_model, cfg, *(torch.from_numpy(x).to(cuda)
                                        for x in inputs))
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=0, atol=1e-4)
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=1e-2)


def test_resnet18_bf16_features_on_gpu_match_cpu(cuda):
    """bf16 ResNet-18 trunk taps on the card (each convolution's float32
    sum through TF32, exact for bf16 operands, into the BN) against the
    CPU: within two bf16 steps at each level's largest magnitude (two
    float32 summation orders move some roundings, and depth compounds
    them)."""
    cfg = _resnet_cfg("bfloat16")
    cpu_model = _cpu_model(cfg)
    gpu_model = build_model(cfg.model, device=cuda,
                            param_dtype=torch.float32).eval()
    gpu_model.load_state_dict(cpu_model.state_dict())
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = cpu_model.backbone(x)
        got = gpu_model.backbone(x.to(cuda))
    for lv in want:
        w, g = want[lv].float(), got[lv].float().cpu()
        step = 2.0 ** (torch.floor(torch.log2(w.abs().max())) - 7)
        assert (g - w).abs().max() <= 2 * step, lv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_exact_max_route_on_gpu_equals_cpu(cuda, dtype):
    """roi_pool_max (the exact route) and the windowed route on the card
    against the CPU, bit for bit: max and the float32 bin arithmetic are
    exact on both. The exact route's gradient within 1e-6 x max(1, max
    |gradient|): each cell sums its bins' shares (index_put_ accumulate)
    in another order on each device, and a flat region's ties give many
    terms of both signs (two CPU runs differ by 1.1e-6)."""
    gen = torch.Generator().manual_seed(2)
    feat = torch.randn(40, 48, 32, generator=gen).to(dtype)
    feat[10:, 20:] = 0.5  # a flat region: ties in the gradient
    xy = torch.rand(300, 2, generator=gen) * 180 - 10
    wh = torch.rand(300, 2, generator=gen) * 90
    rois = torch.cat([xy, xy + wh], -1)
    want = roi_ops.roi_pool_max(feat, rois, spatial_scale=0.25)
    got = roi_ops.roi_pool_max(feat.to(cuda), rois.to(cuda),
                               spatial_scale=0.25)
    assert torch.equal(got.cpu(), want)
    pyr = roi_pyramid.build_pyramid(feat, 0.25, mode="max")
    gpyr = roi_pyramid.build_pyramid(feat.to(cuda), 0.25, mode="max")
    assert torch.equal(gpyr.flat.cpu(), pyr.flat)
    windowed = roi_pyramid.pyramid_roi_align(gpyr, rois.to(cuda),
                                             mode="exact_max").cpu()
    assert torch.equal(windowed, roi_pyramid.pyramid_roi_align(
        pyr, rois, mode="exact_max"))
    cot = torch.randn(want.shape, generator=gen)
    grads = []
    for dev in ("cpu", cuda):
        x = feat.detach().float().to(dev).clone().requires_grad_(True)
        (roi_ops.roi_pool_max(x, rois.to(dev), spatial_scale=0.25)
         * cot.to(dev)).sum().backward()
        grads.append(x.grad.cpu())
    scale = max(1.0, float(grads[0].abs().max()))
    torch.testing.assert_close(grads[1], grads[0], rtol=0, atol=1e-6 * scale)


def test_resnet_bundle_round_trip_on_gpu(cuda, tmp_path):
    """A ResNet-18 serving bundle (params and batch_stats) loads on the card
    into a model whose state equals the exported one, BN statistics
    included, and detects what the exporting model detects."""
    cfg = _resnet_cfg()
    model = _cpu_model(cfg).to(cuda)
    tree = convert.flax_from_state_dict(model.state_dict())
    assert "batch_stats" in tree
    save_bundle(str(tmp_path / "bundle"), cfg, tree)
    det = load_detector(str(tmp_path / "bundle"), device=cuda)
    got_sd, want_sd = det.model.state_dict(), model.state_dict()
    assert set(got_sd) == set(want_sd)
    for k in want_sd:
        assert torch.equal(got_sd[k], want_sd[k].to(got_sd[k].dtype)), k
    inputs = _inputs() + (np.ones((2, 24), bool),)
    want = Detector(model, cfg, cuda)(*inputs)
    got = det(*inputs)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_resnet_checkpoint_resume_on_gpu(cuda, tmp_path):
    """Two steps of a ResNet-18 `tiny` Trainer on the card (bf16 compute,
    no stage frozen, BN statistics drawn), a checkpoint, a fresh Trainer
    restored from it: parameters and BN buffers equal bit for bit, and one
    more step from each, under cudnn.deterministic, gives equal loss and
    parameters."""
    cfg = _resnet_cfg("bfloat16")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                freeze_backbone_stages=0))
    batch = _train_batch(4)
    torch.backends.cudnn.deterministic = True
    try:
        straight = Trainer(cfg, device=cuda)
        state = straight.init_state(0)
        _random_bn_(straight.model, 3)
        for _ in range(2):
            state, _ = straight.step(state, batch)
        ckpt = Checkpointer(str(tmp_path / "ck"))
        ckpt.save(straight, state)
        resumed = Trainer(cfg, device=cuda)
        restored = ckpt.restore_latest(resumed, resumed.init_state(1))
        for (n, a), (_, b) in zip(straight.model.state_dict().items(),
                                  resumed.model.state_dict().items()):
            assert torch.equal(a, b), n
        state, want = straight.step(state, batch)
        restored, got = resumed.step(restored, batch)
    finally:
        torch.backends.cudnn.deterministic = False
    assert torch.equal(got["loss"], want["loss"])
    for (n, a), (_, b) in zip(straight.model.state_dict().items(),
                              resumed.model.state_dict().items()):
        assert torch.equal(a, b), n


def _align_cfg(impl, dtype="float32", **model):
    cfg = preset("tiny")
    return cfg.replace(model=dataclasses.replace(
        cfg.model, dtype=dtype, roi_impl=impl, train_roi_impl=impl, **model))


POOL_KERNELS = ("window_pool_multi", "window_pool_multi_quant",
                "resident_pool", "resident_pool_quant")


def _launched(before, names=POOL_KERNELS) -> dict:
    """The launches of the kernels `names` since the snapshot `before`."""
    launched = profiling.kernel_launches(before)
    return {k: launched[k] for k in names}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["direct", "pyramid"])
def test_plain_align_routes_on_gpu_match_cpu(cuda, impl, dtype):
    """roi_impl "direct" and "pyramid" at `tiny` on the card against the
    CPU on the same weights: pool_rois on one set of reduced maps within
    1e-5 x max (float32 out; the bin means and the pyramid's window
    contractions sum in other orders), then score_batch with ROIs in
    chunks of roi_chunk = 10 (probabilities atol 1e-4, boxes 1e-2, as
    test_resnet18_tiny_on_gpu_matches_cpu). No pool kernel launches."""
    cfg = _align_cfg(impl, dtype)
    cfg = cfg.replace(eval=dataclasses.replace(cfg.eval, roi_chunk=10))
    cpu_model = build_model(cfg.model, device="cpu")
    init_params_(cpu_model, torch.Generator().manual_seed(0))
    cpu_model.eval()
    gpu_model = build_model(cfg.model, device=cuda).eval()
    gpu_model.load_state_dict(cpu_model.state_dict())
    gen = torch.Generator().manual_seed(1)
    feats = {lv: torch.randn(2, 64 // s, 64 // s, 32, generator=gen).to(
        cpu_model.dtype) for lv, s in (("c3", 4), ("c4", 8), ("c5", 16))}
    rois = torch.from_numpy(_inputs()[2]) * 1.2
    before = profiling.counters()
    with torch.no_grad():
        want = cpu_model.pool_rois(feats, rois, (64, 64))
        got = gpu_model.pool_rois({k: v.to(cuda) for k, v in feats.items()},
                                  rois.to(cuda), (64, 64)).cpu()
    assert got.dtype == want.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    inputs = _inputs()
    want = score_batch(cpu_model, cfg, *map(torch.from_numpy, inputs))
    got = score_batch(gpu_model, cfg, *(torch.from_numpy(x).to(cuda)
                                        for x in inputs))
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=0, atol=1e-4)
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=1e-2)
    assert not any(_launched(before).values())


@pytest.mark.parametrize("impl", ["direct", "pyramid"])
def test_direct_train_step_repeats_on_gpu(cuda, impl):
    """A bf16 `tiny` train step through the direct roi_align (what
    train_roi_impl "pyramid" trains as too) on the card: two steps from
    one snapshot equal bit for bit under cudnn.deterministic (the
    gather's backward sums in a fixed order), the loss finite, no pool
    or gradient kernel launched."""
    from multipathnet_tpu_torch.train.loop import (restore_train_state,
                                                   snapshot_train_state)

    cfg = _align_cfg(impl, "bfloat16")
    batch = _train_batch(5)
    before = profiling.counters()
    torch.backends.cudnn.deterministic = True
    try:
        trainer = Trainer(cfg, device=cuda)
        state, _ = trainer.step(trainer.init_state(0), batch)
        saved = snapshot_train_state(trainer, state)
        runs = []
        for _ in range(2):
            _, metrics = trainer.step(restore_train_state(trainer, saved),
                                      batch)
            runs.append((metrics["loss"], {
                n: p.detach().clone()
                for n, p in trainer.model.named_parameters()}))
    finally:
        torch.backends.cudnn.deterministic = False
    (loss_a, a), (loss_b, b) = runs
    assert torch.isfinite(loss_a) and torch.equal(loss_a, loss_b)
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not any(_launched(before, POOL_KERNELS + (
        "window_grad", "window_rmw_grad")).values())


def _bottleneck_train_cfg():
    """ResNet-50 at `tiny` widths, bf16 compute, the stem and conv2_x
    frozen."""
    cfg = preset("tiny")
    return cfg.replace(
        model=dataclasses.replace(cfg.model, backbone="resnet50",
                                  dtype="bfloat16"),
        train=dataclasses.replace(cfg.train, freeze_backbone_stages=2))


def test_training_stages_run_as_graphs_with_the_eager_bits(cuda, monkeypatch):
    """A bottleneck trunk trains on the card with conv3_x and conv4_x
    each captured as a CUDA graph of its forward and backward
    (Trainer.graphs, resnet.StageGraphs): three steps give the losses and
    parameters of the eager stages bit for bit, from the same weights and
    batches; a traced step still holds each training stage's backward
    span with its device interval."""
    from multipathnet_tpu_torch.train import loop

    cfg = _bottleneck_train_cfg()
    graphed = loop.stage_graphs
    runs = {}
    torch.backends.cudnn.deterministic = True
    try:
        for name, fn in (("eager", lambda model, mesh=None: None),
                         ("graphed", graphed)):
            monkeypatch.setattr(loop, "stage_graphs", fn)
            trainer = Trainer(cfg, device=cuda)
            state = trainer.init_state(0)
            _random_bn_(trainer.model, 3)
            losses = []
            for seed in range(3):
                state, m = trainer.step(state, _train_batch(seed))
                losses.append(m["loss"])
            runs[name] = (trainer, state, losses)
    finally:
        torch.backends.cudnn.deterministic = False
    (eager_t, _, want), (trainer, state, got) = runs["eager"], runs["graphed"]
    assert eager_t.graphs is None
    assert {si: len(keys) for si, keys in trainer.graphs.captures.items()} \
        == {1: 1, 2: 1}
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for (n, a), (_, b) in zip(trainer.model.state_dict().items(),
                              eager_t.model.state_dict().items()):
        assert torch.equal(a, b), n
    profiling.clear_records()
    with profiling.tracing():
        trainer.step(state, _train_batch(3))
    (root,) = profiling.records()
    spans = {r["name"]: r for r in profiling.walk(root)}
    for stage in ("stage3", "stage4"):
        span = spans[f"features.{stage}.backward"]
        assert span["parent"] == "train.backward"
        assert span["device_ms"] is not None and span["device_ms"] > 0


def test_graphed_steps_repeat_once_deterministic_is_set(cuda):
    """The order of a run that steps under cuDNN's default settings and
    then asks for cudnn.deterministic: the graphs captured at the first
    step are left alone, each stage captures anew under the new setting,
    and two steps from one state repeat bit for bit."""
    from multipathnet_tpu_torch.train.loop import (restore_train_state,
                                                   snapshot_train_state)

    trainer = Trainer(_bottleneck_train_cfg(), device=cuda)
    state = trainer.init_state(0)
    _random_bn_(trainer.model, 3)
    state, _ = trainer.step(state, _train_batch(0))
    saved = snapshot_train_state(trainer, state)
    params = dict(trainer.model.named_parameters())
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for _ in range(2):
            st = restore_train_state(trainer, saved)
            _, m = trainer.step(st, _train_batch(1))
            runs.append((m["loss"].clone(), {n: p.detach().clone()
                                             for n, p in params.items()}))
    finally:
        torch.backends.cudnn.deterministic = False
    assert {si: sorted(k[3] for k in keys)
            for si, keys in trainer.graphs.captures.items()} \
        == {1: [False, True], 2: [False, True]}
    assert torch.equal(runs[0][0], runs[1][0])
    for n in params:
        assert torch.equal(runs[0][1][n], runs[1][1][n]), n
