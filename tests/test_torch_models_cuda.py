"""The reference's own models on the card: a ResNet-18 model at `tiny`
widths against the CPU, the reference-exact max route on the card bit for
bit against the CPU, and a ResNet serving bundle and train checkpoint
restoring exactly on the card.

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
    windowed = roi_pyramid.pyramid_roi_align(gpyr, rois.to(cuda)).cpu()
    assert torch.equal(windowed, roi_pyramid.pyramid_roi_align(pyr, rois))
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
