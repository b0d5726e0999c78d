"""The SharpMask proposal network on the card against the CPU, at `tiny`
in float32: generate_proposals, one ProposalTrainer step, and two steps
from one snapshot repeated bit for bit on the card (the roi_align
gradient's fixed-order scatter, under cudnn.deterministic).

Marked `cuda`: each test skips where torch.cuda.is_available() is false
(decided inside the fixture, never at import). Run on a GPU machine with
    python -m pytest tests/test_torch_sharpmask_cuda.py --noconftest -m cuda -q
(tests/conftest.py imports jax, which a GPU machine need not have).
"""

import dataclasses

import numpy as np
import pytest
import torch

from multipathnet_tpu_torch.core.config import preset
from multipathnet_tpu_torch.models import sharpmask as tsm
from multipathnet_tpu_torch.ops import roi as roi_ops
from multipathnet_tpu_torch.train import loop as tloop
from multipathnet_tpu_torch.train import proposal as tprop
from multipathnet_tpu_torch.train.proposal import ProposalTrainer

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _cfg(dtype="float32"):
    cfg = preset("tiny")
    return cfg.replace(model=dataclasses.replace(cfg.model, dtype=dtype),
                       train=dataclasses.replace(cfg.train, lr=5e-3))


def _batch(seed=0, n_valid=(5, 3)):
    rng = np.random.default_rng(seed)
    cfg = _cfg()
    b, g, m = 2, cfg.data.max_gt_per_image, 28
    xy = rng.uniform(0, 30, (b, g, 2))
    gt = np.concatenate([xy, xy + rng.uniform(8, 30, (b, g, 2))],
                        -1).astype(np.float32)
    return tloop.Batch(
        rng.integers(0, 255, (b, 64, 64, 3), dtype=np.uint8),
        np.asarray([[64, 64], [60, 52]], np.float32),
        np.zeros((b, 4, 4), np.float32), np.ones((b, 4), bool), gt,
        np.ones((b, g), np.int32),
        np.arange(g)[None] < np.asarray(n_valid)[:, None],
        (rng.uniform(size=(b, g, m, m)) > 0.5).astype(np.float32))


def _pair(cuda):
    """(CPU trainer, card trainer) with the same initial weights."""
    cpu = ProposalTrainer(_cfg(), device="cpu")
    gpu = ProposalTrainer(_cfg(), device=cuda)
    cpu_state, gpu_state = cpu.init_state(0), gpu.init_state(0)
    gpu.model.load_state_dict(cpu.model.state_dict())
    return (cpu, cpu_state), (gpu, gpu_state)


def _close(got, want, rel, what):
    got, want = got.detach().cpu().float(), want.detach().float()
    scale = max(float(want.abs().max()), 1e-30)
    assert float((got - want).abs().max()) <= rel * scale, what


def test_generate_proposals_gpu_matches_cpu(cuda):
    """Boxes within 1e-4 x max, scores and masks within 1e-5 (the card's
    convolutions and contractions sum in another order)."""
    (cpu, _), (gpu, _) = _pair(cuda)
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    want = tsm.generate_proposals(cpu.model, x, top_k=16)
    got = tsm.generate_proposals(gpu.model, x.to(cuda), top_k=16)
    assert all(v.device.type == "cuda" for v in got.values())
    _close(got["boxes"], want["boxes"], 1e-4, "boxes")
    _close(got["scores"], want["scores"], 1e-5, "scores")
    _close(got["masks"], want["masks"], 1e-5, "masks")


def test_one_proposal_step_gpu_matches_cpu(cuda):
    """One step, the same jitter draws on both devices: every metric
    within rtol 1e-4, every parameter after it within 1e-5."""
    (cpu, cs), (gpu, gs) = _pair(cuda)
    batch = _batch()
    draws = [torch.randn(2, 8, 2, generator=torch.Generator().manual_seed(k))
             for k in (2, 3)]
    orig = tprop.jitter_draws
    try:
        tprop.jitter_draws = lambda gen, shape, dev: tuple(
            d.to(dev) for d in draws)
        _, want = cpu.step(cs, batch)
        _, got = gpu.step(gs, batch)
    finally:
        tprop.jitter_draws = orig
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    pc = dict(cpu.model.named_parameters())
    for n, p in gpu.model.named_parameters():
        torch.testing.assert_close(p.detach().cpu(), pc[n].detach(),
                                   atol=1e-5, rtol=0, msg=n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_proposal_steps_repeat_on_the_card(cuda, dtype):
    """Two steps from one snapshot on the card under cudnn.deterministic:
    loss, gradients and parameters equal bit for bit."""
    trainer = ProposalTrainer(_cfg(dtype), device=cuda)
    batch = _batch(4)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        state, _ = trainer.step(trainer.init_state(0), batch)
        saved = tloop.snapshot_train_state(trainer, state)
        runs = []
        for _ in range(2):
            state, m = trainer.step(
                tloop.restore_train_state(trainer, saved), batch)
            runs.append((float(m["loss"]), {
                n: (p.detach().clone(), p.grad.clone())
                for n, p in trainer.model.named_parameters()}))
    finally:
        torch.backends.cudnn.deterministic = det
    (la, a), (lb, b) = runs
    assert np.isfinite(la) and la == lb
    for n in a:
        assert torch.equal(a[n][0], b[n][0]) and torch.equal(
            a[n][1], b[n][1]), n


def test_roi_align_gradient_repeats_on_the_card(cuda):
    """The gather's fixed-order backward on the card: 2000 ROIs crowded
    on a 16 x 16 map give the same gradient on every call, within 1e-5 x
    max of the CPU's."""
    gen = torch.Generator().manual_seed(5)
    feat = torch.randn(1, 16, 16, 32, generator=gen)
    xy = torch.rand(1, 2000, 2, generator=gen) * 40
    rois = torch.cat([xy, xy + 8 + torch.rand(1, 2000, 2, generator=gen)
                      * 30], -1)
    ct = torch.randn(1, 2000, 7, 7, 32, generator=gen)

    def grad(dev):
        f = feat.to(dev).requires_grad_(True)
        (roi_ops.batched_roi_align(f, rois.to(dev), output_size=7,
                                   spatial_scale=0.25, samples_per_bin=2)
         * ct.to(dev)).sum().backward()
        return f.grad

    runs = [grad(cuda) for _ in range(3)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    _close(runs[0], grad("cpu"), 1e-5, "gradient")
