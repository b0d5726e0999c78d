"""The CUDA pool kernels against their plain PyTorch versions, on the card.

Marked `cuda`: each test skips where torch.cuda.is_available() is false
(decided inside the fixture, never at import). Run on a GPU machine with
    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -m cuda -q
(tests/conftest.py imports jax, which a GPU machine need not have).
Tolerances: float32 atol 1e-4 (the kernel sums in another order than the
einsums); bfloat16 rtol 1e-2, atol 1e-2 (one bf16 rounding of a float32
sum, 2^-8 relative).
"""

import dataclasses

import numpy as np
import pytest
import torch

from multipathnet_tpu_torch.core.config import preset
from multipathnet_tpu_torch.eval.detect import score_batch
from multipathnet_tpu_torch.models.multipath import build_model
from multipathnet_tpu_torch.ops import roi_pool, roi_pyramid

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rois(rng, n, canvas):
    wh = np.exp(rng.uniform(np.log(4.0), np.log(canvas), (n, 2)))
    xy = rng.uniform(-0.3, 1.0, (n, 2)) * canvas - 0.5 * wh
    return np.clip(np.concatenate([xy, xy + wh], -1), 0, canvas).astype(
        np.float32)


def _levels(dev, dtype, b, canvas, c, n_levels, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for s in (4, 8, 16)[3 - n_levels:]:
        f = torch.randn((b, canvas // s, canvas // s, c), generator=gen,
                        device=dev).to(dtype)
        out.append(roi_pyramid.build_pyramid_batch(f, 1.0 / s))
    return out


def _tol(dtype):
    return (dict(rtol=0, atol=1e-4) if dtype == torch.float32
            else dict(rtol=1e-2, atol=1e-2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n_levels,c", [(3, 512), (2, 200), (1, 32)])
def test_window_pool_multi_kernel_matches_plain(cuda, dtype, n_levels, c):
    b, canvas, n = 2, 320, 600
    pyrs = _levels(cuda, dtype, b, canvas, c, n_levels, seed=n_levels)
    rois = torch.from_numpy(_rois(np.random.default_rng(0), n, canvas)).to(
        cuda)
    img_idx = torch.arange(b, dtype=torch.int32,
                           device=cuda).repeat_interleave(n // b)
    args = [[], [], [], [], []]
    for flat, meta in pyrs:
        row0, x0, wy, wx = roi_pool.view_geometry(meta, rois)
        row0 = (row0 + img_idx * meta.flat.shape[0]).contiguous()
        for dst, v in zip(args, (flat, row0, x0, wy, wx)):
            dst.append(v)
    got = roi_pool.window_pool_multi(*args)
    torch.cuda.synchronize()
    want = roi_pool.window_pool_multi_ref(*args)
    assert got.dtype == want.dtype == dtype and got.shape == (n, 7, 7, c)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_resident_pool_kernel_matches_plain(cuda, dtype):
    b, canvas, v, c = 3, 640, 500, 512
    (flat, meta), = _levels(cuda, dtype, b, canvas, c, 1, seed=7)
    rois = torch.from_numpy(_rois(np.random.default_rng(1), b * v,
                                  canvas)).to(cuda)
    row0, x0, wy, wx = roi_pool.view_geometry(meta, rois)
    rows, wmax = meta.flat.shape[:2]
    args = (flat.reshape(b, rows, wmax, c), row0.reshape(b, v),
            x0.reshape(b, v), wy.reshape(b, v, 7, 10),
            wx.reshape(b, v, 7, 16))
    got = roi_pool.resident_pool(*args)
    torch.cuda.synchronize()
    want = roi_pool.resident_pool_ref(*args)
    assert got.shape == (b, v, 7, 7, c)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


def test_out_of_range_window_is_nan_not_read(cuda):
    (flat, meta), = _levels(cuda, torch.float32, 1, 160, 64, 1, seed=3)
    rois = torch.tensor([[10.0, 10.0, 60.0, 70.0]] * 2, device=cuda)
    row0, x0, wy, wx = roi_pool.view_geometry(meta, rois)
    row0[1] = flat.shape[0] - 5          # window hangs past the last row
    out = roi_pool.window_pool_multi([flat], [row0], [x0], [wy], [wx])
    torch.cuda.synchronize()
    assert torch.isfinite(out[0]).all() and torch.isnan(out[1]).all()


def test_wrappers_check_their_inputs(cuda):
    (flat, meta), = _levels(cuda, torch.float32, 1, 160, 64, 1, seed=4)
    rois = torch.tensor([[10.0, 10.0, 60.0, 70.0]], device=cuda)
    row0, x0, wy, wx = roi_pool.view_geometry(meta, rois)
    with pytest.raises(TypeError):
        roi_pool.window_pool_multi([flat], [row0.long()], [x0], [wy], [wx])
    with pytest.raises(TypeError):
        roi_pool.window_pool_multi([flat.half()], [row0], [x0], [wy], [wx])
    with pytest.raises(ValueError):
        roi_pool.window_pool_multi([flat], [row0.cpu()], [x0], [wy], [wx])
    with pytest.raises(ValueError):
        roi_pool.window_pool_multi([flat[..., :63]], [row0], [x0], [wy],
                                   [wx])
    with pytest.raises(ValueError):
        roi_pool.window_pool_multi([flat[None]], [row0], [x0], [wy], [wx])
    with pytest.raises(ValueError):
        roi_pool.resident_pool(flat[None], row0[None], x0[None],
                               wy[None].transpose(2, 3).contiguous(),
                               wx[None])


def test_launch_counters_count_kernel_launches(cuda):
    (flat, meta), = _levels(cuda, torch.bfloat16, 2, 160, 64, 1, seed=5)
    rois = torch.tensor([[10.0, 10.0, 60.0, 70.0]] * 4, device=cuda)
    k1, k2 = (roi_pool.window_pool_multi.launches,
              roi_pool.resident_pool.launches)
    roi_pool.batched_pyramid_pool_resident(flat, meta, rois, 2)
    roi_pool.batched_pyramid_pool_multi(
        [flat], [meta], rois, torch.zeros(4, dtype=torch.int32, device=cuda))
    assert roi_pool.window_pool_multi.launches == k1 + 1
    assert roi_pool.resident_pool.launches == k2 + 1


def test_tiny_slice_on_gpu_matches_cpu(cuda):
    """The whole slice at the tiny preset: GPU (kernels, cuDNN, cuBLAS)
    against CPU (plain versions) on the same weights."""
    cfg = preset("tiny")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dtype="float32"))
    torch.manual_seed(0)
    cpu_model = build_model(cfg.model).eval()
    gpu_model = build_model(cfg.model, device=cuda).eval()
    gpu_model.load_state_dict(cpu_model.state_dict())
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (2, 60, 64, 3), dtype=np.uint8)
    hws = np.asarray([[60, 64], [50, 41]], np.float32)
    xy = rng.uniform(0, 40, (2, 24, 2))
    wh = rng.uniform(6, 24, (2, 24, 2))
    props = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    want = score_batch(cpu_model, cfg, *(torch.from_numpy(x) for x in
                                         (images, hws, props)))
    got = score_batch(gpu_model, cfg, *(torch.from_numpy(x).to(cuda)
                                        for x in (images, hws, props)))
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=0, atol=1e-4)
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=1e-2)
