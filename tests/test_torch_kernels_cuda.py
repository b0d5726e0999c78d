"""The CUDA pool kernels (forward K1/K2 with and without their int8
epilogue, K5, backward K3/K4 and the single-level backward through K4) and
the window-read probe P against their plain PyTorch versions, on the card;
K3, K4 and a whole bf16 train step repeated bit for bit; the pipeline's
prefetching copies against synchronous ones, and Detector on a batch
already on the card.

Marked `cuda`: each test skips where torch.cuda.is_available() is false
(decided inside the fixture, never at import). Run on a GPU machine with
    python -m pytest tests/test_torch_kernels_cuda.py --noconftest -m cuda -q
(tests/conftest.py imports jax, which a GPU machine need not have).
Every bf16 pool launch runs the tensor-core body (wgmma on TMA-staged
windows), every float32 one the CUDA-core body. Tolerances: float32 atol
1e-4 (the kernel sums in another order than the plain version); bfloat16
rtol 1e-2, atol 1e-2 (one bf16 rounding of a float32 sum, 2^-8 relative;
both sides round W2 = wy (x) wx to bf16 first, so they differ only where
the float32 sums, taken in other orders, round to neighbouring bf16
values). The int8 epilogue is held bit for bit against its
plain version (quant_view_ref) on the same kernel's own pooled output; against
the fully plain version, whose pooled sums differ in their last bits, codes
within 1 and scales to the pooled tolerance. The backward kernels K3/K4:
float32 atol 1e-4 x max(1, max |gradient|) (float32 sums of many
overlapping windows in another order), bf16 within one bf16 step of the
plain version's float32 sum rounded (_assert_one_bf16_step).
"""

import dataclasses

import numpy as np
import pytest
import torch

from multipathnet_tpu_torch.core.config import preset
from multipathnet_tpu_torch.data import sampler
from multipathnet_tpu_torch.eval.detect import score_batch
from multipathnet_tpu_torch.models.multipath import build_model
from multipathnet_tpu_torch.ops import roi_pool, roi_pyramid
from multipathnet_tpu_torch.train.loop import (Batch, Trainer,
                                               restore_train_state,
                                               snapshot_train_state)
from multipathnet_tpu_torch.utils import profiling

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


def _assert_grad_close(got, want32):
    """A backward kernel's output against its plain version's float32 sum:
    float32 to atol 1e-4 x max(1, max |want|); bf16 within one bf16 step
    (the spacing of bf16 values at the larger magnitude) of the float32
    sum rounded, since each side rounds its own float32 sum once."""
    if got.dtype == torch.float32:
        scale = max(1.0, want32.abs().max().item())
        torch.testing.assert_close(got, want32, rtol=0, atol=1e-4 * scale)
        return
    assert got.dtype == torch.bfloat16
    want = want32.to(torch.bfloat16).float()
    got = got.float()
    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
    step = torch.ldexp(torch.ones_like(got), e - 8)
    bad = (got - want).abs() > step
    assert not bad.any(), (int(bad.sum()), (got - want).abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n_levels,c", [(3, 512), (2, 200), (1, 32),
                                         (2, 72)])
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


def _one_level_views(dev, dtype, c, seed, n=6):
    """K1 and K2 arguments for n views over one 2-image level, the window
    of view 1 moved past the last row of its buffer."""
    (flat, meta), = _levels(dev, dtype, 2, 160, c, 1, seed=seed)
    rois = torch.tensor([[10.0, 10.0, 60.0, 70.0]] * n, device=dev)
    row0, x0, wy, wx = roi_pool.view_geometry(meta, rois)
    rows, wmax = meta.flat.shape[:2]
    bad = row0.clone()
    bad[1] = 2 * rows - 5                # K1: absolute rows
    k1 = ([flat], [bad], [x0], [wy], [wx])
    rel = row0.clone()
    rel[1] = rows - 5                    # K2: image-relative rows
    v = n // 2
    k2 = (flat.reshape(2, rows, wmax, c), rel.reshape(2, v),
          x0.reshape(2, v), wy.reshape(2, v, 7, 10), wx.reshape(2, v, 7, 16))
    return k1, k2


def test_bf16_out_of_range_window_is_not_read(cuda):
    """The tensor-core body checks bounds itself (TMA would zero-fill):
    NaN out without the epilogue, zero codes and a NaN scale with it, in K1
    and K2; every other view is pooled as its plain version pools it."""
    k1, k2 = _one_level_views(cuda, torch.bfloat16, 64, seed=24)
    bias = torch.zeros(64, dtype=torch.bfloat16, device=cuda)
    for kern, args in ((roi_pool.window_pool_multi, k1),
                       (roi_pool.resident_pool, k2)):
        out = kern(*args).reshape(6, 7, 7, 64)
        q, s = kern(*args, quant_bias=bias)
        torch.cuda.synchronize()
        q, s = q.reshape(6, 7, 7, 64), s.reshape(6)
        assert torch.isnan(out[1]).all()
        assert torch.isnan(s[1]) and not q[1].any()
        keep = [0, 2, 3, 4, 5]
        assert torch.isfinite(out[keep]).all() and torch.isfinite(s[keep]).all()
        assert q[keep].abs().max() > 0


def test_bf16_wrappers_need_channels_divisible_by_8(cuda):
    """TMA strides are 16-byte units: the bf16 body takes C % 8 == 0 only;
    float32 takes any even C."""
    for c, ok in ((36, False), (40, True)):
        k1, k2 = _one_level_views(cuda, torch.bfloat16, c, seed=25)
        for kern, args in ((roi_pool.window_pool_multi, k1),
                           (roi_pool.resident_pool, k2),
                           (roi_pool.window_pool,
                            tuple(a[0] for a in k1))):
            if ok:
                kern(*args)
            else:
                with pytest.raises(ValueError, match="divisible by 8"):
                    kern(*args)
    k1, _ = _one_level_views(cuda, torch.float32, 36, seed=25)
    roi_pool.window_pool_multi(*k1)
    torch.cuda.synchronize()


@pytest.mark.parametrize("quantized", [False, True], ids=["pool", "int8"])
def test_bf16_pool_rois_pads_channels_to_8(cuda, quantized):
    """MultiPathNet.pool_rois at C = 20 in bf16, which the kernels' TMA
    strides cannot take: the model pads the features to 24 channels (a
    zero skip bias on the pad lanes) and slices them off. On the card
    against the CPU's plain versions on the same features: pooled values
    to the bf16 tolerance, int8 codes within 1."""
    cfg = preset("tiny")
    mcfg = dataclasses.replace(cfg.model, skip_reduce_dim=20,
                               head_quant="int8" if quantized else "none")
    models = [build_model(mcfg, device=d) for d in ("cpu", cuda)]
    gen = torch.Generator().manual_seed(43)
    stride = models[0].backbone.feature_strides
    feats = {lv: torch.randn((2, 64 // stride[lv], 64 // stride[lv], 20),
                             generator=gen).bfloat16()
             for lv in mcfg.skip_levels}
    rois = torch.from_numpy(_rois(np.random.default_rng(43), 12, 64)
                            ).reshape(2, 6, 4)
    bias = (torch.randn(20, generator=gen) * 0.5).bfloat16()
    outs = []
    for model, dev in zip(models, ("cpu", cuda)):
        args = ({k: v.to(dev) for k, v in feats.items()}, rois.to(dev),
                (64, 64))
        before = profiling.counters()
        outs.append(model.pool_rois_quantized(*args, bias.to(dev))
                    if quantized else model.pool_rois(*args))
        if dev is cuda:
            torch.cuda.synchronize()
            launched = profiling.kernel_launches(before)
            assert (launched["window_pool_multi"]
                    + launched["window_pool_multi_quant"]) > 0
    if quantized:
        (q_c, s_c), (q_g, s_g) = outs
        assert q_g.shape == q_c.shape and q_g.shape[-1] == 20
        assert (q_g.cpu().int() - q_c.int()).abs().max() <= 1
        torch.testing.assert_close(s_g.cpu(), s_c, rtol=1e-2, atol=0)
    else:
        want, got = outs
        assert got.shape == want.shape and got.shape[-1] == 20
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   **_tol(torch.bfloat16))


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
    before = profiling.counters()
    roi_pool.batched_pyramid_pool_resident(flat, meta, rois, 2)
    roi_pool.batched_pyramid_pool_multi(
        [flat], [meta], rois, torch.zeros(4, dtype=torch.int32, device=cuda))
    launched = profiling.kernel_launches(before)
    assert launched["window_pool_multi"] == launched["resident_pool"] == 1


def test_tiny_slice_on_gpu_matches_cpu(cuda):
    """The whole slice at the tiny preset: GPU (kernels, cuDNN, cuBLAS)
    against CPU (plain versions) on the same weights."""
    cfg = preset("tiny")
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dtype="float32"))
    torch.manual_seed(0)
    cpu_model = build_model(cfg.model, device="cpu").eval()
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


# ------------------------------------------------------ backward: K3, K4 ---

def _grad_case(dev, b, canvas, c, stride, n_per_image, seed):
    """One level's pyramid and image-major views, with a float32
    cotangent."""
    (flat, meta), = _levels(dev, torch.float32, b, canvas, c, 1, seed)
    if stride != 16:
        gen = torch.Generator(device=dev).manual_seed(seed)
        f = torch.randn((b, canvas // stride, canvas // stride, c),
                        generator=gen, device=dev)
        flat, meta = roi_pyramid.build_pyramid_batch(f, 1.0 / stride)
    rois = torch.from_numpy(_rois(np.random.default_rng(seed),
                                  b * n_per_image, canvas)).to(dev)
    row0, x0, wy, wx = roi_pool.view_geometry(meta, rois)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    gout = torch.randn((b * n_per_image, 7, 7, c), generator=gen, device=dev)
    return flat, meta, rois, gout, row0, x0, wy, wx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [512, 200])
def test_window_grad_kernel_matches_plain(cuda, c, dtype):
    """K3, float32 by default and in the pyramid dtype when asked."""
    b = 3
    flat, meta, _, gout, row0, x0, wy, wx = _grad_case(cuda, b, 320, c, 16,
                                                       300, seed=11)
    rows, wmax = meta.flat.shape[:2]
    args = (gout, row0, x0, wy, wx, b, rows, wmax)
    before = profiling.counters()
    got = (roi_pool.window_grad(*args) if dtype == torch.float32
           else roi_pool.window_grad(*args, dtype))
    torch.cuda.synchronize()
    assert profiling.kernel_launches(before)["window_grad"] == 1
    want = roi_pool.window_grad_ref(*args)
    assert got.dtype == dtype and got.shape == (b * rows, wmax, c)
    _assert_grad_close(got, want)


def test_window_grad_with_no_views_writes_zeros(cuda):
    """K3 with zero views in every image: the kernel still writes the
    whole gradient, zeros, over whatever the allocator handed it."""
    b, rows, wmax, c = 2, 40, 24, 64
    junk = torch.full((b * rows * wmax * c,), float("nan"), device=cuda)
    del junk   # the next allocation of this size reuses NaN-filled memory
    empty = torch.empty(0, dtype=torch.int32, device=cuda)
    w = (torch.empty((0, 7, 10), device=cuda),
         torch.empty((0, 7, 16), device=cuda))
    before = profiling.counters()
    got = roi_pool.window_grad(torch.empty((0, 7, 7, c), device=cuda), empty,
                               empty, *w, b, rows, wmax)
    torch.cuda.synchronize()
    assert profiling.kernel_launches(before)["window_grad"] == 1
    assert got.shape == (b * rows, wmax, c) and not got.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_window_rmw_grad_kernel_matches_plain(cuda, dtype):
    b, n_per = 2, 200
    flat, meta, _, gout, row0, x0, wy, wx = _grad_case(cuda, b, 320, 64, 4,
                                                       n_per, seed=12)
    img = torch.arange(b, dtype=torch.int32, device=cuda).repeat_interleave(
        n_per)
    row0 = (row0 + img * meta.flat.shape[0]).contiguous()
    args = (gout, row0, x0, wy, wx, tuple(flat.shape), dtype)
    before = profiling.counters()
    got = roi_pool.window_rmw_grad(*args)
    torch.cuda.synchronize()
    assert profiling.kernel_launches(before)["window_rmw_grad"] == 1
    want = roi_pool.window_rmw_grad_ref(*args[:-1], torch.float32)
    assert got.dtype == dtype
    _assert_grad_close(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_window_rmw_grad_at_odd_tile_edges(cuda, dtype):
    """K4 where the buffer does not split into whole 16 x 16 tiles (rows
    and Wmax not multiples of 16), with windows at every column offset
    (x0 not 8-aligned), on the last rows and columns, and C = 70: not a
    multiple of the 32-channel slice, nor of 4 (cotangent rows copied value
    by value) or 8 (the bf16 tile written value by value)."""
    gen = torch.Generator(device=cuda).manual_seed(41)
    n, rows, wmax, c = 400, 53, 37, 70
    row0 = torch.randint(0, rows - 9, (n,), generator=gen, device=cuda,
                         dtype=torch.int32)
    x0 = torch.randint(0, wmax - 15, (n,), generator=gen, device=cuda,
                       dtype=torch.int32)
    row0[:4] = rows - 10
    x0[:4] = wmax - 16
    args = (torch.randn((n, 7, 7, c), generator=gen, device=cuda), row0, x0,
            torch.rand((n, 7, 10), generator=gen, device=cuda),
            torch.rand((n, 7, 16), generator=gen, device=cuda),
            (rows, wmax, c))
    got = roi_pool.window_rmw_grad(*args, dtype)
    torch.cuda.synchronize()
    want = roi_pool.window_rmw_grad_ref(*args, torch.float32)
    assert got.shape == (rows, wmax, c)
    assert want[-1].abs().sum() > 0 and want[:, -1].abs().sum() > 0
    _assert_grad_close(got, want)


def test_grad_kernels_repeat_bit_for_bit(cuda):
    """K3 and K4 sum each cell over the views in index order, with no
    atomics: two calls on the same inputs give equal results, bit for bit,
    on thousands of overlapping windows."""
    b = 4
    _, meta, _, gout, row0, x0, wy, wx = _grad_case(cuda, b, 320, 256, 16,
                                                    500, seed=42)
    rows, wmax = meta.flat.shape[:2]
    for dtype in (torch.float32, torch.bfloat16):
        k3 = [roi_pool.window_grad(gout, row0, x0, wy, wx, b, rows, wmax,
                                   dtype) for _ in range(2)]
        img = torch.arange(b, dtype=torch.int32,
                           device=cuda).repeat_interleave(500)
        absolute = (row0 + img * rows).contiguous()
        k4 = [roi_pool.window_rmw_grad(gout, absolute, x0, wy, wx,
                                       (b * rows, wmax, 256), dtype)
              for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(*k3) and torch.equal(*k4)
        assert torch.equal(k3[0], k4[0])   # one body: K4 is K3 at one image


def test_grad_wrappers_check_their_inputs(cuda):
    _, meta, _, gout, row0, x0, wy, wx = _grad_case(cuda, 1, 160, 64, 16, 4,
                                                    seed=13)
    rows, wmax = meta.flat.shape[:2]
    with pytest.raises(TypeError):
        roi_pool.window_grad(gout.bfloat16(), row0, x0, wy, wx, 1, rows,
                             wmax)
    with pytest.raises(ValueError):
        roi_pool.window_grad(gout[..., :63], row0, x0, wy, wx, 1, rows,
                             wmax)
    with pytest.raises(ValueError):
        roi_pool.window_grad(gout, row0, x0, wy, wx, 3, rows, wmax)
    bad = row0.clone()
    bad[0] = rows - 5
    with pytest.raises(ValueError, match="outside"):
        roi_pool.window_grad(gout, bad, x0, wy, wx, 1, rows, wmax)
    with pytest.raises(ValueError, match="outside"):
        roi_pool.window_rmw_grad(gout, bad, x0, wy, wx, (rows, wmax, 64),
                                 torch.float32)


def test_window_pool_multi_backward_matches_autograd_of_plain(cuda):
    """The trainable K1's backward with the routing constants set so the
    reference would take a different route per level (K3 for c5, the
    per-image placement for c4, K4 for c3): on the card c4 goes to K3 and
    the placement GEMMs never run. Against autograd through the plain
    forward."""
    b, canvas, c, n_per = 2, 320, 64, 100
    pyrs = _levels(cuda, torch.float32, b, canvas, c, 3, seed=14)
    flats = [f.detach().requires_grad_() for f, _ in pyrs]
    metas = [m for _, m in pyrs]
    rois = torch.from_numpy(_rois(np.random.default_rng(14), b * n_per,
                                  canvas)).to(cuda)
    img = torch.arange(b, dtype=torch.int32, device=cuda).repeat_interleave(
        n_per)
    gen = torch.Generator(device=cuda).manual_seed(15)
    gout = torch.randn((b * n_per, 7, 7, c), generator=gen, device=cuda)
    budget = roi_pool._GRAD_VMEM_BUDGET
    cells = roi_pool._PLACE_PER_IMAGE_MAX_CELLS
    sizes = [m.flat.shape[0] * m.flat.shape[1] for m in metas]
    try:  # c3 -> K4, c4 -> placement, c5 -> K3
        roi_pool._GRAD_VMEM_BUDGET = sizes[2] * c * 4
        roi_pool._PLACE_PER_IMAGE_MAX_CELLS = sizes[1]
        before = profiling.counters()
        out = roi_pool.batched_pyramid_pool_multi(flats, metas, rois, img,
                                                  trainable=True)
        got = torch.autograd.grad((out * gout).sum(), flats)
        launched = profiling.kernel_launches(before)
        assert (launched["window_grad"], launched["window_rmw_grad"],
                launched["placements"]) == (2, 1, 0)
    finally:
        roi_pool._GRAD_VMEM_BUDGET = budget
        roi_pool._PLACE_PER_IMAGE_MAX_CELLS = cells
    row0s, x0s, wys, wxs = zip(*(roi_pool.view_geometry(m, rois)
                                 for m in metas))
    plain = roi_pool.window_pool_multi_ref(
        flats, [r + img * m.flat.shape[0] for r, m in zip(row0s, metas)],
        x0s, wys, wxs)
    want = torch.autograd.grad((plain * gout).sum(), flats)
    for g_, w_ in zip(got, want):
        _assert_grad_close(g_, w_)


def test_tiny_train_step_on_gpu_matches_cpu(cuda, monkeypatch):
    """One float32 train step at the tiny preset, conv1-2 frozen and
    dropout off: the GPU (kernels, cuDNN, cuBLAS) against the CPU (plain
    versions) from the same weights and the same sample draws. Loss and
    updated parameters, atol 1e-4."""
    cfg = preset("tiny")
    cfg = cfg.replace(
        model=dataclasses.replace(cfg.model, dtype="float32"),
        data=dataclasses.replace(cfg.data, hflip_prob=0.0),
        train=dataclasses.replace(cfg.train, freeze_backbone_stages=2))
    rng = np.random.default_rng(16)
    b, p, g = 2, cfg.data.max_proposals, cfg.data.max_gt_per_image
    gt = np.concatenate([rng.uniform(0, 30, (b, g, 2)),
                         rng.uniform(38, 60, (b, g, 2))], -1)
    near = gt[:, rng.integers(0, g, p)] + rng.normal(0, 2, (b, p, 4))
    batch = Batch(rng.integers(0, 256, (b, 60, 64, 3), dtype=np.uint8),
                  np.asarray([[60, 64], [50, 41]], np.float32),
                  near.astype(np.float32), np.ones((b, p), bool),
                  gt.astype(np.float32),
                  rng.integers(1, 5, (b, g)).astype(np.int32),
                  np.arange(g)[None].repeat(b, 0) < 5)

    def sample_cpu_noise(generator, proposals, *args, shard=None, **kw):
        # the same uniform draws on both devices: made on the CPU (one
        # device: the step passes no batch shard)
        assert shard is None
        b, n = proposals.shape[0], proposals.shape[1] + args[1].shape[1]
        noise = torch.rand((b, 2, n), generator=torch.Generator(
            ).manual_seed(0)).to(proposals.device)
        return sampler.sample_rois(noise, proposals, *args, **kw)

    monkeypatch.setattr(sampler, "sample_batch", sample_cpu_noise)
    results, init = [], None
    for dev in ("cpu", cuda):
        trainer = Trainer(cfg, device=dev)
        state = trainer.init_state(0)
        if init is None:
            init = {k: v.clone() for k, v in
                    trainer.model.state_dict().items()}
        trainer.model.load_state_dict(init)
        trainer.model.head.dropout_rate = 0.0
        state, metrics = trainer.step(state, batch)
        results.append((float(metrics["loss"]),
                        {k: v.detach().cpu().clone() for k, v in
                         trainer.model.state_dict().items()}))
    (loss_c, sd_c), (loss_g, sd_g) = results
    assert abs(loss_c - loss_g) <= 1e-4 * max(1.0, abs(loss_c))
    for name in sd_c:
        torch.testing.assert_close(sd_g[name], sd_c[name], rtol=0, atol=1e-4,
                                   msg=name)


def test_tiny_bf16_train_step_repeats_bit_for_bit(cuda):
    """Two Trainer.steps from one state (parameters, momentum, step count,
    generator) on one batch, at the tiny preset in bf16 with dropout on:
    equal loss, gradients and updated parameters, bit for bit. cuDNN is
    set to its deterministic algorithms here: its default backward
    algorithms may sum in a run-dependent order (they are library code,
    not the port's)."""
    cfg = preset("tiny")
    assert cfg.model.dtype == "bfloat16"
    rng = np.random.default_rng(17)
    b, p, g = 2, cfg.data.max_proposals, cfg.data.max_gt_per_image
    gt = np.concatenate([rng.uniform(0, 30, (b, g, 2)),
                         rng.uniform(38, 60, (b, g, 2))], -1)
    near = gt[:, rng.integers(0, g, p)] + rng.normal(0, 2, (b, p, 4))
    batch = Batch(rng.integers(0, 256, (b, 60, 64, 3), dtype=np.uint8),
                  np.asarray([[60, 64], [50, 41]], np.float32),
                  near.astype(np.float32), np.ones((b, p), bool),
                  gt.astype(np.float32),
                  rng.integers(1, 5, (b, g)).astype(np.int32),
                  np.arange(g)[None].repeat(b, 0) < 5)
    trainer = Trainer(cfg, device=cuda)
    state = trainer.init_state(0)
    state, _ = trainer.step(state, batch)      # lr > 0 and momentum from here
    saved = snapshot_train_state(trainer, state)
    previous = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for _ in range(2):
            state = restore_train_state(trainer, saved)
            before = profiling.counters()
            _, metrics = trainer.step(state, batch)
            assert profiling.kernel_launches(before)["window_grad"] > 0
            runs.append((metrics["loss"].clone(),
                         {n: (p_.detach().clone(), p_.grad.clone())
                          for n, p_ in trainer.model.named_parameters()
                          if p_.grad is not None}))
    finally:
        torch.backends.cudnn.deterministic = previous
    (loss_a, a), (loss_b, b_) = runs
    assert torch.equal(loss_a, loss_b)
    assert a.keys() == b_.keys() and a
    for name in a:
        assert torch.equal(a[name][1], b_[name][1]), f"gradient of {name}"
        assert torch.equal(a[name][0], b_[name][0]), name


# ------------------------------------------- prefetch and device batches ---

def _tiny_split(root, n=8):
    from multipathnet_tpu_torch.data import synthetic
    from multipathnet_tpu_torch.data.coco import CocoLoader
    from multipathnet_tpu_torch.data.proposals import ProposalStore

    fx = synthetic.generate(str(root), num_images=n, image_size=64,
                            proposals_per_image=24, seed=2)
    return (CocoLoader(fx["annotations"], fx["images"]),
            ProposalStore.load(fx["proposals"]))


@pytest.mark.parametrize("delay", ["copy", "read"])
def test_epoch_on_device_equals_synchronous_copies(cuda, tmp_path, delay):
    """A whole epoch through epoch_on_device (pinned memory, a side
    stream, two batches ahead) equals synchronous put_batch copies of
    epoch(), bit for bit, with each half of the stream discipline put under
    load. "copy": a long device sleep is queued on the copy stream before
    each copy and each batch is read at once on the consumer stream, so a
    consumer that did not wait for the copy's event would read the memory
    before the copy lands. "read": the sleep is queued on the consumer
    stream before each read and the batch is dropped at once, so without
    record_stream the caching allocator would hand the memory to a later
    copy on the side stream while the read is still queued."""
    from multipathnet_tpu_torch.data.pipeline import DetectionPipeline

    cfg = preset("tiny")
    trainer = Trainer(cfg, device=cuda)
    pipe = DetectionPipeline(*_tiny_split(tmp_path, n=16), cfg.data,
                             batch_size=2, seed=3)

    def put(batch):
        if delay == "copy":
            with torch.cuda.stream(trainer._copy.stream):
                torch.cuda._sleep(20_000_000)
        return trainer.stream_batch(batch)

    got = []
    for batch in pipe.epoch_on_device(0, put):
        assert all(t.is_cuda for t in batch if t is not None)
        if delay == "read":
            torch.cuda._sleep(20_000_000)
        got.append([None if t is None else t.clone() for t in batch])
        del batch
    want = [trainer.put_batch(b) for b in pipe.epoch(0)]
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        for name, gt, wt in zip(w._fields, g, w):
            if wt is None:
                assert gt is None, name
            else:
                assert gt.dtype == wt.dtype and torch.equal(gt, wt), name


def test_detector_takes_a_device_batch_without_host_copy(cuda, tmp_path,
                                                         monkeypatch):
    """Detector.__call__ hands tensors already on the card to detect_batch
    as they are (the images' data_ptr reaches it), with the same output as
    for the numpy batch."""
    from multipathnet_tpu_torch.data.pipeline import DetectionPipeline
    from multipathnet_tpu_torch.eval import detect

    cfg = preset("tiny")
    model = build_model(cfg.model, device=cuda)
    det = detect.Detector(model, cfg)
    pipe = DetectionPipeline(*_tiny_split(tmp_path), cfg.data, batch_size=2)
    _, host = next(pipe.eval_batches())
    want = det(*host[:4])
    dev = [torch.as_tensor(x, device=cuda) for x in host[:4]]
    seen = []
    real = detect.detect_batch

    def spy(model, cfg, images, *rest):
        seen.append(images.data_ptr())
        return real(model, cfg, images, *rest)

    monkeypatch.setattr(detect, "detect_batch", spy)
    got = det(*dev)
    assert seen == [dev[0].data_ptr()]
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


# ------------------------------------------------- K1/K2 int8 epilogue ---

def _quant_cases(dev, dtype, c, seed):
    """K1 (3 levels, 2 images x 300 views) and K2 (2 x 300 views over the
    coarsest level) arguments, and a skip bias in the pyramid dtype."""
    b, canvas, n = 2, 320, 600
    pyrs = _levels(dev, dtype, b, canvas, c, 3, seed=seed)
    rois = torch.from_numpy(_rois(np.random.default_rng(seed), n,
                                  canvas)).to(dev)
    img_idx = torch.arange(b, dtype=torch.int32,
                           device=dev).repeat_interleave(n // b)
    k1 = [[], [], [], [], []]
    for flat, meta in pyrs:
        row0, x0, wy, wx = roi_pool.view_geometry(meta, rois)
        row0 = (row0 + img_idx * meta.flat.shape[0]).contiguous()
        for dst, v in zip(k1, (flat, row0, x0, wy, wx)):
            dst.append(v)
    flat, meta = pyrs[-1]
    row0, x0, wy, wx = roi_pool.view_geometry(meta, rois)
    rows, wmax = meta.flat.shape[:2]
    v = n // b
    k2 = [flat.reshape(b, rows, wmax, c), row0.reshape(b, v),
          x0.reshape(b, v), wy.reshape(b, v, 7, 10), wx.reshape(b, v, 7, 16)]
    gen = torch.Generator(device=dev).manual_seed(seed)
    bias = (torch.randn(c, generator=gen, device=dev) * 0.5).to(dtype)
    return k1, k2, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [512, 200, 32, 72, 1024])
def test_quant_epilogue_matches_plain(cuda, dtype, c):
    """K1 and K2 with the epilogue: bit for bit against quant_view_ref of
    the same kernel's pooled output; codes within 1 and scales to the pooled
    tolerance against the fully plain version. C = 1024 is wider than a
    pool block's epilogue: the pool, then the epilogue kernel."""
    k1, k2, bias = _quant_cases(cuda, dtype, c, seed=21)
    rtol = 1e-5 if dtype == torch.float32 else 1e-2
    for kern, ref, args in ((roi_pool.window_pool_multi,
                             roi_pool.window_pool_multi_ref, k1),
                            (roi_pool.resident_pool,
                             roi_pool.resident_pool_ref, k2)):
        before = profiling.counters()
        q, s = kern(*args, quant_bias=bias)
        torch.cuda.synchronize()
        assert profiling.kernel_launches(before)[kern.__name__ + "_quant"] == 1
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        pooled = kern(*args)
        n = s.numel()
        want_q, want_s = roi_pool.quant_view_ref(
            pooled.reshape(n, 7, 7, c), bias)
        assert torch.equal(q.reshape(n, 7, 7, c), want_q)
        assert torch.equal(s.reshape(n), want_s)
        plain_q, plain_s = ref(*args, quant_bias=bias)
        assert (q.int() - plain_q.int()).abs().max() <= 1
        torch.testing.assert_close(s, plain_s, rtol=rtol, atol=0)


def test_quant_out_of_range_view_is_zero_codes_nan_scale(cuda):
    (flat, meta), = _levels(cuda, torch.bfloat16, 1, 160, 64, 1, seed=22)
    rois = torch.tensor([[10.0, 10.0, 60.0, 70.0]] * 2, device=cuda)
    row0, x0, wy, wx = roi_pool.view_geometry(meta, rois)
    row0[1] = flat.shape[0] - 5          # window hangs past the last row
    bias = torch.zeros(64, dtype=torch.bfloat16, device=cuda)
    q, s = roi_pool.window_pool_multi([flat], [row0], [x0], [wy], [wx],
                                      quant_bias=bias)
    torch.cuda.synchronize()
    assert torch.isfinite(s[0]) and torch.isnan(s[1])
    assert q[0].abs().max() > 0 and not q[1].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [512, 1024])
def test_quant_epilogue_keeps_a_nan_as_plain(cuda, dtype, c):
    """A NaN cell in every level's pyramid (features NaN upstream, as
    bench.py's draw of a ResNet's BN statistics makes them), inside the
    first view's windows: K1 and K2 with the epilogue give each view whose
    y holds a NaN zero codes and a NaN scale, as quant_view_ref of their
    own pooled output does (the ReLU and the max keep a NaN), and every
    other view its codes and scale bit for bit. C = 1024: the pool, then
    the epilogue kernel."""
    k1, k2, bias = _quant_cases(cuda, dtype, c, seed=24)
    for flat, row0, x0 in zip(*k1[:3]):
        flat[int(row0[0]) + 1, int(x0[0]) + 1] = float("nan")
    for kern, args in ((roi_pool.window_pool_multi, k1),
                       (roi_pool.resident_pool, k2)):
        q, s = kern(*args, quant_bias=bias)
        pooled = kern(*args)
        torch.cuda.synchronize()
        n = s.numel()
        want_q, want_s = roi_pool.quant_view_ref(
            pooled.reshape(n, 7, 7, c), bias)
        nan = torch.isnan(want_s)
        assert bool(nan[0]) and 0 < int(nan.sum()) < n, int(nan.sum())
        s = s.reshape(n)
        assert torch.equal(torch.isnan(s), nan)
        assert torch.equal(s[~nan], want_s[~nan])
        assert torch.equal(q.reshape(n, 7, 7, c), want_q)
        assert not q.reshape(n, -1)[nan].any()


def test_quant_wrappers_check_their_inputs(cuda):
    (flat, meta), = _levels(cuda, torch.bfloat16, 1, 160, 64, 1, seed=23)
    rois = torch.tensor([[10.0, 10.0, 60.0, 70.0]], device=cuda)
    geo = [[t] for t in roi_pool.view_geometry(meta, rois)]
    bias = torch.zeros(64, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError):
        roi_pool.window_pool_multi([flat], *geo, quant_bias=bias.float())
    with pytest.raises(ValueError):
        roi_pool.window_pool_multi([flat], *geo, quant_bias=bias[:32])
    with pytest.raises(ValueError):
        roi_pool.window_pool_multi([flat], *geo, quant_bias=bias.cpu())
    # wider than a pool block's epilogue: taken, in two launches
    wide = torch.randn((flat.shape[0], flat.shape[1], 520),
                       device=cuda).bfloat16()
    wide_bias = torch.zeros(520, dtype=torch.bfloat16, device=cuda)
    q, s = roi_pool.window_pool_multi([wide], *geo, quant_bias=wide_bias)
    torch.cuda.synchronize()
    assert q.shape == (1, 7, 7, 520) and s.shape == (1,)
    want_q, want_s = roi_pool.quant_view_ref(
        roi_pool.window_pool_multi([wide], *geo), wide_bias)
    assert torch.equal(q, want_q) and torch.equal(s, want_s)
    with pytest.raises(ValueError, match="eval-only"):
        roi_pool.batched_pyramid_pool_multi(
            [flat], [meta], rois, torch.zeros(1, dtype=torch.int32,
                                              device=cuda),
            trainable=True, quant_bias=bias)


@pytest.mark.parametrize("ranks", [(0, 0), (16, 8), (12, 6)],
                         ids=["int8", "int8_svd", "int8_svd_odd_ranks"])
def test_tiny_int8_slice_on_gpu_matches_cpu(cuda, ranks):
    """The int8 (and int8 + truncated-SVD) slice at the tiny preset in
    float32: the GPU (quant kernels, torch._int_mm) against the CPU (plain
    versions) from one float tree transformed at load. Probabilities atol
    2e-3: a pooled sum that differs in its last bit can flip one int8 code
    at a rounding tie. Ranks (12, 6) are no multiples of 8: Int8Linear pads
    the factored layers' K for torch._int_mm."""
    from multipathnet_tpu_torch.eval.detect import Detector
    from multipathnet_tpu_torch.models import convert
    from multipathnet_tpu_torch.models.multipath import init_params_

    cfg = preset("tiny")
    fcfg = cfg.replace(model=dataclasses.replace(cfg.model, dtype="float32"))
    fmodel = init_params_(build_model(fcfg.model, device="cpu"),
                          torch.Generator().manual_seed(0))
    tree = convert.flax_from_state_dict(fmodel.state_dict())
    qcfg = fcfg.replace(model=dataclasses.replace(
        fcfg.model, head_quant="int8", fc6_rank=ranks[0], fc7_rank=ranks[1]))
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (2, 60, 64, 3), dtype=np.uint8)
    hws = np.asarray([[60, 64], [50, 41]], np.float32)
    xy = rng.uniform(0, 40, (2, 24, 2))
    wh = rng.uniform(6, 24, (2, 24, 2))
    props = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    outs = []
    for dev in ("cpu", cuda):
        det = Detector(build_model(qcfg.model, device=dev), qcfg,
                       params=tree)
        before = profiling.counters()
        outs.append(score_batch(det.model, qcfg, *(
            torch.from_numpy(x).to(dev) for x in (images, hws, props))))
        launched = profiling.kernel_launches(before)
        for k in ("window_pool_multi", "resident_pool"):
            # the int8 route runs only the quant instances, and only on
            # the card
            assert launched[k] == 0
            assert (launched[k + "_quant"] > 0) == (dev is cuda)
    (want_b, want_p), (got_b, got_p) = outs
    torch.testing.assert_close(got_p.cpu(), want_p, rtol=0, atol=2e-3)
    torch.testing.assert_close(got_b.cpu(), want_b, rtol=0, atol=5e-2)


# ------------------------------------- K5, the single-level backward, P ---

def _k5_args(dev, dtype, c, seed, b=2, canvas=320, n=600):
    """K5's arguments: n views (image-major) over a batch of c3-sized
    pyramids, rows absolute."""
    (flat, meta), = _levels(dev, dtype, b, canvas, c, 3, seed=seed)[:1]
    rois = torch.from_numpy(_rois(np.random.default_rng(seed), n,
                                  canvas)).to(dev)
    img = torch.arange(b, dtype=torch.int32, device=dev).repeat_interleave(
        n // b)
    row0, x0, wy, wx = roi_pool.view_geometry(meta, rois)
    return flat, (row0 + img * meta.flat.shape[0]).contiguous(), x0, wy, wx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [512, 200])
def test_window_pool_kernel_matches_plain(cuda, dtype, c):
    """K5 against window_pool_ref; its own counter moves, K1's does not."""
    args = _k5_args(cuda, dtype, c, seed=31)
    before = profiling.counters()
    got = roi_pool.window_pool(*args)
    torch.cuda.synchronize()
    launched = profiling.kernel_launches(before)
    assert launched["window_pool"] == 1
    assert launched["window_pool_multi"] == 0
    want = roi_pool.window_pool_ref(*args)
    assert got.dtype == want.dtype == dtype and got.shape == (600, 7, 7, c)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


def test_window_pool_checks_its_inputs(cuda):
    flat, row0, x0, wy, wx = _k5_args(cuda, torch.float32, 64, seed=32)
    with pytest.raises(TypeError):
        roi_pool.window_pool(flat, row0.long(), x0, wy, wx)
    with pytest.raises(TypeError):
        roi_pool.window_pool(flat.half(), row0, x0, wy, wx)
    with pytest.raises(ValueError):
        roi_pool.window_pool(flat[..., :63], row0, x0, wy, wx)
    with pytest.raises(ValueError):
        roi_pool.window_pool(flat[None], row0, x0, wy, wx)
    with pytest.raises(ValueError):
        roi_pool.window_pool(flat, row0.cpu(), x0, wy, wx)
    out = roi_pool.window_pool(flat, row0[:0], x0[:0], wy[:0], wx[:0])
    assert out.shape == (0, 7, 7, 64)


def test_accumulate_windows_launches_k4_once(cuda, monkeypatch):
    """Every width goes to K4, once per call, origins clamped first; the
    plain scatter (index_put_) never runs on the card."""
    def no_scatter(*a, **k):
        raise AssertionError("the plain scatter ran on the card")

    gen = torch.Generator(device=cuda).manual_seed(33)
    n, rows, c = 300, 64, 64
    cases = []
    for wmax in (48, 160):
        row0 = torch.randint(-5, rows, (n,), generator=gen, device=cuda,
                             dtype=torch.int32)
        x0 = torch.randint(-1, wmax // 8 + 1, (n,), generator=gen,
                           device=cuda, dtype=torch.int32) * 8
        cases.append((row0, x0,
                      torch.randn((n, 7, 7, c), generator=gen, device=cuda),
                      torch.rand((n, 7, 10), generator=gen, device=cuda),
                      torch.rand((n, 7, 16), generator=gen, device=cuda),
                      (rows, wmax, c), torch.float32))
    with monkeypatch.context() as m:
        m.setattr(roi_pool, "_scatter_windows", no_scatter)
        got = []
        for args in cases:
            before = profiling.counters()
            got.append(roi_pool.accumulate_windows(*args))
            torch.cuda.synchronize()
            assert profiling.kernel_launches(before)["window_rmw_grad"] == 1
    for g_, args in zip(got, cases):
        want = roi_pool.accumulate_windows(*(t.cpu() for t in args[:5]),
                                           *args[5:])
        torch.testing.assert_close(g_.cpu(), want, **_tol(torch.float32))


def test_single_level_backwards_match_autograd_of_plain(cuda):
    """window_pool_trainable, resident_pool_trainable and WindowPoolMulti
    without rows_list: the gradients on the card against autograd through
    the plain forward, float32; each backward launches K4 per level."""
    b, v, c = 2, 150, 64
    pyrs = _levels(cuda, torch.float32, b, 320, c, 3, seed=34)
    rois = torch.from_numpy(_rois(np.random.default_rng(34), b * v,
                                  320)).to(cuda)
    img = torch.arange(b, dtype=torch.int32, device=cuda).repeat_interleave(v)
    gen = torch.Generator(device=cuda).manual_seed(35)
    gout = torch.randn((b * v, 7, 7, c), generator=gen, device=cuda)
    geos = []
    for flat, meta in pyrs:
        row0, x0, wy, wx = roi_pool.view_geometry(meta, rois)
        geos.append(((row0 + img * meta.flat.shape[0]).contiguous(), x0, wy,
                     wx))

    def grads(fn, flats):
        flats = [f.detach().requires_grad_() for f in flats]
        before = profiling.counters()
        out = torch.autograd.grad((fn(*flats) * gout).sum(), flats)
        return out, profiling.kernel_launches(before)["window_rmw_grad"]

    c3 = pyrs[0][0]
    got, k4 = grads(lambda f: roi_pool.window_pool_trainable(f, *geos[0]),
                    [c3])
    want, _ = grads(lambda f: roi_pool.window_pool_ref(f, *geos[0]), [c3])
    assert k4 == 1
    torch.testing.assert_close(got[0], want[0], **_tol(torch.float32))

    flat5, meta5 = pyrs[2]
    rows, wmax = meta5.flat.shape[:2]
    row0, x0, wy, wx = roi_pool.view_geometry(meta5, rois)
    rel = (row0.reshape(b, v), x0.reshape(b, v), wy.reshape(b, v, 7, 10),
           wx.reshape(b, v, 7, 16))
    flat4 = flat5.reshape(b, rows, wmax, c)
    g5 = gout.reshape(b, v, 7, 7, c)
    before = profiling.counters()
    f = flat4.detach().requires_grad_()
    (got,) = torch.autograd.grad(
        (roi_pool.resident_pool_trainable(f, *rel) * g5).sum(), f)
    assert profiling.kernel_launches(before)["window_rmw_grad"] == 1
    (want,) = torch.autograd.grad(
        (roi_pool.resident_pool_ref(f, *rel) * g5).sum(), f)
    torch.testing.assert_close(got, want, **_tol(torch.float32))

    flats = [flat for flat, _ in pyrs]
    geometry = [list(a) for a in zip(*geos)]
    got, k4 = grads(lambda *fs: roi_pool.WindowPoolMulti.apply(
        geometry, None, None, *fs), flats)
    want, _ = grads(lambda *fs: roi_pool.window_pool_multi_ref(
        list(fs), *geometry), flats)
    assert k4 == 3
    for g_, w_ in zip(got, want):
        torch.testing.assert_close(g_, w_, **_tol(torch.float32))


@pytest.mark.parametrize("dtype,c", [(torch.bfloat16, 512),
                                     (torch.int8, 512),
                                     (torch.bfloat16, 200),
                                     (torch.int8, 208)],
                         ids=["512-bf16", "512-int8", "200-bf16", "208-int8"])
def test_window_read_probe_matches_plain(cuda, dtype, c):
    """At 3000 views over 512 rows; C = 200 (bf16) and 208 (int8) are no
    multiple of the kernel's 256-channel slice (int8 needs C % 16 for its
    TMA strides: test_window_read_probe_checks_its_inputs)."""
    from multipathnet_tpu_torch.tools import probe_int8_window_dma as probe

    flat, row0, x0 = probe.probe_inputs(dtype, 3000, 512, 160, c,
                                        device=cuda)
    before = profiling.counters()
    got = probe.window_read_probe(flat, row0, x0)
    torch.cuda.synchronize()
    assert profiling.kernel_launches(before)["window_read_probe"] == 1
    want = probe.window_read_probe_ref(flat, row0, x0)
    assert got.dtype == want.dtype == torch.bfloat16
    assert got.shape == (3000, 49, c)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-2)


def _probe_case(case, dtype, device):
    """(flat, row0, x0) of one P case, drawn with numpy from seed 0: views
    all in one 16-row band; views in the last band of a 509-row buffer,
    one window ending on the last row; C = 200 (bf16) / 208 (int8), no
    multiple of the 256-channel slice, over two slices (C + 256); one
    view; 2049 views, one past a block of the order pass."""
    rng = np.random.default_rng(0)
    rows, wmax, c, n = 512, 64, 64, 300
    if case == "odd_c":
        c = (200 if dtype == torch.bfloat16 else 208) + 256
    elif case == "one_view":
        n = 1
    elif case == "ragged_views":
        n = 2049
    elif case == "last_band":
        rows = 509
    row0 = rng.integers(0, rows - 9, n)
    if case == "one_band":
        row0 = rng.integers(32, 48, n)
    elif case == "last_band":
        row0 = rng.integers(496, rows - 9, n)
        row0[7] = rows - 10
    x0 = rng.integers(0, wmax - 15, n)
    x = rng.standard_normal((rows, wmax, c)).astype(np.float32)
    flat = (torch.from_numpy(np.clip(np.trunc(x * 40), -127, 127)).to(
        torch.int8) if dtype == torch.int8 else torch.from_numpy(x).to(dtype))
    as_i32 = lambda a: torch.from_numpy(a.astype(np.int32)).to(device)
    return flat.to(device), as_i32(row0), as_i32(x0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8],
                         ids=["bf16", "int8"])
@pytest.mark.parametrize("case", ["one_band", "last_band", "odd_c",
                                  "one_view", "ragged_views"])
def test_window_read_probe_orders_views_by_band(cuda, case, dtype):
    """The band-ordered body on the cases _probe_case lists: against the
    plain version (rtol/atol 1e-2), bit-equal over two calls and, view by
    view, under a permutation of the views."""
    from multipathnet_tpu_torch.tools import probe_int8_window_dma as probe

    flat, row0, x0 = _probe_case(case, dtype, cuda)
    got = probe.window_read_probe(flat, row0, x0)
    again = probe.window_read_probe(flat, row0, x0)
    perm = torch.from_numpy(np.random.default_rng(1).permutation(
        row0.numel())).to(cuda)
    shuffled = probe.window_read_probe(flat, row0[perm].contiguous(),
                                       x0[perm].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(shuffled, got[perm])
    torch.testing.assert_close(
        got.float(), probe.window_read_probe_ref(flat, row0, x0).float(),
        rtol=1e-2, atol=1e-2)


def test_window_read_probe_checks_its_inputs(cuda):
    from multipathnet_tpu_torch.tools import probe_int8_window_dma as probe

    flat, row0, x0 = probe.probe_inputs(torch.int8, 10, 64, 48, 16,
                                        device=cuda)
    with pytest.raises(TypeError):
        probe.window_read_probe(flat.float(), row0, x0)
    with pytest.raises(TypeError):
        probe.window_read_probe(flat, row0.long(), x0)
    with pytest.raises(ValueError):
        probe.window_read_probe(flat[..., :14], row0, x0)
    with pytest.raises(ValueError):
        probe.window_read_probe(flat[None], row0, x0)
    with pytest.raises(ValueError):
        probe.window_read_probe(flat, row0, x0.cpu())
    with pytest.raises(ValueError):         # int8 rows of 200 bytes: TMA
        probe.window_read_probe(             # strides are 16-byte units
            torch.zeros((64, 48, 200), dtype=torch.int8, device=cuda),
            row0, x0)
    with pytest.raises(ValueError):         # smaller than one window
        probe.window_read_probe(flat[:9].contiguous(), row0, x0)
    bad = row0.clone()
    bad[3] = 60                      # the window hangs past the last row
    out = probe.window_read_probe(flat, bad, x0)
    torch.cuda.synchronize()
    assert torch.isnan(out[3]).all() and torch.isfinite(out[2]).all()


# ------------------------- BASELINE configs 1, 2 and the dense topology ---

FOVEAL = (1.0, 1.5, 2.0, 4.0)


def _foveal_views(rois, factors, canvas):
    """(B, R, 4) ROIs -> each one's views, image-major and view by view
    within an image (as MultiPathNet.pool_rois stacks them), clipped to
    the canvas, and each view's image."""
    from multipathnet_tpu_torch.ops.boxes import expand

    b, r = rois.shape[:2]
    views = torch.stack([expand(rois, f, canvas, canvas) for f in factors],
                        dim=1).reshape(-1, 4)
    img = torch.arange(b, dtype=torch.int32,
                       device=rois.device).repeat_interleave(len(factors) * r)
    return views, img


def _k1_args(pyrs, views, img):
    args = [[], [], [], [], []]
    for flat, meta in pyrs:
        row0, x0, wy, wx = roi_pool.view_geometry(meta, views)
        row0 = (row0 + img * meta.flat.shape[0]).contiguous()
        for dst, v in zip(args, (flat, row0, x0, wy, wx)):
            dst.append(v)
    return args


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_resident_pool_at_batch_one(cuda, dtype):
    """K2 as config 1 (`fastrcnn_vgg16_single`) serves: one image's 1000
    1x views over its c5 pyramid at 640^2, C = 512; and config 2's 3000
    context views of one image. Against the plain version."""
    (flat, meta), = _levels(cuda, dtype, 1, 640, 512, 1, seed=51)
    rng = np.random.default_rng(51)
    rois = torch.from_numpy(_rois(rng, 1000, 640)).to(cuda)[None]
    rows, wmax = meta.flat.shape[:2]
    for factors in (FOVEAL[:1], FOVEAL[1:]):
        views, _ = _foveal_views(rois, factors, 640)
        row0, x0, wy, wx = roi_pool.view_geometry(meta, views)
        v = views.shape[0]
        args = (flat.reshape(1, rows, wmax, 512), row0.reshape(1, v),
                x0.reshape(1, v), wy.reshape(1, v, 7, 10),
                wx.reshape(1, v, 7, 16))
        before = profiling.counters()
        got = roi_pool.resident_pool(*args)
        torch.cuda.synchronize()
        assert profiling.kernel_launches(before)["resident_pool"] == 1
        want = roi_pool.resident_pool_ref(*args)
        assert got.shape == (1, v, 7, 7, 512)
        torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


def _dense_case(dev, dtype, b=2, r=150, canvas=640, c=256, seed=52):
    """The dense topology's one K1 group: every ROI's four foveal views
    (1x, 1.5x, 2x, 4x, the wide ones clipped at the border) over
    c3 + c4 + c5, so c3 and c4 take context views too."""
    pyrs = _levels(dev, dtype, b, canvas, c, 3, seed=seed)
    rng = np.random.default_rng(seed)
    rois = torch.from_numpy(_rois(rng, b * r, canvas)).to(dev).reshape(
        b, r, 4)
    views, img = _foveal_views(rois, FOVEAL, canvas)
    return pyrs, rois, views, img


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_window_pool_multi_at_dense_geometry(cuda, dtype):
    """K1 over 4 views x 3 levels (the dense topology), context views on
    c3 and c4 at every pyramid scale their sizes reach: against the plain
    version, and with the int8 epilogue bit for bit against the plain
    epilogue on the kernel's own pooled output (codes within 1 and scales
    to the pooled tolerance of the fully plain version)."""
    pyrs, _, views, img = _dense_case(cuda, dtype)
    args = _k1_args(pyrs, views, img)
    c3_meta = pyrs[0][1]
    c3_rows = c3_meta.flat.shape[0]
    scales = torch.searchsorted(c3_meta.row_offsets.long(),
                                (args[1][0] % c3_rows).long(),
                                right=True) - 1
    assert int(scales.max()) >= 3   # the 4x views reach coarse c3 scales
    before = profiling.counters()
    got = roi_pool.window_pool_multi(*args)
    torch.cuda.synchronize()
    assert profiling.kernel_launches(before)["window_pool_multi"] == 1
    want = roi_pool.window_pool_multi_ref(*args)
    assert got.shape == (views.shape[0], 7, 7, 256)
    torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))

    gen = torch.Generator(device=cuda).manual_seed(53)
    bias = (torch.randn(256, generator=gen, device=cuda) * 0.5).to(dtype)
    before = profiling.counters()
    q, s = roi_pool.window_pool_multi(*args, quant_bias=bias)
    torch.cuda.synchronize()
    assert profiling.kernel_launches(before)["window_pool_multi_quant"] == 1
    own_q, own_s = roi_pool.quant_view_ref(got, bias)
    assert torch.equal(q, own_q) and torch.equal(s, own_s)
    plain_q, plain_s = roi_pool.window_pool_multi_ref(*args, quant_bias=bias)
    assert (q.int() - plain_q.int()).abs().max() <= 1
    torch.testing.assert_close(
        s, plain_s, rtol=1e-5 if dtype == torch.float32 else 1e-2, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_grad_kernels_at_dense_train_geometry(cuda, dtype):
    """The dense topology's backward: each level's gradient of all four
    views of every sampled ROI (2 images x 64 ROIs), K3 on c5 and c4
    (image-relative rows), K4 on c3 (absolute rows), as the card routes
    them. Against the plain versions, and bit-equal over two calls."""
    pyrs, _, views, img = _dense_case(cuda, torch.float32, r=64, c=128,
                                      seed=54)
    gen = torch.Generator(device=cuda).manual_seed(55)
    gout = torch.randn((views.shape[0], 7, 7, 128), generator=gen,
                       device=cuda)
    for level, (flat, meta) in zip(("c3", "c4", "c5"), pyrs):
        row0, x0, wy, wx = roi_pool.view_geometry(meta, views)
        rows, wmax = meta.flat.shape[:2]
        if level == "c3":
            absolute = (row0 + img * rows).contiguous()
            args = (gout, absolute, x0, wy, wx, tuple(flat.shape))
            runs = [roi_pool.window_rmw_grad(*args, dtype) for _ in range(2)]
            want = roi_pool.window_rmw_grad_ref(*args, torch.float32)
        else:
            args = (gout, row0, x0, wy, wx, 2, rows, wmax)
            runs = [roi_pool.window_grad(*args, dtype) for _ in range(2)]
            want = roi_pool.window_grad_ref(*args)
        torch.cuda.synchronize()
        assert torch.equal(*runs), level
        _assert_grad_close(runs[0], want)


def test_trainable_k1_at_one_level_with_backward(cuda):
    """Config 1's training pool: K1 at L = 1 through WindowPoolMulti, one
    image's 64 1x views over c5 at 640^2, and its backward through K3
    (the level fits _GRAD_VMEM_BUDGET), against autograd through the
    plain forward; the forward against the plain version."""
    (flat, meta), = _levels(cuda, torch.float32, 1, 640, 512, 1, seed=56)
    flat = flat.detach().requires_grad_()
    rois = torch.from_numpy(_rois(np.random.default_rng(56), 64, 640)).to(
        cuda)
    img = torch.zeros(64, dtype=torch.int32, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(57)
    gout = torch.randn((64, 7, 7, 512), generator=gen, device=cuda)
    before = profiling.counters()
    out = roi_pool.batched_pyramid_pool_multi([flat], [meta], rois, img,
                                              trainable=True)
    (got,) = torch.autograd.grad((out * gout).sum(), [flat])
    torch.cuda.synchronize()
    launched = profiling.kernel_launches(before)
    assert (launched["window_pool_multi"], launched["window_grad"],
            launched["window_rmw_grad"]) == (1, 1, 0)
    row0, x0, wy, wx = roi_pool.view_geometry(meta, rois)
    plain = roi_pool.window_pool_multi_ref([flat], [row0], [x0], [wy], [wx])
    torch.testing.assert_close(out.detach(), plain.detach(),
                               **_tol(torch.float32))
    (want,) = torch.autograd.grad((plain * gout).sum(), [flat])
    _assert_grad_close(got, want)


# ----------------------------------------------- G = 1..7 bins a side ---

BINS = [1, 2, 3, 4, 5, 6, 7]


def _bins_case(dev, dtype, g, c, seed, b=2, canvas=256, n=240):
    """c3/c4/c5 pyramids built for G bins (output_size=g) on a 256^2
    canvas, whose coarsest c5 scale has fewer than 10 rows (4 at G = 6),
    and image-major views at every scale, a third of them over the
    border: -> (pyramids, views, each view's image). Some views must land
    on c5's coarsest scale, where a window of G + 3 rows would do but
    the kernels read 10."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    pyrs = []
    for s in (4, 8, 16):
        f = torch.randn((b, canvas // s, canvas // s, c), generator=gen,
                        device=dev).to(dtype)
        pyrs.append(roi_pyramid.build_pyramid_batch(f, 1.0 / s,
                                                    output_size=g))
    rng = np.random.default_rng(seed)
    views = torch.from_numpy(_rois(rng, n, canvas)).to(dev)
    views[: n // 8] = torch.tensor([0.0, 0.0, canvas, canvas], device=dev)
    img = torch.arange(b, dtype=torch.int32,
                       device=dev).repeat_interleave(n // b)
    meta = pyrs[-1][1]
    row0 = roi_pool.view_geometry(meta, views, output_size=g)[0]
    last = int(meta.row_offsets[-1])
    assert int(meta.heights[-1]) < 10 <= meta.flat.shape[0] - last
    assert int((row0 >= last).sum()) > 0
    return pyrs, views, img


def _bins_args(pyrs, views, img, g):
    """K1's arguments over every level of `pyrs` at G bins."""
    args = [[], [], [], [], []]
    for flat, meta in pyrs:
        row0, x0, wy, wx = roi_pool.view_geometry(meta, views,
                                                  output_size=g)
        row0 = (row0 + img * meta.flat.shape[0]).contiguous()
        for dst, v in zip(args, (flat, row0, x0, wy, wx)):
            dst.append(v)
    return args


def _bins_k2_args(pyrs, views, b, g):
    """K2's arguments over the last level of `pyrs` at G bins."""
    flat, meta = pyrs[-1]
    row0, x0, wy, wx = roi_pool.view_geometry(meta, views, output_size=g)
    rows, wmax, c = meta.flat.shape
    v = views.shape[0] // b
    return [flat.reshape(b, rows, wmax, c), row0.reshape(b, v),
            x0.reshape(b, v), wy.reshape(b, v, g, 10),
            wx.reshape(b, v, g, 16)]


@pytest.mark.parametrize("c", [512, 72])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("g", BINS)
def test_pool_kernels_take_every_bin_count(cuda, g, dtype, c):
    """K1 (c3 + c4 + c5), K2 (c5) and K5 (c3) at G bins a side, 1..7,
    against their plain versions at the existing tolerances: (N, G, G, C)
    in the pyramid dtype, border views on c5's coarsest scale included."""
    b = 2
    pyrs, views, img = _bins_case(cuda, dtype, g, c, seed=60 + g)
    k1 = _bins_args(pyrs, views, img, g)
    k2 = _bins_k2_args(pyrs, views, b, g)
    k5 = [t[0] for t in k1]
    n = views.shape[0]
    for kern, ref, args, shape in (
            (roi_pool.window_pool_multi, roi_pool.window_pool_multi_ref,
             k1, (n, g, g, c)),
            (roi_pool.resident_pool, roi_pool.resident_pool_ref, k2,
             (b, n // b, g, g, c)),
            (roi_pool.window_pool, roi_pool.window_pool_ref, k5,
             (n, g, g, c))):
        before = profiling.counters()
        got = kern(*args)
        torch.cuda.synchronize()
        assert profiling.kernel_launches(before)[kern.__name__] == 1
        want = ref(*args)
        assert got.dtype == want.dtype == dtype and got.shape == shape
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), want.float(), **_tol(dtype))


@pytest.mark.parametrize("c", [512, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("g", BINS)
def test_quant_epilogue_takes_every_bin_count(cuda, g, dtype, c):
    """The int8 instances of K1 and K2 at G bins: each view's scale over
    its G^2 x C values, bit for bit against quant_view_ref of the same
    kernel's pooled output; codes within 1 and scales to the pooled
    tolerance against the fully plain version. C = 1024: the pool, then
    the epilogue kernel."""
    b = 2
    pyrs, views, img = _bins_case(cuda, dtype, g, c, seed=70 + g)
    gen = torch.Generator(device=cuda).manual_seed(70 + g)
    bias = (torch.randn(c, generator=gen, device=cuda) * 0.5).to(dtype)
    rtol = 1e-5 if dtype == torch.float32 else 1e-2
    for kern, ref, args in (
            (roi_pool.window_pool_multi, roi_pool.window_pool_multi_ref,
             _bins_args(pyrs, views, img, g)),
            (roi_pool.resident_pool, roi_pool.resident_pool_ref,
             _bins_k2_args(pyrs, views, b, g))):
        before = profiling.counters()
        q, s = kern(*args, quant_bias=bias)
        pooled = kern(*args)
        torch.cuda.synchronize()
        assert profiling.kernel_launches(before)[kern.__name__ + "_quant"] == 1
        n = s.numel()
        assert q.shape == pooled.shape and q.shape[-3:] == (g, g, c)
        own_q, own_s = roi_pool.quant_view_ref(pooled.reshape(n, g, g, c),
                                               bias)
        assert torch.equal(q.reshape(n, g, g, c), own_q)
        assert torch.equal(s.reshape(n), own_s)
        plain_q, plain_s = ref(*args, quant_bias=bias)
        assert (q.int() - plain_q.int()).abs().max() <= 1
        torch.testing.assert_close(s, plain_s, rtol=rtol, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("g", BINS)
def test_grad_kernels_take_every_bin_count(cuda, g, dtype):
    """K3 (c5, image-relative rows) and K4 (c3, absolute rows) at G bins
    a side against their plain versions, each output bit-equal over two
    calls (the fixed order holds at every G)."""
    b, c = 2, 200
    pyrs, views, img = _bins_case(cuda, torch.float32, g, c, seed=80 + g)
    gen = torch.Generator(device=cuda).manual_seed(80 + g)
    gout = torch.randn((views.shape[0], g, g, c), generator=gen,
                       device=cuda)
    (c3, c3_meta), (c5, c5_meta) = pyrs[0], pyrs[-1]
    row0, x0, wy, wx = roi_pool.view_geometry(c5_meta, views, output_size=g)
    rows, wmax = c5_meta.flat.shape[:2]
    args = (gout, row0, x0, wy, wx, b, rows, wmax)
    k3 = [roi_pool.window_grad(*args, dtype) for _ in range(2)]
    want3 = roi_pool.window_grad_ref(*args)
    row0, x0, wy, wx = roi_pool.view_geometry(c3_meta, views, output_size=g)
    absolute = (row0 + img * c3_meta.flat.shape[0]).contiguous()
    args = (gout, absolute, x0, wy, wx, tuple(c3.shape))
    k4 = [roi_pool.window_rmw_grad(*args, dtype) for _ in range(2)]
    want4 = roi_pool.window_rmw_grad_ref(*args, torch.float32)
    torch.cuda.synchronize()
    for runs, want in ((k3, want3), (k4, want4)):
        assert torch.equal(*runs)
        assert runs[0].dtype == dtype
        _assert_grad_close(runs[0], want)


def test_kernels_refuse_bins_outside_1_to_7(cuda):
    """G = 0 or 8, a weight row of another window's width, or a buffer
    shorter than the 10-row window raises before any launch; nothing
    falls back to the plain version."""
    pyrs, views, img = _bins_case(cuda, torch.bfloat16, 6, 64, seed=90)
    k1 = _bins_args(pyrs, views, img, 6)
    flat, row0, x0, wy, wx = (t[0] for t in k1)
    n = row0.numel()
    before = profiling.counters()
    for g in (0, 8):
        bad_wy = torch.zeros((n, g, 10), device=cuda)
        bad_wx = torch.zeros((n, g, 16), device=cuda)
        with pytest.raises(ValueError, match="bins a side"):
            roi_pool.window_pool_multi([flat], [row0], [x0], [bad_wy],
                                       [bad_wx])
        with pytest.raises(ValueError, match="bins a side"):
            roi_pool.window_grad(torch.zeros((n, g, g, 64), device=cuda),
                                 row0 % 10, x0, bad_wy, bad_wx, 1,
                                 flat.shape[0], flat.shape[1])
        with pytest.raises(ValueError, match="bins a side"):
            roi_pool.view_geometry(pyrs[0][1], views, output_size=g)
    with pytest.raises(ValueError, match="wys"):
        roi_pool.window_pool_multi([flat], [row0], [x0], [wy[..., :9]
                                                          .contiguous()],
                                   [wx])
    with pytest.raises(ValueError, match="cannot hold"):
        roi_pool.window_pool_multi([flat[:9]], [row0], [x0], [wy], [wx])
    with pytest.raises(ValueError, match="cannot hold"):
        roi_pool.resident_pool(flat[:9][None], row0[None] * 0, x0[None],
                               wy[None], wx[None])
    assert not any(profiling.kernel_launches(before).values())
