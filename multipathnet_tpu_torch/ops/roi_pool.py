"""ROI window pooling — the port of multipathnet_tpu/ops/roi_pallas.py's
forward kernels and the backward of the level-summed one.

Per (image, ROI, foveal) view, `view_geometry` picks the pyramid scale where
the view's G bins span (0.5, 1] cell, the origin (row0, x0) of the
WINDOW x WINDOW_X (10 x 16) window that holds all of its bilinear samples,
and the bilinear weight rows wy (G, 10) and wx (G, 16) with the S samples
per bin averaged in (bilinear interpolation is linear, so the sample axis
folds into the weights). The pool is then
    out[i, j, c] = sum_l sum_{y,x} wy_l[i, y] * wx_l[j, x] * win_l[y, x, c].

As the reference's kernels compute it, the weights are combined first:
W2 = wy (x) wx, the float32 product rounded once to the pyramid dtype, then
one float32 contraction over the 160 window cells (in float32 the rounding
is a no-op). Three wrappers launch the same two kernel bodies
(csrc/roi_window_pool.cu): bfloat16 pyramids the tensor-core body
(wgmma on TMA-staged windows, csrc/roi_window_pool_wgmma.cu; C divisible
by 8), float32 ones the CUDA-core body:
  window_pool_multi (K1) — L levels summed, absolute rows; the 1x view
      over c3 + c4 + c5.
  resident_pool (K2) — one level, image-relative rows into a batch of
      per-image pyramids; the context views over c5.
  window_pool (K5) — one level, absolute rows (batched_pyramid_pool).
Given the head's skip bias (`quant_bias`, eval only), K1 or K2 runs the
int8 serving head's input stage in its epilogue (roi_pallas._quant_view):
bias, ReLU and one int8 scale per view, returning int8 codes and float32
scales instead of the pooled tensor (`quant_view_ref` is its plain
version). Up to 512 channels the pool kernel runs it itself; wider views
are pooled first and quantized by the epilogue kernel (`quant_view`), the
same arithmetic in a second launch. Each wrapper counts its calls that
launch per mode: `launches` without the epilogue, `quant_launches` with
it.
The differentiable forms are WindowPoolMulti (K1), WindowPool (K5) and
ResidentPool (K2). Their backward is the transpose of the pool per view,
gwin = wy^T g wx (10 x 16 x C), summed into the pyramid gradient at the
window, by one of two kernels (csrc/roi_window_grad.cu, one fixed-order
body without atomics: each output cell is summed by one thread over the
views in index order and written once) or, on the CPU only, the per-image
placement GEMMs:
  window_grad (K3) — image-relative rows, a float32 gradient or one in
      the pyramid dtype.
  window_rmw_grad (K4) — absolute rows, a gradient in the buffer's dtype;
      also the one route of `accumulate_windows`, the single-level
      backward.
Each wrapper runs its plain PyTorch version (`*_ref`: gather or scatter
the windows, contract them in float32) for tensors on the CPU, launches its
kernel for tensors on a CUDA device, and raises for anything else.
`launches` on each wrapper counts its kernel launches.
"""

from __future__ import annotations

import torch

from multipathnet_tpu_torch.ops import quant
from multipathnet_tpu_torch.ops.roi_pyramid import WINDOW, WINDOW_X, Pyramid

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the pool kernels' own int8 epilogue gives one block a whole view: the bf16
# body's 512-channel tile, the float32 body's 256 threads x 2 channels;
# wider views take the epilogue kernel in a second launch
_QUANT_MAX_CHANNELS = 512


def view_geometry(pyr: Pyramid, rois: torch.Tensor, *, output_size: int = 7,
                  samples_per_bin: int = 2):
    """Scale selection + window origins + folded bilinear weights.

    rois (N, 4) image coords -> row0 (N,) int32 row in the stacked pyramid,
    x0 (N,) int32 (8-aligned), wy (N, G, WINDOW) f32, wx (N, G, WINDOW_X)
    f32. Same arithmetic, in float32, as roi_pallas.view_geometry.
    """
    g, s = output_size, samples_per_bin
    if g + 3 > WINDOW:
        raise ValueError(f"output_size={g} exceeds the pool kernels' "
                         f"{WINDOW}-row window (G <= {WINDOW - 3})")
    f32 = torch.float32
    dev = rois.device
    b = rois.to(f32) * pyr.base_scale
    x1, y1 = b[:, 0], b[:, 1]
    bw = torch.clamp(b[:, 2] - x1, min=1e-6)
    bh = torch.clamp(b[:, 3] - y1, min=1e-6)
    span = torch.maximum(bw, bh) / g
    lvl = torch.clamp(
        torch.ceil(torch.log2(torch.clamp(span, min=1.0))).to(torch.int64),
        0, pyr.num_scales - 1)
    cell = torch.exp2(lvl.to(f32))
    heights = pyr.heights.to(dev)[lvl]
    widths = pyr.widths.to(dev)[lvl]
    hl = heights.to(f32)
    wl = widths.to(f32)

    k = torch.arange(g * s, device=dev)
    off = (k // s).to(f32) + ((k % s).to(f32) + 0.5) / s
    sy = torch.minimum(torch.clamp(
        (y1[:, None] + off * bh[:, None] / g) / cell[:, None], min=0.0),
        (hl - 1.0)[:, None])
    sx = torch.minimum(torch.clamp(
        (x1[:, None] + off * bw[:, None] / g) / cell[:, None], min=0.0),
        (wl - 1.0)[:, None])

    y0 = torch.minimum(torch.clamp(torch.floor(sy[:, 0]).to(torch.int32),
                                   min=0),
                       torch.clamp(heights - WINDOW, min=0))
    wmax = pyr.flat.shape[1]
    x0 = torch.minimum(torch.clamp(torch.floor(sx[:, 0]).to(torch.int32),
                                   min=0),
                       torch.clamp(widths - (WINDOW_X - 7), min=0))
    x0 = torch.clamp((x0 // 8) * 8, max=wmax - WINDOW_X)

    cells_y = torch.arange(WINDOW, dtype=f32, device=dev)
    cells_x = torch.arange(WINDOW_X, dtype=f32, device=dev)
    ly = torch.clamp(sy - y0[:, None].to(f32), 0.0, WINDOW - 1.0)
    lx = torch.clamp(sx - x0[:, None].to(f32), 0.0, WINDOW_X - 1.0)
    wy = torch.clamp(1.0 - torch.abs(ly[:, :, None] - cells_y), min=0.0)
    wx = torch.clamp(1.0 - torch.abs(lx[:, :, None] - cells_x), min=0.0)
    n = rois.shape[0]
    wy = wy.reshape(n, g, s, WINDOW).mean(dim=2)
    wx = wx.reshape(n, g, s, WINDOW_X).mean(dim=2)

    row0 = (pyr.row_offsets.to(dev)[lvl] + y0).to(torch.int32)
    return row0, x0, wy, wx


def _pool_level_ref(flat, row0, x0, wy, wx) -> torch.Tensor:
    """One level: flat (rows, Wmax, C), row0/x0 (N,) -> (N, G, G, C) f32.

    The W2 form of the reference's pool kernels (roi_pallas.py:156, :534,
    :975): W2[n, i, j, y, x] = wy[n, i, y] * wx[n, j, x], the float32
    product rounded once to the pyramid dtype (a no-op in float32), then
    one float32 contraction over the 160 window cells."""
    g, c = wy.shape[1], flat.shape[-1]
    ys = row0.long()[:, None] + torch.arange(WINDOW, device=flat.device)
    xs = x0.long()[:, None] + torch.arange(WINDOW_X, device=flat.device)
    win = flat[ys[:, :, None], xs[:, None, :]].float()  # (N, 10, 16, C)
    w2 = (wy.float()[:, :, None, :, None] * wx.float()[:, None, :, None, :]
          ).to(flat.dtype).float()                      # (N, G, G, 10, 16)
    n = w2.shape[0]
    out = torch.bmm(w2.reshape(n, g * g, WINDOW * WINDOW_X),
                    win.reshape(n, WINDOW * WINDOW_X, c))
    return out.reshape(n, g, g, c)


def quant_view_ref(pooled, bias):
    """Plain version of the pool kernels' int8 epilogue, the port of
    roi_pallas._quant_view step for step: pooled (N, G, G, C) in the pool
    dtype -> the head dtype (bias's) -> + bias (one float32 add, one
    rounding to the head dtype) -> ReLU -> float32 -> one scale per view,
    amax * float32(1/127) floored at 1e-12 -> round half to even, clip to
    +-127. That is the head's relu + ops.quant.quantize_rows on each
    view's (G * G * C) row. Returns (int8 (N, G, G, C), float32 (N,))."""
    y = torch.relu(pooled.to(bias.dtype) + bias)
    q, s = quant.quantize_rows(y.reshape(y.shape[0], -1))
    return q.reshape(pooled.shape), s.reshape(-1)


def window_pool_multi_ref(flats, row0s, x0s, wys, wxs, quant_bias=None):
    """Plain version of K1: the windows gathered, each level's W2
    contraction in float32 (_pool_level_ref), summed over levels, one cast
    to the pyramid dtype; with `quant_bias`, then quant_view_ref."""
    out = sum(_pool_level_ref(*a) for a in zip(flats, row0s, x0s, wys, wxs))
    out = out.to(flats[0].dtype)
    return out if quant_bias is None else quant_view_ref(out, quant_bias)


def window_pool_ref(flat, row0, x0, wy, wx) -> torch.Tensor:
    """Plain version of K5: one level at absolute rows, the windows
    gathered, the W2 contraction in float32 (_pool_level_ref), one cast to
    the flat's dtype."""
    return _pool_level_ref(flat, row0, x0, wy, wx).to(flat.dtype)


def resident_pool_ref(flat, row0, x0, wy, wx, quant_bias=None):
    """Plain version of K2: flat (B, rows, Wmax, C), row0/x0 (B, V)
    image-relative, wy (B, V, G, 10), wx (B, V, G, 16) -> (B, V, G, G, C);
    with `quant_bias`, quant_view_ref of it: (int8 (B, V, G, G, C),
    float32 (B, V))."""
    b, rows, wmax, c = flat.shape
    v, g = wy.shape[1:3]
    img_rows = torch.arange(b, device=flat.device)[:, None] * rows
    out = _pool_level_ref(flat.reshape(b * rows, wmax, c),
                          (row0.long() + img_rows).reshape(-1),
                          x0.reshape(-1), wy.reshape(b * v, g, WINDOW),
                          wx.reshape(b * v, g, WINDOW_X)).to(flat.dtype)
    if quant_bias is None:
        return out.reshape(b, v, g, g, c)
    q, s = quant_view_ref(out, quant_bias)
    return q.reshape(b, v, g, g, c), s.reshape(b, v)


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _check_pyramid(name, flat, device):
    if flat.device != device or flat.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor on {device}, "
                         f"got {flat.device}")
    if flat.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{name}: the kernel takes float32 or bfloat16, "
                        f"got {flat.dtype}")
    if not flat.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    if flat.shape[-1] % 2:
        raise ValueError(f"{name}: the kernel needs an even channel count, "
                         f"got {flat.shape[-1]}")
    # the bf16 body reads windows by TMA, whose strides are 16-byte units
    if flat.dtype == torch.bfloat16 and (flat.shape[-1] % 8
                                         or flat.data_ptr() % 16):
        raise ValueError(f"{name}: the bf16 kernel needs a channel count "
                         f"divisible by 8 and a 16-byte aligned buffer, got "
                         f"{flat.shape[-1]} channels at {flat.data_ptr():#x}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _ptr(t):
    return None if t is None else t.data_ptr()


def _pool_outputs(flat, shape, device, quant_bias):
    """The pool's output of `shape`, in the pyramid dtype -> (out, None);
    with the int8 epilogue, after checking its skip bias -> (int8 out,
    float32 scales of shape[:-3])."""
    if quant_bias is None:
        return torch.empty(shape, dtype=flat.dtype, device=device), None
    _check("quant_bias", quant_bias, (flat.shape[-1],), flat.dtype, device)
    return (torch.empty(shape, dtype=torch.int8, device=device),
            torch.empty(shape[:-3], dtype=torch.float32, device=device))


def _launch_pool(name, launch, flat, out, scales, quant_bias) -> None:
    """Runs a pool kernel through launch(bias, out, scale) (pointers or
    None) into `out` (and `scales`). With the int8 epilogue over more than
    _QUANT_MAX_CHANNELS channels: the pool into a pyramid-dtype scratch,
    then the epilogue kernel (mpn_quant_view) from it."""
    from multipathnet_tpu_torch.ops import _build

    if quant_bias is None or flat.shape[-1] <= _QUANT_MAX_CHANNELS:
        rc = launch(_ptr(quant_bias), out.data_ptr(), _ptr(scales))
        if rc != 0:
            raise RuntimeError(f"{name} launch failed: cudaError {rc}")
        return
    pooled = torch.empty(out.shape, dtype=flat.dtype, device=out.device)
    rc = launch(None, pooled.data_ptr(), None)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    rc = _build.kernels().mpn_quant_view(
        _KERNEL_DTYPES[flat.dtype], scales.numel(), flat.shape[-1],
        pooled.data_ptr(), quant_bias.data_ptr(), out.data_ptr(),
        scales.data_ptr(), _stream(out.device))
    if rc != 0:
        raise RuntimeError(f"quant_view launch failed: cudaError {rc}")


def window_pool_multi(flats, row0s, x0s, wys, wxs, quant_bias=None):
    """K1: level-summed window pooling.

    flats: L (rows_l, Wmax_l, C) stacked pyramids (same C and dtype, L <= 3);
    row0s/x0s: L (N,) int32 absolute window origins; wys/wxs: L (N, G, 10) /
    (N, G, 16) float32 weight rows. Returns (N, G, G, C) in the pyramid
    dtype. With `quant_bias`, the (C,) skip bias in the pyramid dtype (the
    head's), it runs the int8 epilogue and returns (int8
    (N, G, G, C), float32 (N,) scales). Replaces
    roi_pallas.pallas_window_pool_multi.
    """
    if flats[0].device.type == "cpu":
        return window_pool_multi_ref(flats, row0s, x0s, wys, wxs, quant_bias)
    out, scales, launched = _pool_levels(flats, row0s, x0s, wys, wxs,
                                         quant_bias)
    if quant_bias is None:
        window_pool_multi.launches += launched
        return out
    window_pool_multi.quant_launches += launched
    return out, scales


window_pool_multi.launches = 0
window_pool_multi.quant_launches = 0


def window_pool(flat, row0, x0, wy, wx):
    """K5: one-level window pooling at absolute rows.

    flat (rows, Wmax, C) stacked pyramid(s); row0/x0 (N,) int32 absolute
    window origins; wy (N, G, 10), wx (N, G, 16) float32 -> (N, G, G, C) in
    the flat's dtype. It launches K1's kernel body at one level and counts
    its own launches. Replaces roi_pallas.pallas_window_pool, which pads N
    to its tile; here N = 0 returns an empty output.
    """
    if flat.device.type == "cpu":
        return window_pool_ref(flat, row0, x0, wy, wx)
    out, _, launched = _pool_levels([flat], [row0], [x0], [wy], [wx], None)
    window_pool.launches += launched
    return out


window_pool.launches = 0


def _pool_levels(flats, row0s, x0s, wys, wxs, quant_bias):
    """Checks the arguments of window_pool_kernel over L absolute-row levels
    (csrc/roi_window_pool.cu) and launches it unless N = 0. Returns (out,
    scales or None, launches made: 0 or 1)."""
    flat0 = flats[0]
    nl = len(flats)
    if not 1 <= nl <= 3 or not (len(row0s) == len(x0s) == len(wys)
                                == len(wxs) == nl):
        raise ValueError(f"window_pool_multi takes 1 to 3 levels, got {nl}")
    dev = flat0.device
    n, g = wys[0].shape[:2]
    c = flat0.shape[-1]
    for lv, flat in enumerate(flats):
        _check_pyramid(f"flats[{lv}]", flat, dev)
        if flat.dim() != 3:
            raise ValueError(f"flats[{lv}] must be (rows, Wmax, C), got "
                             f"{tuple(flat.shape)}")
        if flat.dtype != flat0.dtype or flat.shape[-1] != c:
            raise ValueError("all levels must share dtype and channels")
    if g != 7:
        raise ValueError(f"the kernel is written for G=7 bins, got {g}")
    row0 = torch.stack(list(row0s))
    x0 = torch.stack(list(x0s))
    wy = torch.stack(list(wys))
    wx = torch.stack(list(wxs))
    _check("row0s", row0, (nl, n), torch.int32, dev)
    _check("x0s", x0, (nl, n), torch.int32, dev)
    _check("wys", wy, (nl, n, g, WINDOW), torch.float32, dev)
    _check("wxs", wx, (nl, n, g, WINDOW_X), torch.float32, dev)
    out, scales = _pool_outputs(flat0, (n, g, g, c), dev, quant_bias)
    if n == 0:
        return out, scales, 0
    from multipathnet_tpu_torch.ops import _build

    pad = [None] * (3 - nl)
    ptrs = [f.data_ptr() for f in flats] + pad
    rows = [f.shape[0] for f in flats] + [0] * (3 - nl)
    wmax = [f.shape[1] for f in flats] + [0] * (3 - nl)
    _launch_pool("window_pool_kernel", lambda bias, dst, scale: (
        _build.kernels().mpn_window_pool_multi(
            _KERNEL_DTYPES[flat0.dtype], nl, n, c, *ptrs, *rows, *wmax,
            row0.data_ptr(), x0.data_ptr(), wy.data_ptr(), wx.data_ptr(),
            bias, dst, scale, _stream(dev))), flat0, out, scales, quant_bias)
    return out, scales, 1


def resident_pool(flat, row0, x0, wy, wx, quant_bias=None):
    """K2: one-level window pooling over a batch of per-image pyramids.

    flat (B, rows, Wmax, C); row0/x0 (B, V) int32 image-relative origins;
    wy (B, V, G, 10), wx (B, V, G, 16) float32 -> (B, V, G, G, C) in the
    pyramid dtype. With `quant_bias` (as window_pool_multi's) it returns
    (int8 (B, V, G, G, C), float32 (B, V) scales). Replaces
    roi_pallas.pallas_resident_pool.
    """
    if flat.device.type == "cpu":
        return resident_pool_ref(flat, row0, x0, wy, wx, quant_bias)
    dev = flat.device
    _check_pyramid("flat", flat, dev)
    if flat.dim() != 4:
        raise ValueError(f"flat must be (B, rows, Wmax, C), got "
                         f"{tuple(flat.shape)}")
    b, rows, wmax, c = flat.shape
    v, g = wy.shape[1:3]
    if g != 7:
        raise ValueError(f"the kernel is written for G=7 bins, got {g}")
    _check("row0", row0, (b, v), torch.int32, dev)
    _check("x0", x0, (b, v), torch.int32, dev)
    _check("wy", wy, (b, v, g, WINDOW), torch.float32, dev)
    _check("wx", wx, (b, v, g, WINDOW_X), torch.float32, dev)
    out, scales = _pool_outputs(flat, (b, v, g, g, c), dev, quant_bias)
    if b * v == 0:
        return out if quant_bias is None else (out, scales)
    from multipathnet_tpu_torch.ops import _build

    _launch_pool("resident_pool", lambda bias, dst, scale: (
        _build.kernels().mpn_resident_pool(
            _KERNEL_DTYPES[flat.dtype], b, v, rows, wmax, c,
            flat.data_ptr(), row0.data_ptr(), x0.data_ptr(), wy.data_ptr(),
            wx.data_ptr(), bias, dst, scale, _stream(dev))), flat, out,
        scales, quant_bias)
    if quant_bias is None:
        resident_pool.launches += 1
        return out
    resident_pool.quant_launches += 1
    return out, scales


resident_pool.launches = 0
resident_pool.quant_launches = 0


# ------------------------------------------------------------- backward ---

# The backward's routing, carried over from roi_pallas._mwpt_bwd with the
# reference's values: they encode the TPU's VMEM size and its matrix unit's
# placement cost, not a tuning for this card. K3 takes a level whose f32
# per-image gradient fits _GRAD_VMEM_BUDGET bytes; K4 a level with more than
# _PLACE_PER_IMAGE_MAX_CELLS cells per image; the per-image placement GEMMs
# the rest, on the CPU. On the card that rest goes to K3 (_level_grad). At
# multipath_vgg16_train that is c5 -> K3, c4 -> placement (CPU) or K3
# (card), c3 -> K4.
_GRAD_VMEM_BUDGET = 7 * 1024 * 1024
_PLACE_PER_IMAGE_MAX_CELLS = 24 * 1024
_GRAD_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def window_cotangent(gout, wy, wx) -> torch.Tensor:
    """gout (N, G, G, C), wy (N, G, 10), wx (N, G, 16) -> the window
    gradients gwin = wy^T gout wx, (N, 10, 16, C) float32."""
    m = torch.einsum("niy,nijc->nyjc", wy.float(), gout.float())
    return torch.einsum("nyjc,njx->nyxc", m, wx.float())


def _scatter_windows(gwin, row0, x0, shape) -> torch.Tensor:
    """index_put_(accumulate=True) of N (10, 16, C) windows at absolute
    (row0, x0) into float32 zeros of `shape`."""
    n = gwin.shape[0]
    ys = row0.long()[:, None] + torch.arange(WINDOW, device=gwin.device)
    xs = x0.long()[:, None] + torch.arange(WINDOW_X, device=gwin.device)
    out = gwin.new_zeros(shape)
    out.index_put_((ys[:, :, None].expand(n, WINDOW, WINDOW_X),
                    xs[:, None, :].expand(n, WINDOW, WINDOW_X)), gwin,
                   accumulate=True)
    return out


def _image_rows(n, batch, rows, device) -> torch.Tensor:
    """(N,) first row of each view's image in the stacked buffer, views
    image-major."""
    if n % batch:
        raise ValueError(f"{n} views do not split over {batch} images")
    return (torch.arange(batch, dtype=torch.int32, device=device)
            * rows).repeat_interleave(n // batch)


def _check_windows(row0, x0, rows, wmax) -> None:
    """Every window must lie inside its buffer: view_geometry clamps, and
    the backward has no counterpart of the forward's NaN rule."""
    if row0.numel() == 0:
        return
    r_lo, r_hi, x_lo, x_hi = torch.stack(
        [row0.min(), row0.max(), x0.min(), x0.max()]).tolist()
    if r_lo < 0 or r_hi + WINDOW > rows or x_lo < 0 or x_hi + WINDOW_X > wmax:
        raise ValueError(
            f"a window falls outside its ({rows}, {wmax}) buffer: rows "
            f"{r_lo}..{r_hi}+{WINDOW}, columns {x_lo}..{x_hi}+{WINDOW_X}")


def window_grad_ref(gout, row0_rel, x0, wy, wx, batch, rows, wmax
                    ) -> torch.Tensor:
    """Plain version of K3: window gradients in float32, scattered with
    index_put_(accumulate=True) into float32 zeros of (batch * rows, wmax,
    C)."""
    n, c = gout.shape[0], gout.shape[-1]
    row0 = row0_rel.long() + _image_rows(n, batch, rows, gout.device)
    return _scatter_windows(window_cotangent(gout, wy, wx), row0, x0,
                            (batch * rows, wmax, c))


def window_rmw_grad_ref(gout, row0, x0, wy, wx, shape, dtype
                        ) -> torch.Tensor:
    """Plain version of K4: the same scatter at absolute rows into float32
    zeros of `shape`, one cast to `dtype`."""
    return _scatter_windows(window_cotangent(gout, wy, wx), row0, x0,
                            tuple(shape)).to(dtype)


def _check_grad_args(gout, row0, x0, wy, wx, dtype, dev):
    if gout.device.type != "cuda":
        raise ValueError(f"gout must be a CPU or CUDA tensor, got "
                         f"{gout.device}")
    if dtype not in _GRAD_OUT_DTYPES:
        raise TypeError(f"the kernel writes float32 or bfloat16, got {dtype}")
    n, g = wy.shape[:2]
    if g != 7:
        raise ValueError(f"the kernel is written for G=7 bins, got {g}")
    c = gout.shape[-1]
    _check("gout", gout, (n, g, g, c), torch.float32, dev)
    _check("row0", row0, (n,), torch.int32, dev)
    _check("x0", x0, (n,), torch.int32, dev)
    _check("wy", wy, (n, g, WINDOW), torch.float32, dev)
    _check("wx", wx, (n, g, WINDOW_X), torch.float32, dev)
    return n, c


def _grad_kernels():
    from multipathnet_tpu_torch.ops import _build

    return _build.kernels()


def _grad_scratch(batch, rows, wmax, n_views, dev) -> torch.Tensor:
    """The scratch of a K3/K4 launch, which the launch fills itself: one
    view count per output tile and each view's weight rows, transposed."""
    n = _grad_kernels().mpn_grad_scratch_words(batch, rows, wmax, n_views)
    return torch.empty(n, dtype=torch.int32, device=dev)


def window_grad(gout, row0_rel, x0, wy, wx, batch: int, rows: int,
                wmax: int, dtype=torch.float32) -> torch.Tensor:
    """K3: the pyramid gradient of one level, image-relative rows.

    gout (N, G, G, C) float32 cotangent, views image-major (N = batch * V,
    V = 0 allowed); row0_rel/x0 (N,) int32 image-relative window origins;
    wy/wx the forward's weight rows. Returns the (batch * rows, wmax, C)
    gradient in `dtype`: float32, as roi_pallas.pallas_window_grad returns
    it, or the pyramid dtype that its caller casts to (float32 or bfloat16
    on the card), the float32 sum rounded once. Replaces
    roi_pallas.pallas_window_grad.
    """
    if gout.device.type == "cpu":
        _check_windows(row0_rel, x0, rows, wmax)
        return window_grad_ref(gout, row0_rel, x0, wy, wx, batch, rows,
                               wmax).to(dtype)
    dev = gout.device
    n, c = _check_grad_args(gout, row0_rel, x0, wy, wx, dtype, dev)
    _check_windows(row0_rel, x0, rows, wmax)
    if n % batch:
        raise ValueError(f"{n} views do not split over {batch} images")
    out = torch.empty((batch * rows, wmax, c), dtype=dtype, device=dev)
    scratch = _grad_scratch(batch, rows, wmax, n, dev)
    rc = _grad_kernels().mpn_window_grad(
        _GRAD_OUT_DTYPES[dtype], batch, n // batch, rows, wmax, c,
        gout.data_ptr(), row0_rel.data_ptr(), x0.data_ptr(), wy.data_ptr(),
        wx.data_ptr(), out.data_ptr(), scratch.data_ptr(), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"window_grad launch failed: cudaError {rc}")
    window_grad.launches += 1
    return out


window_grad.launches = 0


def window_rmw_grad(gout, row0, x0, wy, wx, shape, dtype) -> torch.Tensor:
    """K4: the pyramid gradient of one level, absolute rows.

    gout (N, G, G, C) float32; row0/x0 (N,) int32 absolute window origins
    into the stacked (shape[0], shape[1], C) buffer. Returns that buffer in
    `dtype` (float32 or bfloat16 on the card), written once. The TPU kernel
    accumulates in the buffer's dtype one view at a time; this one sums in
    float32 and rounds once. Replaces roi_pallas.pallas_window_rmw_grad.
    """
    rows, wmax, c = shape
    if gout.device.type == "cpu":
        _check_windows(row0, x0, rows, wmax)
        return window_rmw_grad_ref(gout, row0, x0, wy, wx, shape, dtype)
    dev = gout.device
    n, gc = _check_grad_args(gout, row0, x0, wy, wx, dtype, dev)
    if gc != c:
        raise ValueError(f"gout has {gc} channels, the buffer {c}")
    _check_windows(row0, x0, rows, wmax)
    out = torch.empty((rows, wmax, c), dtype=dtype, device=dev)
    scratch = _grad_scratch(1, rows, wmax, n, dev)
    rc = _grad_kernels().mpn_window_rmw_grad(
        _GRAD_OUT_DTYPES[dtype], n, rows, wmax, c, gout.data_ptr(),
        row0.data_ptr(), x0.data_ptr(), wy.data_ptr(), wx.data_ptr(),
        out.data_ptr(), scratch.data_ptr(), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"window_rmw_grad launch failed: cudaError {rc}")
    window_rmw_grad.launches += 1
    return out


window_rmw_grad.launches = 0


def accumulate_windows(row0, x0, gout, wy, wx, shape, dtype) -> torch.Tensor:
    """The single-level pools' shared backward, the port of
    roi_pallas._accumulate_windows: the window gradients wy^T gout wx
    (window_cotangent) of N views summed into zeros of `shape` (rows, Wmax,
    C) at absolute (row0, x0), returned in `dtype`. The origins are first
    clamped into the buffer, as the reference clamps them, so a window never
    hangs past its edge.

    It takes the pool's cotangent gout (N, G, G, C) and the weight rows
    rather than the window gradients, because every width goes to K4
    (window_rmw_grad), which forms them itself: the kernel on the card, its
    plain version (window_cotangent, then the scatter) on the CPU. The
    reference's two routes are not ported: the one-hot placement GEMMs over
    the whole buffer for Wmax <= _PLACE_MM_MAX_W exist because a TPU's
    scatter is HBM-bound while its matrix unit idles, and the scatter_add
    is XLA's. Numerics: K4 sums in float32 and rounds once to `dtype`; the
    reference's scatter sums a bf16 buffer in bf16, its placement in
    float32.
    """
    rows, wmax = shape[0], shape[1]
    row0 = torch.clamp(row0.to(torch.int32), 0, rows - WINDOW).contiguous()
    x0 = torch.clamp(x0.to(torch.int32), 0, wmax - WINDOW_X).contiguous()
    return window_rmw_grad(gout.float().contiguous(), row0, x0, wy, wx,
                           tuple(shape), dtype)


class WindowPool(torch.autograd.Function):
    """Differentiable K5 — the counterpart of
    roi_pallas.window_pool_trainable: apply(flat, row0, x0, wy, wx), the
    arguments of window_pool. Gradients go to `flat` only: the geometry
    derives from ROI coordinates, which are data. The backward keeps no
    pyramid, only its shape and dtype."""

    @staticmethod
    def forward(ctx, flat, row0, x0, wy, wx):
        ctx.save_for_backward(row0, x0, wy, wx)
        ctx.flat_meta = (tuple(flat.shape), flat.dtype)
        return window_pool(flat, row0, x0, wy, wx)

    @staticmethod
    def backward(ctx, gout):
        row0, x0, wy, wx = ctx.saved_tensors
        shape, dtype = ctx.flat_meta
        return (accumulate_windows(row0, x0, gout, wy, wx, shape, dtype),
                None, None, None, None)


def window_pool_trainable(flat, row0, x0, wy, wx) -> torch.Tensor:
    """window_pool with a gradient to `flat` (WindowPool)."""
    return WindowPool.apply(flat, row0, x0, wy, wx)


class ResidentPool(torch.autograd.Function):
    """Differentiable K2 — the counterpart of
    roi_pallas.resident_pool_trainable: apply(flat, row0, x0, wy, wx), the
    arguments of resident_pool. The backward follows _rpt_bwd: the views
    flattened to (B * V), their rows made absolute in the (B * rows, Wmax,
    C) view of `flat`, accumulate_windows there. Gradients go to `flat`
    only; no pyramid is kept."""

    @staticmethod
    def forward(ctx, flat, row0, x0, wy, wx):
        ctx.save_for_backward(row0, x0, wy, wx)
        ctx.flat_meta = (tuple(flat.shape), flat.dtype)
        return resident_pool(flat, row0, x0, wy, wx)

    @staticmethod
    def backward(ctx, gout):
        row0, x0, wy, wx = ctx.saved_tensors
        (b, rows, wmax, c), dtype = ctx.flat_meta
        v, g = wy.shape[1:3]
        img_rows = torch.arange(b, dtype=torch.int32,
                                device=row0.device)[:, None] * rows
        grad = accumulate_windows(
            (row0 + img_rows).reshape(b * v), x0.reshape(b * v),
            gout.reshape(b * v, g, g, c), wy.reshape(b * v, g, WINDOW),
            wx.reshape(b * v, g, WINDOW_X), (b * rows, wmax, c), dtype)
        return grad.reshape(b, rows, wmax, c), None, None, None, None


def resident_pool_trainable(flat, row0, x0, wy, wx) -> torch.Tensor:
    """resident_pool with a gradient to `flat` (ResidentPool)."""
    return ResidentPool.apply(flat, row0, x0, wy, wx)


def place_windows_per_image(row0_rel, x0, gwin, batch, rows, width, dtype
                            ) -> torch.Tensor:
    """Port of roi_pallas._place_windows_per_image: each image's window
    gradients summed into its own (rows, width, C) block by two one-hot
    GEMMs. gwin (N, 10, 16, C), N = batch * V image-major; row0_rel/x0 (N,)
    image-relative. The column spread is rounded to `dtype` (the compute
    dtype), the rows contraction accumulates in float32, one cast to
    `dtype`. Returns (batch * rows, width, C). `calls` counts its calls
    on the card, as the launch counters count launches: the card's
    backward makes none (_level_grad)."""
    n, ht, wd, c = gwin.shape
    if gwin.device.type == "cuda":
        place_windows_per_image.calls += 1
    v = n // batch
    dev = gwin.device
    row0_rel = torch.clamp(row0_rel.long(), 0, rows - ht)
    x0 = torch.clamp(x0.long(), 0, width - wd)
    xs = x0[:, None] + torch.arange(wd, device=dev)
    cols = (xs[:, :, None] == torch.arange(width, device=dev)).float()
    gx = torch.einsum("njx,nrjc->nrxc", cols,
                      gwin.to(dtype).float()).to(dtype)
    ridx = (row0_rel[:, None] + torch.arange(ht, device=dev)).reshape(
        batch, v * ht)
    oh = (ridx[:, :, None] == torch.arange(rows, device=dev)).float()
    out = torch.einsum("bkr,bkwc->brwc", oh,
                       gx.reshape(batch, v * ht, width, c).float())
    return out.to(dtype).reshape(batch * rows, width, c)


place_windows_per_image.calls = 0


def _level_grad(g, row0, x0, wy, wx, shape, dtype, rows, batch):
    """One level's pyramid gradient; without the level's rows per image or
    the image count, accumulate_windows.

    On the CPU it is routed as roi_pallas._mwpt_bwd routes it: K3 within
    _GRAD_VMEM_BUDGET, K4 above _PLACE_PER_IMAGE_MAX_CELLS cells per image,
    the per-image placement GEMMs between. On the card the level that the
    reference sends to K4 stays on K4, and every other level goes to K3:
    the placement GEMMs exist because a TPU's scatter is HBM-bound while
    its matrix unit idles (as accumulate_windows says), and on the card
    K3 writes each cell of the same gradient once, exactly and in a fixed
    order, without a one-hot GEMM over the whole buffer."""
    if not (rows and batch):
        return accumulate_windows(row0, x0, g, wy, wx, shape, dtype)
    wmax, c = shape[1], shape[2]
    n = g.shape[0]
    to_k3 = rows * wmax * c * 4 <= _GRAD_VMEM_BUDGET
    if not to_k3 and rows * wmax > _PLACE_PER_IMAGE_MAX_CELLS:
        return window_rmw_grad(g, row0, x0, wy, wx, shape, dtype)
    row0_rel = (row0 - _image_rows(n, batch, rows, g.device)).contiguous()
    if to_k3 or g.device.type == "cuda":
        return window_grad(g, row0_rel, x0, wy, wx, batch, rows, wmax, dtype)
    return place_windows_per_image(row0_rel, x0, window_cotangent(g, wy, wx),
                                   batch, rows, wmax, dtype)


class WindowPoolMulti(torch.autograd.Function):
    """Differentiable K1 — the counterpart of
    roi_pallas.multi_window_pool_trainable.

    apply((row0s, x0s, wys, wxs), rows_list, batch, *flats): the geometry
    lists as window_pool_multi takes them (row0 absolute), each level's rows
    per image, the image count, then the L stacked pyramids. With rows_list
    and batch the backward routes each level as _level_grad does (K3, K4,
    and on the CPU the per-image placement); with None for either, every
    level goes through accumulate_windows (the reference's last branch).
    Gradients go to the pyramids only: the geometry derives from ROI
    coordinates, which are data. Like the reference's zero stubs, the
    backward keeps no pyramid, only its shape and dtype.
    """

    @staticmethod
    def forward(ctx, geometry, rows_list, batch, *flats):
        ctx.geometry = geometry
        ctx.rows_list = (tuple(rows_list) if rows_list is not None
                         else (None,) * len(flats))
        ctx.batch = batch
        ctx.flat_meta = [(tuple(f.shape), f.dtype) for f in flats]
        return window_pool_multi(list(flats), *geometry)

    @staticmethod
    def backward(ctx, gout):
        g = gout.float().contiguous()
        grads = [
            _level_grad(g, row0, x0, wy, wx, shape, dtype, rows, ctx.batch)
            for row0, x0, wy, wx, (shape, dtype), rows in zip(
                *ctx.geometry, ctx.flat_meta, ctx.rows_list)]
        return (None, None, None, *grads)


def batched_pyramid_pool_multi(flat_batches, pyr_metas, rois_views,
                               img_idx, *, output_size: int = 7,
                               samples_per_bin: int = 2,
                               trainable: bool = False, quant_bias=None):
    """Level-summed pooling over batched pyramids through K1.

    flat_batches: L (B * rows_l, Wmax_l, C) stacked pyramids; pyr_metas: L
    single-image metas; rois_views (N, 4) shared by all levels; img_idx (N,)
    each view's image. Returns (N, G, G, C), or with `quant_bias` (int8
    (N, G, G, C), float32 (N,) scales). `trainable` runs it through
    WindowPoolMulti, so gradients reach the pyramids (views image-major).
    """
    if trainable and quant_bias is not None:
        raise ValueError("quantized emission is eval-only")
    row0s, x0s, wys, wxs = [], [], [], []
    for meta in pyr_metas:
        row0, x0, wy, wx = view_geometry(meta, rois_views,
                                         output_size=output_size,
                                         samples_per_bin=samples_per_bin)
        rows = meta.flat.shape[0]
        row0s.append((row0 + img_idx.to(torch.int32) * rows).contiguous())
        x0s.append(x0)
        wys.append(wy)
        wxs.append(wx)
    if trainable:
        rows_list = tuple(meta.flat.shape[0] for meta in pyr_metas)
        batch = flat_batches[0].shape[0] // rows_list[0]
        return WindowPoolMulti.apply((row0s, x0s, wys, wxs), rows_list,
                                     batch, *flat_batches)
    return window_pool_multi(list(flat_batches), row0s, x0s, wys, wxs,
                             quant_bias)


def batched_pyramid_pool(flat_batch, pyr_meta: Pyramid, rois_views, img_idx,
                         *, output_size: int = 7, samples_per_bin: int = 2,
                         trainable: bool = False) -> torch.Tensor:
    """One-level pooling through K5 (roi_pallas.batched_pyramid_pool).

    flat_batch (B * rows, Wmax, C): B per-image pyramids stacked on rows;
    pyr_meta: one image's Pyramid; rois_views (N, 4); img_idx (N,) each
    view's image. Returns (N, G, G, C). `trainable` runs it through
    WindowPool, so the gradient reaches flat_batch."""
    row0, x0, wy, wx = view_geometry(pyr_meta, rois_views,
                                     output_size=output_size,
                                     samples_per_bin=samples_per_bin)
    rows = pyr_meta.flat.shape[0]
    row0 = (row0 + img_idx.to(torch.int32) * rows).contiguous()
    pool = window_pool_trainable if trainable else window_pool
    return pool(flat_batch, row0, x0, wy, wx)


def batched_pyramid_pool_resident(flat_batch, pyr_meta: Pyramid, rois_views,
                                  batch: int, *, output_size: int = 7,
                                  samples_per_bin: int = 2,
                                  trainable: bool = False, quant_bias=None):
    """One-level pooling through K2. flat_batch (B * rows, Wmax, C);
    rois_views (N, 4), N = B * V, grouped by image. Returns (N, G, G, C),
    or with `quant_bias` (int8 (N, G, G, C), float32 (N,) scales).
    `trainable` runs it through ResidentPool, so the gradient reaches
    flat_batch."""
    if trainable and quant_bias is not None:
        raise ValueError("quantized emission is eval-only")
    rows = pyr_meta.flat.shape[0]
    wmax, c = flat_batch.shape[1:]
    n = rois_views.shape[0]
    if n % batch:
        raise ValueError(f"{n} views do not split over {batch} images")
    v = n // batch
    row0, x0, wy, wx = view_geometry(pyr_meta, rois_views,
                                     output_size=output_size,
                                     samples_per_bin=samples_per_bin)
    g = wy.shape[1]
    args = (flat_batch.reshape(batch, rows, wmax, c), row0.reshape(batch, v),
            x0.reshape(batch, v), wy.reshape(batch, v, g, WINDOW),
            wx.reshape(batch, v, g, WINDOW_X))
    if trainable:
        return resident_pool_trainable(*args).reshape(n, g, g, c)
    out = resident_pool(*args, quant_bias)
    if quant_bias is None:
        return out.reshape(n, g, g, c)
    q, s = out
    return q.reshape(n, g, g, c), s.reshape(n)
