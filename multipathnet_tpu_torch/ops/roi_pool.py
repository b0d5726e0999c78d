"""ROI window pooling — the port of multipathnet_tpu/ops/roi_pallas.py's
forward kernels and the backward of the level-summed one.

Per (image, ROI, foveal) view, `view_geometry` picks the pyramid scale where
the view's G bins span (0.5, 1] cell, the origin (row0, x0) of the
WINDOW x WINDOW_X (10 x 16) window that holds all of its bilinear samples,
and the bilinear weight rows wy (G, 10) and wx (G, 16) with the S samples
per bin averaged in (bilinear interpolation is linear, so the sample axis
folds into the weights). The pool is then
    out[i, j, c] = sum_l sum_{y,x} wy_l[i, y] * wx_l[j, x] * win_l[y, x, c].

Two kernels compute it (csrc/roi_window_pool.cu):
  window_pool_multi (K1) — L levels summed, absolute rows; the 1x view
      over c3 + c4 + c5.
  resident_pool (K2) — one level, image-relative rows into a batch of
      per-image pyramids; the context views over c5.
Training differentiates K1 (`WindowPoolMulti`). Its backward is the
transpose of the pool per view, gwin = wy^T g wx (10 x 16 x C), summed into
the pyramid gradient at the window, by one of two kernels
(csrc/roi_window_grad.cu) or the per-image placement GEMMs:
  window_grad (K3) — image-relative rows, a float32 gradient.
  window_rmw_grad (K4) — absolute rows, a gradient in the buffer's dtype.
Each wrapper runs its plain PyTorch version (`*_ref`: gather or scatter
the windows, two einsums in float32) for tensors on the CPU, launches its
kernel for tensors on a CUDA device, and raises for anything else.
`launches` on each wrapper counts its kernel launches.
"""

from __future__ import annotations

import torch

from multipathnet_tpu_torch.ops.roi_pyramid import WINDOW, WINDOW_X, Pyramid

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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
    """One level: flat (rows, Wmax, C), row0/x0 (N,) -> (N, G, G, C) f32."""
    ys = row0.long()[:, None] + torch.arange(WINDOW, device=flat.device)
    xs = x0.long()[:, None] + torch.arange(WINDOW_X, device=flat.device)
    win = flat[ys[:, :, None], xs[:, None, :]].float()  # (N, 10, 16, C)
    t = torch.einsum("niy,nyxc->nixc", wy.float(), win)
    return torch.einsum("nixc,njx->nijc", t, wx.float())


def window_pool_multi_ref(flats, row0s, x0s, wys, wxs) -> torch.Tensor:
    """Plain version of K1: the windows gathered, two einsums in float32,
    summed over levels, one cast to the pyramid dtype."""
    out = sum(_pool_level_ref(*a) for a in zip(flats, row0s, x0s, wys, wxs))
    return out.to(flats[0].dtype)


def resident_pool_ref(flat, row0, x0, wy, wx) -> torch.Tensor:
    """Plain version of K2: flat (B, rows, Wmax, C), row0/x0 (B, V)
    image-relative, wy (B, V, G, 10), wx (B, V, G, 16) -> (B, V, G, G, C)."""
    b, rows, wmax, c = flat.shape
    v, g = wy.shape[1:3]
    img_rows = torch.arange(b, device=flat.device)[:, None] * rows
    out = _pool_level_ref(flat.reshape(b * rows, wmax, c),
                          (row0.long() + img_rows).reshape(-1),
                          x0.reshape(-1), wy.reshape(b * v, g, WINDOW),
                          wx.reshape(b * v, g, WINDOW_X))
    return out.to(flat.dtype).reshape(b, v, g, g, c)


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


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def window_pool_multi(flats, row0s, x0s, wys, wxs) -> torch.Tensor:
    """K1: level-summed window pooling.

    flats: L (rows_l, Wmax_l, C) stacked pyramids (same C and dtype, L <= 3);
    row0s/x0s: L (N,) int32 absolute window origins; wys/wxs: L (N, G, 10) /
    (N, G, 16) float32 weight rows. Returns (N, G, G, C) in the pyramid
    dtype. Replaces roi_pallas.pallas_window_pool_multi (no int8 epilogue).
    """
    flat0 = flats[0]
    if flat0.device.type == "cpu":
        return window_pool_multi_ref(flats, row0s, x0s, wys, wxs)
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
    out = torch.empty((n, g, g, c), dtype=flat0.dtype, device=dev)
    if n == 0:
        return out
    from multipathnet_tpu_torch.ops import _build

    pad = [None] * (3 - nl)
    ptrs = [f.data_ptr() for f in flats] + pad
    rows = [f.shape[0] for f in flats] + [0] * (3 - nl)
    wmax = [f.shape[1] for f in flats] + [0] * (3 - nl)
    rc = _build.kernels().mpn_window_pool_multi(
        _KERNEL_DTYPES[flat0.dtype], nl, n, c, *ptrs, *rows, *wmax,
        row0.data_ptr(), x0.data_ptr(), wy.data_ptr(), wx.data_ptr(),
        out.data_ptr(), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"window_pool_multi launch failed: "
                           f"cudaError {rc}")
    window_pool_multi.launches += 1
    return out


window_pool_multi.launches = 0


def resident_pool(flat, row0, x0, wy, wx) -> torch.Tensor:
    """K2: one-level window pooling over a batch of per-image pyramids.

    flat (B, rows, Wmax, C); row0/x0 (B, V) int32 image-relative origins;
    wy (B, V, G, 10), wx (B, V, G, 16) float32 -> (B, V, G, G, C) in the
    pyramid dtype. Replaces roi_pallas.pallas_resident_pool (no int8
    epilogue).
    """
    if flat.device.type == "cpu":
        return resident_pool_ref(flat, row0, x0, wy, wx)
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
    out = torch.empty((b, v, g, g, c), dtype=flat.dtype, device=dev)
    if b * v == 0:
        return out
    from multipathnet_tpu_torch.ops import _build

    rc = _build.kernels().mpn_resident_pool(
        _KERNEL_DTYPES[flat.dtype], b, v, rows, wmax, c, flat.data_ptr(),
        row0.data_ptr(), x0.data_ptr(), wy.data_ptr(), wx.data_ptr(),
        out.data_ptr(), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"resident_pool launch failed: cudaError {rc}")
    resident_pool.launches += 1
    return out


resident_pool.launches = 0


# ------------------------------------------------------------- backward ---

# The backward's routing, carried over from roi_pallas._mwpt_bwd with the
# reference's values: they encode the TPU's VMEM size and its matrix unit's
# placement cost, not a tuning for this card. K3 takes a level whose f32
# per-image gradient fits _GRAD_VMEM_BUDGET bytes; K4 a level with more than
# _PLACE_PER_IMAGE_MAX_CELLS cells per image; the per-image placement GEMMs
# the rest. At multipath_vgg16_train that is c5 -> K3, c4 -> placement,
# c3 -> K4.
_GRAD_VMEM_BUDGET = 7 * 1024 * 1024
_PLACE_PER_IMAGE_MAX_CELLS = 24 * 1024


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


def _check_grad_args(gout, row0, x0, wy, wx, dev):
    n, g = wy.shape[:2]
    if g != 7:
        raise ValueError(f"the kernel is written for G=7 bins, got {g}")
    c = gout.shape[-1]
    if c % 2:
        raise ValueError(f"the kernel needs an even channel count, got {c}")
    _check("gout", gout, (n, g, g, c), torch.float32, dev)
    _check("row0", row0, (n,), torch.int32, dev)
    _check("x0", x0, (n,), torch.int32, dev)
    _check("wy", wy, (n, g, WINDOW), torch.float32, dev)
    _check("wx", wx, (n, g, WINDOW_X), torch.float32, dev)
    return n, c


def window_grad(gout, row0_rel, x0, wy, wx, batch: int, rows: int,
                wmax: int) -> torch.Tensor:
    """K3: the pyramid gradient of one level, image-relative rows.

    gout (N, G, G, C) float32 cotangent, views image-major (N = batch * V);
    row0_rel/x0 (N,) int32 image-relative window origins; wy/wx the
    forward's weight rows. Returns the (batch * rows, wmax, C) float32
    gradient. Replaces roi_pallas.pallas_window_grad.
    """
    if gout.device.type == "cpu":
        _check_windows(row0_rel, x0, rows, wmax)
        return window_grad_ref(gout, row0_rel, x0, wy, wx, batch, rows, wmax)
    if gout.device.type != "cuda":
        raise ValueError(f"gout must be a CPU or CUDA tensor, got "
                         f"{gout.device}")
    dev = gout.device
    n, c = _check_grad_args(gout, row0_rel, x0, wy, wx, dev)
    _check_windows(row0_rel, x0, rows, wmax)
    if n % batch:
        raise ValueError(f"{n} views do not split over {batch} images")
    out = torch.zeros((batch * rows, wmax, c), dtype=torch.float32,
                      device=dev)
    if n == 0:
        return out
    from multipathnet_tpu_torch.ops import _build

    rc = _build.kernels().mpn_window_grad(
        n, n // batch, rows, wmax, c, gout.data_ptr(), row0_rel.data_ptr(),
        x0.data_ptr(), wy.data_ptr(), wx.data_ptr(), out.data_ptr(),
        _stream(dev))
    if rc != 0:
        raise RuntimeError(f"window_grad launch failed: cudaError {rc}")
    window_grad.launches += 1
    return out


window_grad.launches = 0


def window_rmw_grad(gout, row0, x0, wy, wx, shape, dtype) -> torch.Tensor:
    """K4: the pyramid gradient of one level, absolute rows.

    gout (N, G, G, C) float32; row0/x0 (N,) int32 absolute window origins
    into the stacked (shape[0], shape[1], C) buffer. Returns that buffer in
    `dtype`. The TPU kernel accumulates in the buffer's dtype one view at a
    time; this one accumulates in float32 and rounds once at the end.
    Replaces roi_pallas.pallas_window_rmw_grad.
    """
    rows, wmax, c = shape
    if gout.device.type == "cpu":
        _check_windows(row0, x0, rows, wmax)
        return window_rmw_grad_ref(gout, row0, x0, wy, wx, shape, dtype)
    if gout.device.type != "cuda":
        raise ValueError(f"gout must be a CPU or CUDA tensor, got "
                         f"{gout.device}")
    dev = gout.device
    n, gc = _check_grad_args(gout, row0, x0, wy, wx, dev)
    if gc != c:
        raise ValueError(f"gout has {gc} channels, the buffer {c}")
    _check_windows(row0, x0, rows, wmax)
    acc = torch.zeros((rows, wmax, c), dtype=torch.float32, device=dev)
    if n:
        from multipathnet_tpu_torch.ops import _build

        rc = _build.kernels().mpn_window_rmw_grad(
            n, rows, wmax, c, gout.data_ptr(), row0.data_ptr(),
            x0.data_ptr(), wy.data_ptr(), wx.data_ptr(), acc.data_ptr(),
            _stream(dev))
        if rc != 0:
            raise RuntimeError(f"window_rmw_grad launch failed: cudaError "
                               f"{rc}")
        window_rmw_grad.launches += 1
    return acc.to(dtype)


window_rmw_grad.launches = 0


def place_windows_per_image(row0_rel, x0, gwin, batch, rows, width, dtype
                            ) -> torch.Tensor:
    """Port of roi_pallas._place_windows_per_image: each image's window
    gradients summed into its own (rows, width, C) block by two one-hot
    GEMMs. gwin (N, 10, 16, C), N = batch * V image-major; row0_rel/x0 (N,)
    image-relative. The column spread is rounded to `dtype` (the compute
    dtype), the rows contraction accumulates in float32, one cast to
    `dtype`. Returns (batch * rows, width, C)."""
    n, ht, wd, c = gwin.shape
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


def _level_grad(g, row0, x0, wy, wx, shape, dtype, rows, batch):
    """One level's pyramid gradient, routed as roi_pallas._mwpt_bwd."""
    wmax, c = shape[1], shape[2]
    n = g.shape[0]
    if rows * wmax * c * 4 <= _GRAD_VMEM_BUDGET:
        row0_rel = (row0 - _image_rows(n, batch, rows, g.device)).contiguous()
        return window_grad(g, row0_rel, x0, wy, wx, batch, rows,
                           wmax).to(dtype)
    if rows * wmax > _PLACE_PER_IMAGE_MAX_CELLS:
        return window_rmw_grad(g, row0, x0, wy, wx, shape, dtype)
    row0_rel = row0 - _image_rows(n, batch, rows, g.device)
    return place_windows_per_image(row0_rel, x0, window_cotangent(g, wy, wx),
                                   batch, rows, wmax, dtype)


class WindowPoolMulti(torch.autograd.Function):
    """Differentiable K1 — the counterpart of
    roi_pallas.multi_window_pool_trainable with rows_list and batch.

    apply((row0s, x0s, wys, wxs), rows_list, batch, *flats): the geometry
    lists as window_pool_multi takes them (row0 absolute), each level's rows
    per image, the image count, then the L stacked pyramids. Gradients go to
    the pyramids only: the geometry derives from ROI coordinates, which are
    data. Like the reference's zero stubs, the backward keeps no pyramid,
    only its shape and dtype.
    """

    @staticmethod
    def forward(ctx, geometry, rows_list, batch, *flats):
        ctx.geometry = geometry
        ctx.rows_list = tuple(rows_list)
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
                               trainable: bool = False) -> torch.Tensor:
    """Level-summed pooling over batched pyramids through K1.

    flat_batches: L (B * rows_l, Wmax_l, C) stacked pyramids; pyr_metas: L
    single-image metas; rois_views (N, 4) shared by all levels; img_idx (N,)
    each view's image. Returns (N, G, G, C). `trainable` runs it through
    WindowPoolMulti, so gradients reach the pyramids (views image-major).
    """
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
    return window_pool_multi(list(flat_batches), row0s, x0s, wys, wxs)


def batched_pyramid_pool_resident(flat_batch, pyr_meta: Pyramid, rois_views,
                                  batch: int, *, output_size: int = 7,
                                  samples_per_bin: int = 2) -> torch.Tensor:
    """One-level pooling through K2. flat_batch (B * rows, Wmax, C);
    rois_views (N, 4), N = B * V, grouped by image. Returns (N, G, G, C)."""
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
    out = resident_pool(flat_batch.reshape(batch, rows, wmax, c),
                        row0.reshape(batch, v), x0.reshape(batch, v),
                        wy.reshape(batch, v, g, WINDOW),
                        wx.reshape(batch, v, g, WINDOW_X))
    return out.reshape(n, g, g, c)
