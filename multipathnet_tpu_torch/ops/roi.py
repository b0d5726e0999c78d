"""ROI pooling in plain ops — port of multipathnet_tpu/ops/roi.py: the
bilinear gather route (`roi_align`, `batched_roi_align`), the
reference-exact max route (`roi_pool_max`, the reference's inn.ROIPooling
semantics) and the fused MultiPath feature op over both,
`multilevel_foveal_roi_features`. The reference computes all of them in
XLA, outside any Pallas kernel. The detector's align views take the
gather route under roi_impl="direct" (models/multipath.py) and the window
kernels (ops/roi_pool.py) otherwise; SharpMask's training pools take it
too (models/sharpmask.py, impl="direct").

roi_align samples G*S x G*S bilinear points per ROI (offsets (i + (k +
0.5) / S) bins from the ROI's corner, clamped to the map) and takes the
mean or max of each bin's S x S samples. Each sample reads its four
neighbours through gather_rows, whose backward is a fixed-order scatter
(ops/scatter.py): the gradient repeats bit for bit from call to call, on
the CPU at any thread count and on the card (an autograd gather's
backward is an accumulating index_put_, which sums in no fixed order).
ROIs go in chunks so that a chunk's (B, n, G*S, G*S, C) samples stay
within `max_elements`; the four neighbour gathers and their weighted sum
are a few more tensors of that size. In training autograd keeps only the
gather indices and the weights, not the samples.

The max route:

Each ROI is split into G x G bins with floor/ceil integer extents, clamped
to the map; each bin takes the max of the cells it covers, an empty bin
gives 0, and so does a non-finite result. The reference evaluates this as
one masked max over an (R, Gy, H, Gx, W, C) broadcast, which XLA fuses;
eager PyTorch would allocate it. Here the same values come from two stages
(rows into bins, then columns into bins), each over only the rows or
columns a bin can cover: a bin's rows are gathered (ys + 0..ny-1, ny the
longest bin of the map), the ones past the bin masked to -inf, and the
max taken. Max is exact, so the result equals the reference's bit for bit;
ROIs are taken in chunks so the gathered rows stay within `max_elements`.

The gradient is the reference's too: its one masked max sends each bin's
cotangent to every cell of the bin that equals the bin's max, split evenly
among them (XLA's rule for a tied max). Two stages of torch.amax would split
a tie per stage instead, which matters where a map is flat (an image's
padding reads as one value over many cells), so `roi_pool_max` has its own
backward: per chunk, the bins' cells gathered again, the ties counted over
each whole bin, and cotangent / count added into the map's gradient in a
fixed order (ops/scatter.py), so the gradient repeats at any thread count.

The bin edges keep the reference's arithmetic as XLA compiles it: the bin
index is an arange in the feature dtype, promoted to float32 against the
ROI's extent, the division by G is a multiplication by float32(1 / G)
(XLA's simplifier rewrites a division by a constant so), and the start
plus that product is one fused multiply-add, rounded once (as XLA's CPU
code contracts it). Where (k + 1) * extent / G is an integer the rounding
decides the ceil, so a true division, or a separate multiply and add,
moves about 1% of the bin edges by one cell.
"""

from __future__ import annotations

import torch

import numpy as np

from multipathnet_tpu_torch.ops import boxes as box_ops
from multipathnet_tpu_torch.ops.scatter import gather_rows, scatter_rows

MAX_ELEMENTS = 1 << 27  # gathered elements per chunk of ROIs


def inv(g: int) -> float:
    """float32(1 / g), divided in float32 as XLA inverts a constant."""
    return float(np.float32(1.0) / np.float32(g))


def fma32(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """a * b + c for float32 a, c and a float32-valued b, rounded once to
    float32: the product is exact in float64 and so is the sum for the
    coordinates here (bin indices times extents in cells), so one rounding
    of the float64 result is the fused multiply-add."""
    return (a.double() * b + c.double()).float()


def _bilinear_gather(feat: torch.Tensor, sy: torch.Tensor,
                     sx: torch.Tensor) -> torch.Tensor:
    """feat (B, H, W, C); sy (B, R, Py), sx (B, R, Px) continuous feature
    coordinates -> (B, R, Py, Px, C) bilinear samples, coordinates clamped
    into the map (torchvision roi_align's border rule). Float32 weights,
    so a bf16 map gives float32 samples, as in the reference."""
    b, h, w, c = feat.shape
    sy = torch.clamp(sy, 0.0, h - 1.0)
    sx = torch.clamp(sx, 0.0, w - 1.0)
    y0f, x0f = torch.floor(sy), torch.floor(sx)
    wy1, wx1 = sy - y0f, sx - x0f
    y0, x0 = y0f.long(), x0f.long()
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    flat = feat.reshape(b * h * w, c)
    base = (torch.arange(b, device=feat.device) * (h * w))[:, None, None,
                                                           None]

    def take(yi, xi):  # -> (B, R, Py, Px, C)
        return gather_rows(flat, base + yi[..., :, None] * w
                           + xi[..., None, :])

    wy1 = wy1[..., :, None, None]
    wx1 = wx1[..., None, :, None]
    return (take(y0, x0) * (1 - wy1) * (1 - wx1)
            + take(y0, x1) * (1 - wy1) * wx1
            + take(y1, x0) * wy1 * (1 - wx1)
            + take(y1, x1) * wy1 * wx1)


def batched_roi_align(feats: torch.Tensor, rois: torch.Tensor, *,
                      output_size: int = 7,
                      spatial_scale: float = 1.0 / 16.0,
                      samples_per_bin: int = 2,
                      mode: str = "avg",
                      max_elements: int = MAX_ELEMENTS) -> torch.Tensor:
    """ROI Align over images: feats (B, H, W, C), rois (B, R, 4) image
    coords -> (B, R, G, G, C), float32 (the reference's vmapped
    roi_align). mode: "avg" or "max" over each bin's S x S samples."""
    if mode not in ("avg", "max"):
        raise ValueError(f"mode must be avg|max, got {mode!r}")
    g, s = output_size, samples_per_bin
    dev = rois.device
    b = rois.float() * spatial_scale
    x1, y1, x2, y2 = b.unbind(-1)
    rg = inv(g)  # as XLA compiles the reference: / G -> * float32(1 / G)
    bin_h = torch.clamp(y2 - y1, min=1e-6) * rg
    bin_w = torch.clamp(x2 - x1, min=1e-6) * rg
    k = torch.arange(g * s, device=dev)
    off = (k // s).float() + ((k % s).float() + 0.5) / s       # (G*S,)
    # the corner plus offset x bin, one fused multiply-add (B, R, G*S)
    sy = (off.double() * bin_h[..., None].double()
          + y1[..., None].double()).float()
    sx = (off.double() * bin_w[..., None].double()
          + x1[..., None].double()).float()
    nb, r, c = rois.shape[0], rois.shape[1], feats.shape[-1]
    per = max(1, max_elements // max(1, nb * (g * s) ** 2 * c))
    if r <= per:
        return _bin_reduce(_bilinear_gather(feats, sy, sx), g, s, mode)
    return torch.cat([_bin_reduce(_bilinear_gather(
        feats, sy[:, i:i + per], sx[:, i:i + per]), g, s, mode)
        for i in range(0, r, per)], dim=1)


def _bin_reduce(vals: torch.Tensor, g: int, s: int, mode: str):
    """(B, n, G*S, G*S, C) samples -> (B, n, G, G, C): the mean or max
    of each bin's S x S samples."""
    if s == 1:  # one sample per bin: the mean or max of one value
        return vals
    nb, r, c = vals.shape[0], vals.shape[1], vals.shape[-1]
    vals = vals.reshape(nb, r, g, s, g, s, c)
    if mode == "avg":
        return vals.mean(dim=(3, 5))
    return vals.amax(dim=(3, 5))


def roi_align(feat: torch.Tensor, rois: torch.Tensor, **kw) -> torch.Tensor:
    """ROI Align on one map: feat (H, W, C), rois (R, 4) -> (R, G, G, C);
    keywords as batched_roi_align."""
    return batched_roi_align(feat[None], rois[None], **kw)[0]


def bin_edges(rois: torch.Tensor, spatial_scale: float, output_size: int,
              h: int, w: int, dtype) -> tuple:
    """rois (R, 4) image coords -> (ys, ye, xs, xe), each (R, G) float32:
    each bin's half-open row and column range on an (h, w) map, the
    reference's floor/ceil rule clamped to the map."""
    g = output_size
    b = rois * spatial_scale
    x1, y1 = torch.floor(b[:, 0]), torch.floor(b[:, 1])
    x2, y2 = torch.ceil(b[:, 2]), torch.ceil(b[:, 3])
    roi_h = torch.clamp(y2 - y1, min=1.0)
    roi_w = torch.clamp(x2 - x1, min=1.0)
    bins = torch.arange(g, device=rois.device).to(dtype)
    rg = inv(g)
    y1, x1 = y1[:, None], x1[:, None]
    ys = torch.clamp(torch.floor(fma32(bins * roi_h[:, None], rg, y1)), 0, h)
    ye = torch.clamp(torch.ceil(fma32((bins + 1) * roi_h[:, None], rg, y1)),
                     0, h)
    xs = torch.clamp(torch.floor(fma32(bins * roi_w[:, None], rg, x1)), 0, w)
    xe = torch.clamp(torch.ceil(fma32((bins + 1) * roi_w[:, None], rg, x1)),
                     0, w)
    return ys, ye, xs, xe


class _Bins:
    """The gather plan of one map's bins: each bin's first row and column
    (R, G), its lengths, and the longest bin's lengths ny, nx."""

    def __init__(self, ys, ye, xs, xe, h, w):
        self.ys, self.xs = ys, xs
        self.ly = torch.clamp(ye - ys, min=0)
        self.lx = torch.clamp(xe - xs, min=0)
        self.ny = max(int(self.ly.max()), 1)  # one host sync per map
        self.nx = max(int(self.lx.max()), 1)
        dev = ys.device
        self.oy = torch.arange(self.ny, device=dev)
        self.ox = torch.arange(self.nx, device=dev)
        self.h, self.w = h, w

    def rows(self, sl):
        """(row index (n, G, ny), in-bin mask (n, G, ny)) of a chunk."""
        iy = torch.clamp(self.ys[sl, :, None] + self.oy, max=self.h - 1)
        return iy, self.oy < self.ly[sl, :, None]

    def cols(self, sl):
        ix = torch.clamp(self.xs[sl, :, None] + self.ox, max=self.w - 1)
        return ix, self.ox < self.lx[sl, :, None]


def _binned_max(feat, bins: _Bins, per: int) -> torch.Tensor:
    """feat (H, W, C) -> (R, G, G, C) in feat's dtype, -inf where a bin is
    empty: rows into bins, then columns into bins."""
    r, g = bins.ys.shape
    dev = feat.device
    neg = torch.full((), float("-inf"), dtype=feat.dtype, device=dev)
    out = []
    for r0 in range(0, r, per):
        sl = slice(r0, r0 + per)
        iy, my = bins.rows(sl)
        n = iy.shape[0]
        rows = feat[iy]                                      # (n, G, ny, W, C)
        t = torch.where(my[..., None, None], rows, neg).amax(dim=2)
        ix, mx = bins.cols(sl)
        cols = t[torch.arange(n, device=dev)[:, None, None, None],
                 torch.arange(g, device=dev)[None, :, None, None],
                 ix[:, None]]                                # (n, G, G, nx, C)
        out.append(torch.where(mx[:, None, :, :, None], cols,
                               neg).amax(dim=3))             # (n, G, G, C)
    return torch.cat(out)


def _binned_max_grad(feat, out, gout, bins: _Bins, per: int):
    """The reference's gradient of the binned max: each bin's cotangent
    split evenly over the bin's cells equal to its max -> (H, W, C) in
    float32."""
    r, g = bins.ys.shape
    c = feat.shape[-1]
    grad = torch.zeros(feat.shape, dtype=torch.float32, device=feat.device)
    for r0 in range(0, r, per):
        sl = slice(r0, r0 + per)
        iy, my = bins.rows(sl)
        ix, mx = bins.cols(sl)
        # cells (n, Gy, ny, Gx, nx, C) of every bin of the chunk
        cell = (iy[:, :, :, None, None] * bins.w + ix[:, None, None, :, :])
        vals = feat.view(-1, feat.shape[-1])[cell]
        inside = my[:, :, :, None, None] & mx[:, None, None, :, :]
        tie = (vals == out[sl][:, :, None, :, None, :]) & inside[..., None]
        count = tie.sum(dim=(2, 4), keepdim=True)
        share = gout[sl].float()[:, :, None, :, None, :] / count
        grad += scatter_rows(cell, torch.where(tie, share, 0.0).reshape(
            -1, c), bins.h * bins.w).view(feat.shape)
    return grad


class _RoiPoolMax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat, bins, per):
        out = _binned_max(feat, bins, per)
        ctx.bins, ctx.per = bins, per
        ctx.save_for_backward(feat, out)
        return out

    @staticmethod
    def backward(ctx, gout):
        feat, out = ctx.saved_tensors
        grad = _binned_max_grad(feat, out, gout, ctx.bins, ctx.per)
        return grad.to(feat.dtype), None, None


def roi_pool_max(feat: torch.Tensor, rois: torch.Tensor, *,
                 output_size: int = 7, spatial_scale: float = 1.0 / 16.0,
                 max_elements: int = MAX_ELEMENTS) -> torch.Tensor:
    """Exact ROIPooling max: feat (H, W, C), rois (R, 4) image coords ->
    (R, G, G, C) in feat's dtype (empty bins and non-finite results 0)."""
    h, w, c = feat.shape
    g = output_size
    if rois.shape[0] == 0:
        return feat.new_zeros((0, g, g, c))
    edges = bin_edges(rois, spatial_scale, g, h, w, feat.dtype)
    bins = _Bins(*(e.long() for e in edges), h, w)
    cells = g * max(bins.ny * w, g * bins.nx, g * bins.ny * bins.nx)
    per = max(1, max_elements // (cells * c))
    out = _RoiPoolMax.apply(feat, bins, per)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def multilevel_foveal_roi_features(
        feats: dict, rois: torch.Tensor, *, scales: dict,
        foveal_factors=(1.0, 1.5, 2.0, 4.0), image_hw=None,
        output_size: int = 7, samples_per_bin: int = 2, mode: str = "avg",
        combine: str = "concat",
        max_elements: int = MAX_ELEMENTS) -> torch.Tensor:
    """The reference's fused MultiPath feature op: for each foveal factor
    f, expand the ROIs by f (clipped to image_hw when given) and pool every
    level, feats {level: (H_l, W_l, C_l)}. mode "avg" / "max": roi_align
    (float32, a bf16 map times float32 weights, as jnp promotes it);
    "exact_max": roi_pool_max (the map's dtype). combine="concat" ->
    (F, R, G, G, sum_l C_l); combine="sum" (equal-C levels, already 1x1
    reduced) -> (F, R, G, G, C), the levels summed in level order in the
    pooled dtype, as the reference's Python sum does."""
    if mode not in ("avg", "max", "exact_max"):
        raise ValueError(f"mode must be avg|max|exact_max, got {mode!r}")
    if combine not in ("concat", "sum"):
        raise ValueError(f"combine must be concat|sum, got {combine!r}")
    out_per_f = []
    for f in foveal_factors:
        r = (box_ops.expand(rois, f, image_hw[0], image_hw[1])
             if image_hw is not None else box_ops.expand(rois, f))
        if mode == "exact_max":
            pooled = [roi_pool_max(feats[lv], r, output_size=output_size,
                                   spatial_scale=scales[lv],
                                   max_elements=max_elements)
                      for lv in feats]
        else:
            pooled = [roi_align(feats[lv], r, output_size=output_size,
                                spatial_scale=scales[lv],
                                samples_per_bin=samples_per_bin, mode=mode,
                                max_elements=max_elements)
                      for lv in feats]
        out_per_f.append(sum(pooled) if combine == "sum"
                         else torch.cat(pooled, dim=-1))
    return torch.stack(out_per_f, dim=0)
