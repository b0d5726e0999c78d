"""Reference-exact ROI max pooling — port of the `exact_max` half of
multipathnet_tpu/ops/roi.py (`roi_pool_max`, the reference's
inn.ROIPooling semantics, and `multilevel_foveal_roi_features` in that
mode). The align half is the window kernels (ops/roi_pool.py).

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
each whole bin, and cotangent / count added into the map's gradient.

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
    grad = torch.zeros(feat.shape, dtype=torch.float32, device=feat.device)
    flat = grad.view(-1, feat.shape[-1])
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
        flat.index_put_((cell[..., None].expand(tie.shape),
                         torch.arange(feat.shape[-1], device=feat.device)
                         .expand(tie.shape)),
                        torch.where(tie, share, 0.0), accumulate=True)
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
        output_size: int = 7,
        max_elements: int = MAX_ELEMENTS) -> torch.Tensor:
    """The reference's fused MultiPath feature op in its exact_max mode
    with combine="concat": for each foveal factor f, expand the ROIs by f
    (clipped to image_hw when given), max-pool every level and concatenate
    the levels' channels: feats {level: (H_l, W_l, C_l)} -> (F, R, G, G,
    sum_l C_l)."""
    out_per_f = []
    for f in foveal_factors:
        r = (box_ops.expand(rois, f, image_hw[0], image_hw[1])
             if image_hw is not None else box_ops.expand(rois, f))
        pooled = [roi_pool_max(feats[lv], r, output_size=output_size,
                               spatial_scale=scales[lv],
                               max_elements=max_elements)
                  for lv in feats]
        out_per_f.append(torch.cat(pooled, dim=-1))
    return torch.stack(out_per_f, dim=0)
