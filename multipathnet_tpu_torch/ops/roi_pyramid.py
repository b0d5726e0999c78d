"""Stacked 2x pyramids — port of multipathnet_tpu/ops/roi_pyramid.py.

Average pyramids feed the align route: each (ROI, foveal) view picks the
pyramid scale where its G bins span (0.5, 1] cell, so all of its bilinear
samples fall in G + 3 rows, inside the one fixed WINDOW x WINDOW_X (10 x
16) window that the pool kernels read at every G <= 7 (ops/roi_pool.py).
Each level's scales are stacked along rows in ONE (sum_rows, Wmax, C)
buffer with per-scale row offsets, so scale selection is an offset add.
Every scale takes at least max(window_sizes(G)[0], WINDOW) rows, so a
kernel window of a scale shorter than that stays inside its buffer (the
reference gives a scale window_sizes(G)[0] rows, which at G < 7 is fewer
than its own kernels' window: C12, ROADMAP.md).

`pyramid_roi_align(mode="avg"|"max")` is the reference's bilinear window
sampler at any G and S, in plain ops (the reference computes it in XLA;
SharpMask's 7 x 7 and 28 x 28 eval pools take it, models/sharpmask.py, and
so does the detector's roi_impl="pyramid", models/multipath.py):
each view's window_sizes(G) window is gathered from its scale and its G*S
x G*S samples come from two float32 contractions, the bilinear weight rows
wy (G*S, rows) against the window's rows, then wx (G*S, cols) against its
columns; then the mean or max of each bin's S x S samples. Views go in
chunks so the gathered windows stay within `max_elements`.

Max pyramids (2x max pooling, padding _NEG) feed the windowed max route of
roi_mode="max" (`pyramid_roi_align`, the reference's mode="exact_max"): the
reference's floor/ceil ROIPooling rule applied at the selected scale's
cells inside the same window, as two masked maxes (rows into bins, columns
into bins). It equals ops/roi.roi_pool_max bit for bit for views whose bins
span at most one base cell; at coarser scales the bin edges snap to 2^l
base cells.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from multipathnet_tpu_torch.ops import boxes as box_ops
from multipathnet_tpu_torch.ops.roi import fma32, inv
from multipathnet_tpu_torch.utils import profiling


def window_sizes(output_size: int) -> tuple:
    """-> (rows, cols) of the sampling window for a G-bin view: G + 3 rows,
    and G + 9 columns (7 cells of alignment slack) rounded up to a multiple
    of 8 (G=7 -> 10 x 16)."""
    return output_size + 3, -(-(output_size + 9) // 8) * 8


# The pool kernels' window, G = 7's, which they read at every G <= 7.
WINDOW, WINDOW_X = window_sizes(7)


def scale_rows(output_size: int) -> int:
    """The fewest rows a pyramid scale takes: the sampling window's, and at
    least the pool kernels' WINDOW, so that their window at any G <= 7
    lies inside every scale (G >= 7: window_sizes(G)[0], the reference's)."""
    return max(window_sizes(output_size)[0], WINDOW)


class Pyramid(NamedTuple):
    flat: torch.Tensor         # (sum_rows, Wmax, C)
    row_offsets: torch.Tensor  # (L,) int32 — scale l starts at this row
    heights: torch.Tensor      # (L,) int32 — valid rows per scale
    widths: torch.Tensor       # (L,) int32 — valid cols per scale
    base_scale: float          # spatial_scale of scale 0 (e.g. 1/4 for c3)
    num_scales: int


def num_scales_for(h: int, w: int, output_size: int = 7) -> int:
    """Enough scales that the largest possible ROI has bins within a cell."""
    span = max(h, w) / output_size
    return max(1, int(math.ceil(math.log2(max(span, 1.0)))) + 1)


# Padding value of max pyramids: large-negative finite (representable in
# bf16 too). A masked max never selects it for a non-empty bin.
_NEG = -3.0e38


def build_pyramid_batch(feats: torch.Tensor, spatial_scale: float,
                        num_scales: int | None = None,
                        output_size: int = 7, mode: str = "avg"):
    """feats (B, H, W, C) -> (flat_batch (B*rows, Wmax, C), meta Pyramid).

    mode="avg": 2x area pooling that divides by the count of valid cells
    (an odd dimension's last cell pools alone), zero padding. Sums run in
    the feature dtype, as in the reference. mode="max": 2x max pooling,
    _NEG padding. Each scale takes max(its height, scale_rows(G)) rows.
    meta describes ONE image's pyramid; its flat is image 0's rows (a
    view). The slice assignments into the buffers are differentiable: the
    pyramid's gradient flows back to feats.
    """
    if mode not in ("avg", "max"):
        raise ValueError(f"mode must be avg|max, got {mode!r}")
    b, h, w, c = feats.shape
    if num_scales is None:
        num_scales = num_scales_for(h, w, output_size)
    min_rows = scale_rows(output_size)
    wmax = max(-(-w // 8) * 8, window_sizes(output_size)[1])
    heights, widths, rows = [], [], []
    ch, cw = h, w
    for _ in range(num_scales):
        heights.append(ch)
        widths.append(cw)
        rows.append(max(ch, min_rows))
        ch, cw = (ch + ch % 2) // 2, (cw + cw % 2) // 2
    offsets = [sum(rows[:i]) for i in range(num_scales)]
    total = sum(rows)

    pad = 0.0 if mode == "avg" else _NEG
    flat = feats.new_full((b, total, wmax, c), pad)
    cur = feats
    for s in range(num_scales):
        ch, cw = heights[s], widths[s]
        flat[:, offsets[s]:offsets[s] + ch, :cw] = cur
        if s + 1 == num_scales:
            break
        ph, pw = ch + ch % 2, cw + cw % 2
        nxt = feats.new_full((b, ph, pw, c), pad)
        nxt[:, :ch, :cw] = cur
        if mode == "max":
            cur = nxt.reshape(b, ph // 2, 2, pw // 2, 2, c).amax(dim=(2, 4))
            continue
        cnt = feats.new_zeros((ph, pw, 1))
        cnt[:ch, :cw] = 1.0
        pooled = nxt.reshape(b, ph // 2, 2, pw // 2, 2, c).sum(dim=(2, 4))
        norm = cnt.reshape(ph // 2, 2, pw // 2, 2, 1).sum(dim=(1, 3))
        cur = pooled / torch.clamp(norm, min=1.0)

    def ints(v):
        profiling.count_sync("pyramid_meta", feats.device)
        return torch.tensor(v, dtype=torch.int32, device=feats.device)

    meta = Pyramid(flat[0], ints(offsets), ints(heights), ints(widths),
                   spatial_scale, num_scales)
    return flat.reshape(b * total, wmax, c), meta


def build_pyramid(feat: torch.Tensor, spatial_scale: float,
                  num_scales: int | None = None,
                  output_size: int = 7, mode: str = "avg") -> Pyramid:
    """feat (H, W, C) -> one image's stacked pyramid."""
    flat, meta = build_pyramid_batch(feat[None], spatial_scale, num_scales,
                                     output_size, mode)
    return meta._replace(flat=flat)


def _sample_weights(coords: torch.Tensor, window: int) -> torch.Tensor:
    """coords (..., N) local window coordinates -> (..., N, window)
    bilinear weight rows max(0, 1 - |coord - cell|)."""
    cells = torch.arange(window, dtype=coords.dtype, device=coords.device)
    return torch.clamp(1.0 - torch.abs(coords[..., None] - cells), min=0.0)


def _align_views(pyr: Pyramid, rois: torch.Tensor, g: int, s: int):
    """The reference's _one_roi geometry for every view at once: rois (N,
    4) image coords -> (window rows (N, win_y) into pyr.flat, window
    columns (N, win_x), wy (N, G*S, win_y), wx (N, G*S, win_x)), float32
    arithmetic at the view's pyramid scale (bins spanning (0.5, 1] cell).
    """
    f32 = torch.float32
    dev = rois.device
    rg = inv(g)  # as XLA compiles the reference (ops/roi.py)
    b = rois.to(f32) * pyr.base_scale
    x1, y1 = b[:, 0], b[:, 1]
    bw = torch.clamp(b[:, 2] - x1, min=1e-6)
    bh = torch.clamp(b[:, 3] - y1, min=1e-6)
    span = torch.maximum(bw, bh) * rg
    lvl = torch.clamp(torch.ceil(torch.log2(torch.clamp(span, min=1.0))).to(
        torch.int32), 0, pyr.num_scales - 1).long()
    cell = torch.exp2(lvl.to(f32))[:, None]
    heights = pyr.heights.to(dev)[lvl]
    widths = pyr.widths.to(dev)[lvl]
    k = torch.arange(g * s, device=dev)
    off = (k // s).to(f32) + ((k % s).to(f32) + 0.5) / s     # (G*S,)
    zero = torch.zeros((), dtype=f32, device=dev)
    sy = torch.minimum(torch.maximum(
        fma32(off * bh[:, None], rg, y1[:, None]) / cell, zero),
        heights.to(f32)[:, None] - 1.0)
    sx = torch.minimum(torch.maximum(
        fma32(off * bw[:, None], rg, x1[:, None]) / cell, zero),
        widths.to(f32)[:, None] - 1.0)
    win_y, win_x = window_sizes(g)
    y0 = torch.minimum(torch.clamp(torch.floor(sy[:, 0]).to(torch.int32),
                                   min=0),
                       torch.clamp(heights - win_y, min=0))
    x0 = torch.minimum(torch.clamp(torch.floor(sx[:, 0]).to(torch.int32),
                                   min=0),
                       torch.clamp(widths - win_x, min=0))
    wy = _sample_weights(torch.clamp(sy - y0.to(f32)[:, None], 0.0,
                                     win_y - 1.0), win_y)
    wx = _sample_weights(torch.clamp(sx - x0.to(f32)[:, None], 0.0,
                                     win_x - 1.0), win_x)
    rows = (pyr.row_offsets.to(dev).long()[lvl] + y0.long())[:, None] + \
        torch.arange(win_y, device=dev)
    cols = x0.long()[:, None] + torch.arange(win_x, device=dev)
    return rows, cols, wy, wx


def _align_pool(flat, rows, cols, wy, wx, g, s, mode) -> torch.Tensor:
    """One chunk of views: windows flat[rows, cols] in float32 -> (n, G,
    G, C), the two contractions then the S x S mean or max."""
    win = flat[rows[:, :, None], cols[:, None, :]].float()  # (n, wy, wx, C)
    t = torch.einsum("niy,nyxc->nixc", wy, win)
    v = torch.einsum("nixc,njx->nijc", t, wx)              # (n, GS, GS, C)
    if s == 1:  # one sample per bin: the mean or max of one value
        return v
    n, c = v.shape[0], v.shape[-1]
    v = v.reshape(n, g, s, g, s, c)
    return v.mean(dim=(2, 4)) if mode == "avg" else v.amax(dim=(2, 4))


def batched_pyramid_roi_align(flat: torch.Tensor, meta: Pyramid,
                              rois: torch.Tensor, *, output_size: int = 7,
                              samples_per_bin: int = 2, mode: str = "avg",
                              max_elements: int = 1 << 27) -> torch.Tensor:
    """The reference's vmap over images of pyramid_roi_align in the
    bilinear modes: flat, meta from build_pyramid_batch (B images), rois
    (B, R, 4) image coords -> (B, R, G, G, C) float32."""
    if mode not in ("avg", "max"):
        raise ValueError(f"mode must be avg|max, got {mode!r}")
    nb, r = rois.shape[:2]
    g, s = output_size, samples_per_bin
    c = flat.shape[-1]
    if nb * r == 0:
        return flat.new_zeros((nb, r, g, g, c), dtype=torch.float32)
    rows, cols, wy, wx = _align_views(meta, rois.reshape(-1, 4), g, s)
    rows = rows + (torch.arange(nb, device=rows.device) * meta.flat.shape[0]
                   ).repeat_interleave(r)[:, None]
    win_y, win_x = window_sizes(g)
    per = max(1, max_elements // (win_y * win_x * c + g * s * win_x * c))
    out = [_align_pool(flat, rows[i:i + per], cols[i:i + per],
                       wy[i:i + per], wx[i:i + per], g, s, mode)
           for i in range(0, nb * r, per)]
    return torch.cat(out).reshape(nb, r, g, g, c)


def _exact_max_views(pyr: Pyramid, rois: torch.Tensor, g: int):
    """The windowed max route's geometry, the reference's _one_roi_max for
    every view at once: rois (N, 4) image coords -> (window rows (N,
    win_y), window columns (N, win_x), row masks (N, G, win_y), column
    masks (N, G, win_x), empty bins (N, G, G)), all in float32 arithmetic
    at the view's pyramid scale."""
    f32 = torch.float32
    dev = rois.device
    rg = inv(g)  # as XLA compiles the reference (ops/roi.py)
    b = rois.to(f32) * pyr.base_scale
    bw = torch.clamp(b[:, 2] - b[:, 0], min=1e-6)
    bh = torch.clamp(b[:, 3] - b[:, 1], min=1e-6)
    span = torch.maximum(bw, bh) * rg
    lvl = torch.clamp(torch.ceil(torch.log2(torch.clamp(span, min=1.0))).to(
        torch.int32), 0, pyr.num_scales - 1).long()
    cell = torch.exp2(lvl.to(f32))
    x1 = torch.floor(b[:, 0] / cell)
    y1 = torch.floor(b[:, 1] / cell)
    x2 = torch.ceil(b[:, 2] / cell)
    y2 = torch.ceil(b[:, 3] / cell)
    roi_h = torch.clamp(y2 - y1, min=1.0)[:, None]
    roi_w = torch.clamp(x2 - x1, min=1.0)[:, None]
    heights = pyr.heights.to(dev)[lvl]
    widths = pyr.widths.to(dev)[lvl]
    hl = heights.to(f32)[:, None]
    wl = widths.to(f32)[:, None]
    bins = torch.arange(g, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    ys = torch.minimum(torch.maximum(
        torch.floor(fma32(bins * roi_h, rg, y1[:, None])), zero), hl)
    ye = torch.minimum(torch.maximum(
        torch.ceil(fma32((bins + 1) * roi_h, rg, y1[:, None])), zero), hl)
    xs = torch.minimum(torch.maximum(
        torch.floor(fma32(bins * roi_w, rg, x1[:, None])), zero), wl)
    xe = torch.minimum(torch.maximum(
        torch.ceil(fma32((bins + 1) * roi_w, rg, x1[:, None])), zero), wl)

    win_y, win_x = window_sizes(g)
    y0 = torch.minimum(torch.clamp(y1.to(torch.int32), min=0),
                       torch.clamp(heights - win_y, min=0))
    x0 = torch.minimum(torch.clamp(x1.to(torch.int32), min=0),
                       torch.clamp(widths - win_x, min=0))
    cy = y0[:, None] + torch.arange(win_y, dtype=torch.int32, device=dev)
    cx = x0[:, None] + torch.arange(win_x, dtype=torch.int32, device=dev)
    my = ((cy.to(f32)[:, None, :] >= ys[:, :, None])
          & (cy.to(f32)[:, None, :] < ye[:, :, None]))
    mx = ((cx.to(f32)[:, None, :] >= xs[:, :, None])
          & (cx.to(f32)[:, None, :] < xe[:, :, None]))
    rows = pyr.row_offsets.to(dev).long()[lvl][:, None] + cy.long()
    empty = (ye <= ys)[:, :, None] | (xe <= xs)[:, None, :]
    return rows, cx.long(), my, mx, empty


def pyramid_roi_align(pyr: Pyramid, rois: torch.Tensor, *,
                      output_size: int = 7, samples_per_bin: int = 2,
                      mode: str = "avg",
                      max_elements: int = 1 << 27) -> torch.Tensor:
    """The reference's pyramid_roi_align: rois (N, 4) image coords -> (N,
    G, G, C) float32. mode="avg" (the default, as the reference's) |
    "max": the bilinear window sampler on an avg pyramid (module
    docstring). mode="exact_max" (the detector's windowed max route): the
    reference's ROIPooling rule on a max pyramid, each view's
    window read in float32 and reduced rows-into-bins, then
    columns-into-bins; empty bins and values at the padding give 0. Views
    are taken in chunks so the windows stay within `max_elements`."""
    if mode != "exact_max":
        return batched_pyramid_roi_align(
            pyr.flat, pyr, rois[None], output_size=output_size,
            samples_per_bin=samples_per_bin, mode=mode,
            max_elements=max_elements)[0]
    g = output_size
    c = pyr.flat.shape[-1]
    win_y, win_x = window_sizes(g)
    n = rois.shape[0]
    if n == 0:
        return pyr.flat.new_zeros((0, g, g, c), dtype=torch.float32)
    neg = torch.full((), _NEG, dtype=torch.float32, device=pyr.flat.device)
    per = max(1, max_elements // (g * win_y * win_x * c))
    out = []
    for r0 in range(0, n, per):
        rows, cols, my, mx, empty = _exact_max_views(pyr, rois[r0:r0 + per],
                                                     g)
        win = pyr.flat[rows[:, :, None], cols[:, None, :]].float()
        t = torch.where(my[:, :, :, None, None], win[:, None],
                        neg).amax(dim=2)                   # (n, G, win_x, C)
        v = torch.where(mx[:, None, :, :, None], t[:, :, None],
                        neg).amax(dim=3)                   # (n, G, G, C)
        out.append(torch.where(empty[..., None] | (v <= _NEG / 2),
                               torch.zeros_like(v), v))
    return torch.cat(out)


def multilevel_foveal_pyramid_features(
        pyramids: dict, rois: torch.Tensor, *,
        foveal_factors=(1.0, 1.5, 2.0, 4.0), image_hw=None,
        output_size: int = 7, samples_per_bin: int = 2,
        mode: str = "avg", combine: str = "concat") -> torch.Tensor:
    """ops.roi.multilevel_foveal_roi_features through pyramids ({level:
    Pyramid}; max pyramids for mode="exact_max", avg ones for "avg" and
    "max"): (F, R, G, G, sum_l C_l) float32 with the levels' channels
    concatenated (combine="concat"), or (F, R, G, G, C) with equal-C
    levels summed in level order (combine="sum")."""
    if combine not in ("concat", "sum"):
        raise ValueError(f"combine must be concat|sum, got {combine!r}")
    out_per_f = []
    for f in foveal_factors:
        r = (box_ops.expand(rois, f, image_hw[0], image_hw[1])
             if image_hw is not None else box_ops.expand(rois, f))
        pooled = [pyramid_roi_align(pyr, r, output_size=output_size,
                                    samples_per_bin=samples_per_bin,
                                    mode=mode)
                  for pyr in pyramids.values()]
        out_per_f.append(sum(pooled) if combine == "sum"
                         else torch.cat(pooled, dim=-1))
    return torch.stack(out_per_f, dim=0)
