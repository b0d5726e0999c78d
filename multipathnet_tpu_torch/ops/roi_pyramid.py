"""Stacked 2x average pyramids — port of the avg-mode half of
multipathnet_tpu/ops/roi_pyramid.py.

Each (ROI, foveal) view picks the pyramid scale where its G bins span
(0.5, 1] cell, so all of its bilinear samples fall in one fixed
WINDOW x WINDOW_X window (ops/roi_pool.py). Each level's scales are stacked
along rows in ONE (sum_rows, Wmax, C) buffer with per-scale row offsets, so
scale selection is an offset add.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


def window_sizes(output_size: int) -> tuple:
    """-> (rows, cols) of the sampling window for a G-bin view: G + 3 rows,
    and G + 9 columns (7 cells of alignment slack) rounded up to a multiple
    of 8 (G=7 -> 10 x 16)."""
    return output_size + 3, -(-(output_size + 9) // 8) * 8


# The G=7 window the pool kernels are written for.
WINDOW, WINDOW_X = window_sizes(7)


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


def build_pyramid_batch(feats: torch.Tensor, spatial_scale: float,
                        num_scales: int | None = None,
                        output_size: int = 7):
    """feats (B, H, W, C) -> (flat_batch (B*rows, Wmax, C), meta Pyramid).

    Average mode: 2x area pooling that divides by the count of valid cells
    (an odd dimension's last cell pools alone), zero padding. meta
    describes ONE image's pyramid; its flat is image 0's rows (a view).
    Sums run in the feature dtype, as in the reference. The slice
    assignments into zero buffers are differentiable: the pyramid's
    gradient flows back to feats.
    """
    b, h, w, c = feats.shape
    if num_scales is None:
        num_scales = num_scales_for(h, w, output_size)
    win_y, win_x = window_sizes(output_size)
    wmax = max(-(-w // 8) * 8, win_x)
    heights, widths, rows = [], [], []
    ch, cw = h, w
    for _ in range(num_scales):
        heights.append(ch)
        widths.append(cw)
        rows.append(max(ch, win_y))
        ch, cw = (ch + ch % 2) // 2, (cw + cw % 2) // 2
    offsets = [sum(rows[:i]) for i in range(num_scales)]
    total = sum(rows)

    flat = feats.new_zeros((b, total, wmax, c))
    cur = feats
    for s in range(num_scales):
        ch, cw = heights[s], widths[s]
        flat[:, offsets[s]:offsets[s] + ch, :cw] = cur
        if s + 1 == num_scales:
            break
        ph, pw = ch + ch % 2, cw + cw % 2
        nxt = feats.new_zeros((b, ph, pw, c))
        nxt[:, :ch, :cw] = cur
        cnt = feats.new_zeros((ph, pw, 1))
        cnt[:ch, :cw] = 1.0
        pooled = nxt.reshape(b, ph // 2, 2, pw // 2, 2, c).sum(dim=(2, 4))
        norm = cnt.reshape(ph // 2, 2, pw // 2, 2, 1).sum(dim=(1, 3))
        cur = pooled / torch.clamp(norm, min=1.0)

    def ints(v):
        return torch.tensor(v, dtype=torch.int32, device=feats.device)

    meta = Pyramid(flat[0], ints(offsets), ints(heights), ints(widths),
                   spatial_scale, num_scales)
    return flat.reshape(b * total, wmax, c), meta


def build_pyramid(feat: torch.Tensor, spatial_scale: float,
                  num_scales: int | None = None,
                  output_size: int = 7) -> Pyramid:
    """feat (H, W, C) -> one image's stacked avg pyramid."""
    flat, meta = build_pyramid_batch(feat[None], spatial_scale, num_scales,
                                     output_size)
    return meta._replace(flat=flat)
