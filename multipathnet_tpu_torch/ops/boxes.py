"""Box math — IoU, Fast R-CNN delta encode/decode, clip, foveal expansion.

Port of multipathnet_tpu/ops/boxes.py. Boxes are (x1, y1, x2, y2) in
continuous 0-based coordinates, width = x2 - x1 (no +1). Every function
broadcasts over leading axes and keeps zero-area padded boxes finite. The
delta parameterization is Fast R-CNN's (arXiv:1504.08083 §2.3):

    tx = (gx - px) / pw      tw = log(gw / pw)
    ty = (gy - py) / ph      th = log(gh / ph)
"""

from __future__ import annotations

import torch

# Clamp on tw/th deltas before exp: exp(4.14) ~ 63x growth (log(1000/16));
# keeps garbage padded rows from overflowing.
BBOX_XFORM_CLIP = 4.135166556742356

_EPS = 1e-8


def area(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (...). Degenerate boxes get area 0."""
    w = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
    h = torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0)
    return w * h


def to_center_form(boxes: torch.Tensor) -> torch.Tensor:
    """(x1,y1,x2,y2) -> (cx,cy,w,h)."""
    wh = boxes[..., 2:4] - boxes[..., 0:2]
    c = boxes[..., 0:2] + 0.5 * wh
    return torch.cat([c, wh], dim=-1)


def from_center_form(cboxes: torch.Tensor) -> torch.Tensor:
    """(cx,cy,w,h) -> (x1,y1,x2,y2)."""
    half = 0.5 * cboxes[..., 2:4]
    return torch.cat([cboxes[..., 0:2] - half, cboxes[..., 0:2] + half],
                     dim=-1)


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU: a (..., N, 4), b (..., M, 4) -> (..., N, M).
    Zero-area (padded) boxes yield IoU 0 against everything."""
    a_ = a[..., :, None, :]
    b_ = b[..., None, :, :]
    lt = torch.maximum(a_[..., 0:2], b_[..., 0:2])
    rb = torch.minimum(a_[..., 2:4], b_[..., 2:4])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area(a)[..., :, None] + area(b)[..., None, :] - inter
    return inter / torch.clamp(union, min=_EPS)


def _row(values, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(values, dtype=like.dtype, device=like.device)


def encode(rois: torch.Tensor, gt: torch.Tensor,
           means=(0.0, 0.0, 0.0, 0.0), stds=(1.0, 1.0, 1.0, 1.0)
           ) -> torch.Tensor:
    """Regression targets for matched (roi, gt) pairs; both (..., 4) ->
    (..., 4), normalized by (means, stds) (the BBoxNorm behaviour)."""
    r = to_center_form(rois)
    g = to_center_form(gt)
    rw = torch.clamp(r[..., 2], min=_EPS)
    rh = torch.clamp(r[..., 3], min=_EPS)
    tx = (g[..., 0] - r[..., 0]) / rw
    ty = (g[..., 1] - r[..., 1]) / rh
    tw = torch.log(torch.clamp(g[..., 2], min=_EPS) / rw)
    th = torch.log(torch.clamp(g[..., 3], min=_EPS) / rh)
    t = torch.stack([tx, ty, tw, th], dim=-1)
    return (t - _row(means, t)) / _row(stds, t)


def decode(rois: torch.Tensor, deltas: torch.Tensor,
           means=(0.0, 0.0, 0.0, 0.0), stds=(1.0, 1.0, 1.0, 1.0)
           ) -> torch.Tensor:
    """Apply predicted deltas to boxes; (..., 4) each. Denormalizes by
    (means, stds) first; tw/th are clamped at BBOX_XFORM_CLIP."""
    d = deltas * _row(stds, deltas) + _row(means, deltas)
    r = to_center_form(rois)
    rw = torch.clamp(r[..., 2], min=_EPS)
    rh = torch.clamp(r[..., 3], min=_EPS)
    cx = d[..., 0] * rw + r[..., 0]
    cy = d[..., 1] * rh + r[..., 1]
    w = torch.exp(torch.clamp(d[..., 2], max=BBOX_XFORM_CLIP)) * rw
    h = torch.exp(torch.clamp(d[..., 3], max=BBOX_XFORM_CLIP)) * rh
    return from_center_form(torch.stack([cx, cy, w, h], dim=-1))


def clip(boxes: torch.Tensor, height, width) -> torch.Tensor:
    """Clip boxes to [0, width] x [0, height]."""
    x1 = torch.clamp(boxes[..., 0], 0.0, width)
    y1 = torch.clamp(boxes[..., 1], 0.0, height)
    x2 = torch.clamp(boxes[..., 2], 0.0, width)
    y2 = torch.clamp(boxes[..., 3], 0.0, height)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def expand(boxes: torch.Tensor, factor, height=None, width=None
           ) -> torch.Tensor:
    """Foveal context expansion (MultiPath §3.1): scale each box by
    `factor` about its center; optionally clip to the image."""
    c = to_center_form(boxes)
    f = torch.as_tensor(factor, dtype=boxes.dtype, device=boxes.device)
    wh = c[..., 2:4] * f[..., None]
    out = from_center_form(torch.cat([c[..., 0:2], wh], dim=-1))
    if height is not None and width is not None:
        out = clip(out, height, width)
    return out
