"""Plain reference of the detector's post-processing: per-class greedy NMS.

For each image and foreground class: the candidates are the valid
proposals whose score reaches the threshold; the best `pre_nms` of them
by score (ties to the lower proposal index) are visited in that order,
and each is kept unless a kept one overlaps it by IoU above the
threshold. The kept ones of every class are then ranked by score (ties
to the lower class, then the earlier rank) and the first `max_det`
returned. IoU is intersection over union in float32, the union floored
at 1e-8, boxes (x1, y1, x2, y2) with width x2 - x1.
"""

from __future__ import annotations

import numpy as np
import torch


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 4), (..., M, 4) -> (..., N, M)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]

    def area(x):
        return (torch.clamp(x[..., 2] - x[..., 0], min=0.0)
                * torch.clamp(x[..., 3] - x[..., 1], min=0.0))

    union = area(a)[..., :, None] + area(b)[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-8)


@torch.no_grad()
def multiclass_nms(boxes, scores, valid, *, score_threshold: float,
                   iou_threshold: float, pre_nms: int, max_det: int):
    """boxes (B, N, C, 4), scores (B, N, C), valid (B, N) -> a list, one
    per image, of kept detections (score, class, proposal index, box) in
    output order, classes 0-based."""
    b, n, c = scores.shape
    ok = valid[:, :, None] & (scores >= score_threshold)
    s = torch.where(ok, scores, torch.full_like(scores, -float("inf")))
    k = min(pre_nms, n)
    order = torch.sort(s.transpose(1, 2), dim=-1, descending=True,
                       stable=True).indices[..., :k]             # (B, C, k)
    top_s = torch.gather(s.transpose(1, 2), -1, order)
    top_b = torch.gather(boxes.transpose(1, 2), 2,
                         order[..., None].expand(b, c, k, 4))
    over = iou(top_b, top_b) > iou_threshold                     # (B, C, k, k)
    cand = torch.isfinite(top_s)
    keep = torch.zeros_like(cand)
    for i in range(k):
        hit = (over[..., :i, i] & keep[..., :i]).any(-1)
        keep[..., i] = cand[..., i] & ~hit
    keep, top_s = keep.cpu().numpy(), top_s.cpu().numpy()
    order, top_b = order.cpu().numpy(), top_b.cpu().numpy()
    out = []
    for img in range(b):
        ci, r = np.nonzero(keep[img])          # class-major, rank order
        first = np.lexsort((r, ci, -top_s[img, ci, r]))[:max_det]
        ci, r = ci[first], r[first]
        out.append(list(zip(top_s[img, ci, r].tolist(), ci.tolist(),
                            order[img, ci, r].tolist(),
                            top_b[img, ci, r].tolist())))
    return out
