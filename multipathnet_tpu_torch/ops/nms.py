"""Detection NMS with static shapes — port of multipathnet_tpu/ops/nms.py.

`nms` is the sequential pick/suppress oracle and `batched_nms` runs it over
a leading axis; `nms_sorted` solves the same
greedy recurrence for score-sorted candidates as a parallel fixpoint;
`multiclass_nms` is the eval post-processing (per-class top-k, per-class
NMS, global top max_detections). The reference vmaps over images; here
every function takes leading batch axes written out.

Top-k order: lax.top_k returns descending scores with the lower index
first among ties. torch.topk promises no tie order, so `_top_k` is a stable
descending sort, sliced.
"""

from __future__ import annotations

import torch

from multipathnet_tpu_torch.ops import boxes as box_ops
from multipathnet_tpu_torch.utils import profiling

_NEG = -1e10


def _top_k(x: torch.Tensor, k: int):
    """lax.top_k over the last axis: descending, ties by lower index."""
    s, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k]


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        max_out: int, valid: torch.Tensor | None = None):
    """Greedy NMS over N boxes (one problem): returns (indices (max_out,),
    keep (max_out,)) — max_out pick-argmax / suppress steps."""
    n = boxes.shape[0]
    iou = box_ops.iou_matrix(boxes, boxes)
    s = scores if valid is None else torch.where(
        valid, scores, torch.full_like(scores, _NEG))
    s = torch.where(torch.isfinite(s), s, torch.full_like(s, _NEG))
    ar = torch.arange(n, device=boxes.device)
    idx, keep = [], []
    for _ in range(max_out):
        i = torch.argmax(s)
        ok = s[i] > _NEG / 2
        kill = (iou[i] > iou_threshold) | (ar == i)
        s = torch.where(ok & kill, torch.full_like(s, _NEG), s)
        idx.append(i)
        keep.append(ok)
    return torch.stack(idx), torch.stack(keep)


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                iou_threshold: float, max_out: int,
                valid: torch.Tensor | None = None):
    """nms over a leading axis: boxes (B, N, 4), scores (B, N), valid
    (B, N) or None -> (indices (B, max_out), keep (B, max_out)); each
    problem is independent."""
    out = [nms(boxes[i], scores[i], iou_threshold, max_out,
               None if valid is None else valid[i])
           for i in range(boxes.shape[0])]
    return (torch.stack([i for i, _ in out]),
            torch.stack([k for _, k in out]))


def nms_sorted(boxes: torch.Tensor, scores: torch.Tensor,
               iou_threshold: float) -> torch.Tensor:
    """Greedy NMS for DESCENDING-sorted scores as a parallel fixpoint:
    boxes (..., N, 4), scores (..., N) -> keep (..., N) bool, input order.

    Greedy NMS is the unique solution of
        keep_i = ok_i and not exists j < i: keep_j and iou(j, i) > t;
    start from keep = ok and recompute every row at once until nothing
    changes (at most N rounds, 3-6 in practice). Problems along the leading
    axes iterate together; a converged problem stays fixed. Each round,
    the last one that changes nothing included, is counted (nms.rounds)
    and reads one flag back from the device (sync.nms_round).
    """
    n = boxes.shape[-2]
    iou = box_ops.iou_matrix(boxes, boxes)
    ok = scores > _NEG / 2
    ar = torch.arange(n, device=boxes.device)
    sup = (iou > iou_threshold) & (ar[:, None] < ar[None, :])
    keep = ok
    for _ in range(max(n, 1)):
        kill = torch.any(sup & keep[..., :, None], dim=-2)
        new = ok & ~kill
        profiling.count("nms.rounds")
        profiling.count_sync("nms_round", keep.device)
        changed = bool(torch.any(new != keep))
        keep = new
        if not changed:
            break
    return keep


@profiling.span("multiclass_nms")
def multiclass_nms(boxes: torch.Tensor, scores: torch.Tensor,
                   valid: torch.Tensor, *, score_threshold: float,
                   iou_threshold: float, pre_nms_per_class: int,
                   max_detections: int) -> dict:
    """Detection post-processing over leading batch axes.

    boxes (..., N, C, 4) per class or (..., N, 4) shared; scores (..., N, C)
    foreground classes only; valid (..., N). Returns a dict of
    boxes (..., D, 4), scores (..., D), classes (..., D) int32 (0-based fg
    class), indices (..., D) int32 source proposal, valid (..., D) bool,
    with D = max_detections.
    """
    n, c = scores.shape[-2:]
    lead = scores.shape[:-2]
    if boxes.dim() == scores.dim():
        boxes = boxes[..., None, :].expand(*lead, n, c, 4)

    neg = torch.full_like(scores, _NEG)
    s = torch.where(valid[..., None], scores, neg)
    s = torch.where(s >= score_threshold, s, neg)

    k = min(pre_nms_per_class, n)
    top_s, top_i = _top_k(s.transpose(-1, -2), k)         # (..., C, k)
    cls_boxes = torch.gather(
        boxes.transpose(-3, -2), -2,
        top_i[..., None].expand(*top_i.shape, 4))         # (..., C, k, 4)

    keep = nms_sorted(cls_boxes, top_s, iou_threshold)
    kept_s = torch.where(keep, top_s, torch.full_like(top_s, _NEG))
    kept_c = torch.arange(c, dtype=torch.int32, device=scores.device)[
        :, None].expand(c, k)

    flat_s = kept_s.reshape(*lead, c * k)
    flat_b = cls_boxes.reshape(*lead, c * k, 4)
    flat_c = kept_c.reshape(c * k).expand(*lead, c * k)
    flat_src = top_i.reshape(*lead, c * k)
    d = min(max_detections, c * k)
    fs, fi = _top_k(flat_s, d)
    out = {
        "boxes": torch.gather(flat_b, -2, fi[..., None].expand(*fi.shape, 4)),
        "scores": fs,
        "classes": torch.gather(flat_c, -1, fi),
        "indices": torch.gather(flat_src, -1, fi).to(torch.int32),
        "valid": fs > _NEG / 2,
    }
    if d < max_detections:
        pad = max_detections - d

        def padded(x, value=0):
            shape = (*x.shape[:len(lead)], pad, *x.shape[len(lead) + 1:])
            return torch.cat([x, torch.full(shape, value, dtype=x.dtype,
                                             device=x.device)],
                             dim=len(lead))

        out = {"boxes": padded(out["boxes"]),
               "scores": padded(out["scores"], _NEG),
               "classes": padded(out["classes"]),
               "indices": padded(out["indices"]),
               "valid": padded(out["valid"], False)}
    out["scores"] = torch.where(out["valid"], out["scores"],
                                torch.zeros_like(out["scores"]))
    return out
