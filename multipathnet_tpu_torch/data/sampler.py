"""fg/bg ROI sampling on the device — port of multipathnet_tpu/data/
sampler.py (the BatchProviderROI redesign).

Per image: GT boxes join the proposal pool, every pool box is matched to
its best-IoU GT, and up to rois_per_image * fg_fraction boxes are drawn
without replacement from the fg pool (IoU >= 0.5), the rest from the bg
pool (IoU in [0.1, 0.5)), by the Gumbel-top-k trick: uniform noise on the
candidates, -1 elsewhere, top k. Regression targets follow Fast R-CNN §2.3.

The function is split. `sample_rois` is pure: it takes the uniform draws as
a tensor, so a test can feed it the reference's draws. `sample_batch` draws
them from a torch.Generator. Where a pool holds fewer than k candidates the
-1 scores tie, and `ops/nms._top_k` breaks ties by lower index, as
lax.top_k does. Every function works over leading batch axes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multipathnet_tpu_torch.ops import boxes as box_ops
from multipathnet_tpu_torch.ops.nms import _top_k


class RoiSample(NamedTuple):
    rois: torch.Tensor           # (..., S, 4) sampled boxes, image coords
    matched_class: torch.Tensor  # (..., S) int32 — class of best-IoU GT
    max_iou: torch.Tensor        # (..., S) f32 — IoU with that GT
    bbox_targets: torch.Tensor   # (..., S, 4) f32 — normalized deltas
    is_fg: torch.Tensor          # (..., S) bool — sampled from the fg pool
    valid: torch.Tensor          # (..., S) bool — slot holds a candidate


def _masked_topk_sample(noise, candidate_mask, k: int):
    """Up to k distinct indices of candidate_mask == True, ranked by noise.
    Returns (idx (..., k) int64, got (..., k) bool)."""
    n = candidate_mask.shape[-1]
    scores = torch.where(candidate_mask, noise, torch.full_like(noise, -1.0))
    kk = min(k, n)
    _, idx = _top_k(scores, kk)
    got = torch.gather(candidate_mask, -1, idx)
    if kk < k:  # pool smaller than the request: pad with invalid slots
        lead = idx.shape[:-1]
        idx = torch.cat([idx, idx.new_zeros((*lead, k - kk))], -1)
        got = torch.cat([got, got.new_zeros((*lead, k - kk))], -1)
    return idx, got


def _take(x, idx):
    """x (..., N, D) or (..., N) gathered at idx (..., K) along N."""
    if x.dim() == idx.dim():
        return torch.gather(x, -1, idx)
    return torch.gather(x, -2, idx[..., None].expand(*idx.shape, x.shape[-1]))


def sample_rois(noise, proposals, prop_mask, gt_boxes, gt_classes, gt_mask,
                *, rois_per_image: int = 64, fg_fraction: float = 0.25,
                fg_iou_threshold: float = 0.5,
                bg_iou_range: tuple = (0.1, 0.5),
                bbox_reg_means=(0.0, 0.0, 0.0, 0.0),
                bbox_reg_stds=(0.1, 0.1, 0.2, 0.2)) -> RoiSample:
    """The pure sampler. noise (..., 2, P + G) uniform draws in [0, 1): row
    0 ranks the fg pool, row 1 the bg pool; proposals (..., P, 4),
    prop_mask (..., P) bool, gt_boxes (..., G, 4), gt_classes (..., G)
    int, gt_mask (..., G) bool."""
    pool = torch.cat([proposals, gt_boxes], -2)
    pool_mask = torch.cat([prop_mask, gt_mask], -1)

    iou = box_ops.iou_matrix(pool, gt_boxes)          # (..., P+G, G)
    iou = torch.where(gt_mask[..., None, :], iou, torch.full_like(iou, -1.0))
    max_iou = iou.max(dim=-1).values
    argmax_gt = iou.argmax(dim=-1)
    matched_class = torch.gather(gt_classes, -1, argmax_gt)
    matched_box = _take(gt_boxes, argmax_gt)

    fg_pool = (max_iou >= fg_iou_threshold) & pool_mask
    bg_pool = ((max_iou >= bg_iou_range[0]) & (max_iou < bg_iou_range[1])
               & pool_mask)

    n_fg = int(round(rois_per_image * fg_fraction))
    n_bg = rois_per_image - n_fg
    fg_idx, fg_got = _masked_topk_sample(noise[..., 0, :], fg_pool, n_fg)
    bg_idx, bg_got = _masked_topk_sample(noise[..., 1, :], bg_pool, n_bg)

    idx = torch.cat([fg_idx, bg_idx], -1)
    valid = torch.cat([fg_got, bg_got], -1)
    is_fg = torch.cat([torch.ones(n_fg, dtype=torch.bool, device=idx.device),
                       torch.zeros(n_bg, dtype=torch.bool,
                                   device=idx.device)]) & valid

    rois = _take(pool, idx)
    s_cls = torch.where(is_fg, _take(matched_class, idx),
                        torch.zeros_like(idx, dtype=matched_class.dtype))
    targets = box_ops.encode(rois, _take(matched_box, idx),
                             means=bbox_reg_means, stds=bbox_reg_stds)
    targets = torch.where(is_fg[..., None], targets,
                          torch.zeros_like(targets))
    return RoiSample(rois, s_cls.to(torch.int32), _take(max_iou, idx),
                     targets, is_fg, valid)


def sample_batch(generator: torch.Generator, proposals, prop_mask, gt_boxes,
                 gt_classes, gt_mask, shard=None, **kw) -> RoiSample:
    """Draws the uniform noise from `generator` (on the inputs' device) and
    samples every image of the batch: tensors with a leading batch axis.
    `shard` (index, count): the batch is part `index` of `count` equal
    parts of a global batch; the noise is drawn for all of it and this
    part's rows kept."""
    b, p = proposals.shape[:2]
    index, count = shard or (0, 1)
    noise = torch.rand((b * count, 2, p + gt_boxes.shape[1]),
                       generator=generator,
                       device=proposals.device)[index * b:(index + 1) * b]
    return sample_rois(noise, proposals, prop_mask, gt_boxes, gt_classes,
                       gt_mask, **kw)


def integral_labels(matched_class, max_iou, is_fg, thresholds
                    ) -> torch.Tensor:
    """Per-head labels of the integral loss (MultiPath §3.3): head k labels
    a sampled ROI with its matched class iff IoU >= threshold_k, else
    background. (..., S) inputs -> (..., S, K) int32."""
    thr = torch.tensor(thresholds, dtype=torch.float32, device=max_iou.device)
    fg_k = is_fg[..., None] & (max_iou[..., None] >= thr)
    return torch.where(fg_k, matched_class[..., None],
                       torch.zeros_like(matched_class[..., None])
                       ).to(torch.int32)
