"""Training losses — port of multipathnet_tpu/train/losses.py: the integral
cross-entropy over K classifier heads (MultiPath §3.3) plus smooth-L1 box
regression on the positive ROIs (Fast R-CNN §2.3).

`integral_agg` "mean" divides the K heads' sum by K (the reference's
default), "sum" is the paper-literal L = sum_k CE_k. Every term is a masked
mean over the valid ROI slots, so padding never contributes. Under data
parallelism (`group`, the data axis's process group) the count of valid
slots is the whole batch's, summed over the ranks, so each rank's loss
and metrics are its share of the global ones and sum to them.
"""

from __future__ import annotations

import torch

from multipathnet_tpu_torch.core.mesh import all_sum
from multipathnet_tpu_torch.data.sampler import RoiSample, integral_labels


def smooth_l1(x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def detection_loss(scores: torch.Tensor,   # (B, S, K, C) f32 logits
                   deltas: torch.Tensor,   # (B, S, 4C) or (B, S, 4) f32
                   sample: RoiSample,      # batched (B, S, ...)
                   *, integral_thresholds, num_classes: int,
                   class_specific_bbox: bool = True,
                   bbox_loss_weight: float = 1.0,
                   integral_agg: str = "mean", group=None):
    """Returns (total loss, metrics dict of 0-d tensors)."""
    b, s, k, _ = scores.shape
    labels = integral_labels(sample.matched_class, sample.max_iou,
                             sample.is_fg, integral_thresholds)  # (B, S, K)
    valid = sample.valid.float()
    n_valid = torch.clamp(all_sum(valid.sum(), group), min=1.0)

    logp = torch.log_softmax(scores, dim=-1)
    ce = -torch.gather(logp, -1, labels[..., None].long())[..., 0]
    ce = (ce * valid[..., None]).sum(dim=(0, 1)) / n_valid  # per-head mean
    cls_loss = ce.sum() if integral_agg == "sum" else ce.mean()

    fg = (sample.is_fg & sample.valid).float()
    if class_specific_bbox:
        d = deltas.reshape(b, s, num_classes, 4)
        idx = sample.matched_class.long()[..., None, None].expand(b, s, 1, 4)
        d = torch.gather(d, 2, idx)[:, :, 0, :]
    else:
        d = deltas
    reg = smooth_l1(d - sample.bbox_targets).sum(-1)  # (B, S)
    # Fast R-CNN normalizes by the sampled ROI count, not the fg count
    bbox_loss = (reg * fg).sum() / n_valid

    # accuracy of head 0 (threshold 0.5) on valid slots, for monitoring
    pred0 = scores[..., 0, :].argmax(-1)
    acc0 = ((pred0 == labels[..., 0]).float() * valid).sum() / n_valid

    total = cls_loss + bbox_loss_weight * bbox_loss
    metrics = {
        "loss": total,
        "loss_cls": cls_loss,
        "loss_bbox": bbox_loss,
        "acc_head0": acc0,
        "num_fg": fg.sum(),
        "num_valid": valid.sum(),
    }
    for ki in range(k):
        metrics[f"loss_cls_h{ki}"] = ce[ki]
    return total, metrics
