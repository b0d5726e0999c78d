"""SharpMask proposal-network training — port of
multipathnet_tpu/train/proposal.py: the losses, the train step and
ProposalTrainer, on one device.

  - objectness: sigmoid BCE per anchor; positives are anchors at IoU >= 0.5
    with some GT plus each valid GT's best anchor, negatives IoU < 0.3, the
    rest ignored; positives and negatives weighted to equal halves.
  - boxes: smooth-L1 on positives against the matched GT.
  - masks: BCE of the decoded mask logits at the GT boxes against the
    rasterized instance masks (data/pipeline.py, with_masks=True).
  - the cascade: the refine head trains on the network's own top-16
    stage-1 decodes (no gradient through the selection) plus jittered GT
    boxes; jittered rows of padded GT are masked out.

One step, in the reference's order: resize to the canvas (rgb_unit, as
the reference's proposal step does whatever the preset's preprocess),
dense heads and masks in train mode ("direct" pools), the cascade's
ROIs, the loss, backward and one optimizer step (train/schedule.py) over
every parameter. Frozen BN statistics are buffers, so no step moves them
and no weight decay reaches them; a parameter the loss does not reach
(the c5 stage when the neck reads c4) gets a zero gradient, so weight
decay and momentum still move it, as optax's chain moves it in the
reference. The jitter's two normal draws come from the state's generator
(`jitter_draws`), shift first; the reference's random key cannot be
reproduced, so parity tests replace them.

On a mesh (`ProposalTrainer(cfg, mesh=...)`, or largest_data_mesh when
ranks were launched) each rank steps its rows of the global batch as
train/loop.py's Trainer does: the jitter is drawn at the global batch's
shape and cut to the rank's rows, every count the losses divide by is
summed over the data axis, the gradients (a parameter the loss does not
reach with its zero one) are summed in one fixed-order all-reduce, and
the metrics are the global ones on every rank.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from multipathnet_tpu_torch.core.config import Config
from multipathnet_tpu_torch.core.mesh import all_sum
from multipathnet_tpu_torch.core.device import HostToDevice, resolve_device
from multipathnet_tpu_torch.data import transforms
from multipathnet_tpu_torch.models.sharpmask import (STDS, SharpMaskNet,
                                                     build_sharpmask,
                                                     init_sharpmask_)
from multipathnet_tpu_torch.ops import boxes as box_ops
from multipathnet_tpu_torch.ops.nms import _top_k
from multipathnet_tpu_torch.train.loop import (BatchFeeder, TrainState,
                                               auto_mesh, batch_shard,
                                               optimizer_step)
from multipathnet_tpu_torch.train.losses import smooth_l1
from multipathnet_tpu_torch.train.schedule import (make_lr_schedule,
                                                   make_optimizer)


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy: -y log s(x) - (1 - y) log
    s(-x), elementwise."""
    return (-labels * F.logsigmoid(logits)
            - (1.0 - labels) * F.logsigmoid(-logits))


def _gather_boxes(gt_boxes: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """gt_boxes (B, G, 4), idx (B, N) -> (B, N, 4)."""
    return torch.gather(gt_boxes, 1, idx[..., None].expand(-1, -1, 4))


def _balanced_bce(logits, pos, neg, group=None):
    """(mean BCE over positives + mean BCE over negatives) / 2, labels =
    pos; -> (loss, positive count clamped at 1). The counts are summed
    over `group` (the data axis)."""
    bce = sigmoid_bce(logits, pos.float())
    n_pos = torch.clamp(all_sum(pos.sum().float(), group), min=1.0)
    n_neg = torch.clamp(all_sum(neg.sum().float(), group), min=1.0)
    return ((bce * pos).sum() / n_pos + (bce * neg).sum() / n_neg) / 2.0, \
        n_pos


def _match(rois, gt_boxes, gt_mask):
    """IoU of rois (B or 1, N, 4) against the valid GT (B, G, 4) -> (iou
    (B, N, G) with -1 at padded GT, best IoU (B, N), best GT (B, N), the
    lower GT first among ties)."""
    iou = box_ops.iou_matrix(rois, gt_boxes)
    iou = torch.where(gt_mask[:, None, :], iou, torch.full_like(iou, -1.0))
    return iou, iou.amax(-1), torch.argmax(iou, dim=-1)


def sharpmask_loss(anchors, scores, deltas, mask_logits, gt_boxes,
                   gt_mask, gt_masks, *, pos_iou=0.5, neg_iou=0.3,
                   ref_rois=None, ref_deltas=None, ref_logits=None,
                   ref_valid=None, ref_pos_iou=0.5, ref_neg_iou=0.4,
                   bbox_reg_stds=STDS, group=None):
    """Per-batch proposal losses -> (total, metrics). Shapes: anchors (N,
    4); scores (B, N); deltas (B, N, 4); mask_logits (B, G, M, M);
    gt_boxes (B, G, 4); gt_mask (B, G); gt_masks (B, G, M, M). The cascade
    terms (ref_rois (B, K, 4) the boxes the refine head saw, ref_deltas,
    ref_logits its outputs, ref_valid (B, K)) match per ROI with a tighter
    negative band (IoU < 0.4). Every count divided by is summed over
    `group`, the data axis's process group (None: this batch alone)."""
    iou, best_iou, best_gt = _match(anchors[None], gt_boxes, gt_mask)
    pos = best_iou >= pos_iou
    # every valid GT claims its best anchor (the lower anchor among ties)
    best_anchor = torch.argmax(iou, dim=1)                    # (B, G)
    claim = torch.zeros(pos.shape, dtype=torch.int32, device=pos.device)
    claim.scatter_reduce_(1, best_anchor, gt_mask.int(), "amax")
    pos = pos | claim.bool()
    neg = (best_iou < neg_iou) & ~pos
    obj_loss, n_pos = _balanced_bce(scores, pos, neg, group)

    targets = box_ops.encode(anchors[None], _gather_boxes(gt_boxes, best_gt),
                             stds=bbox_reg_stds)
    box_loss = (smooth_l1(deltas - targets).sum(-1) * pos).sum() / n_pos

    mask_bce = sigmoid_bce(mask_logits, gt_masks)
    g_valid = gt_mask.float()[..., None, None]
    mask_loss = (mask_bce * g_valid).sum() / torch.clamp(
        all_sum(g_valid.sum(), group) * mask_logits.shape[-1] ** 2, min=1.0)

    total = obj_loss + box_loss + mask_loss
    metrics = {"loss_obj": obj_loss, "loss_box": box_loss,
               "loss_mask": mask_loss, "num_pos_anchors": pos.sum()}

    if ref_rois is not None:
        _, best_r, best_rgt = _match(ref_rois, gt_boxes, gt_mask)
        if ref_valid is None:
            ref_valid = torch.ones(ref_rois.shape[:2], dtype=torch.bool,
                                   device=ref_rois.device)
        pos_r = (best_r >= ref_pos_iou) & ref_valid
        neg_r = (best_r < ref_neg_iou) & ref_valid
        ref_obj, np_r = _balanced_bce(ref_logits, pos_r, neg_r, group)
        targets_r = box_ops.encode(ref_rois, _gather_boxes(gt_boxes,
                                                           best_rgt),
                                   stds=bbox_reg_stds)
        ref_box = (smooth_l1(ref_deltas - targets_r).sum(-1)
                   * pos_r).sum() / np_r
        total = total + ref_obj + ref_box
        metrics.update(loss_ref_obj=ref_obj, loss_ref_box=ref_box,
                       num_pos_refine=pos_r.sum())

    metrics["loss"] = total
    return total, metrics


def jitter_draws(generator: torch.Generator, shape, device):
    """The step's two standard normal draws for the GT jitter, each of
    `shape` (B, G, 2): the center shift's, then the log-scale's."""
    shift = torch.randn(shape, generator=generator, device=device)
    scale = torch.randn(shape, generator=generator, device=device)
    return shift, scale


def jitter_boxes(gt_boxes, shift_noise, scale_noise, h, w):
    """GT boxes with their centers moved by 0.15 x (w, h) x shift_noise
    and their sides scaled by exp(0.2 x scale_noise), clipped."""
    wh = torch.clamp(gt_boxes[..., 2:4] - gt_boxes[..., 0:2], min=1.0)
    shift = shift_noise * 0.15 * wh
    scale = torch.exp(scale_noise * 0.2)
    c = (gt_boxes[..., 0:2] + gt_boxes[..., 2:4]) / 2.0 + shift
    half = wh * scale / 2.0
    return box_ops.clip(torch.cat([c - half, c + half], -1), float(h),
                        float(w))


def make_proposal_train_step(model: SharpMaskNet, cfg: Config,
                             refine_top_k: int = 16, mesh=None):
    """-> step(state, batch) -> (state, metrics): one optimizer step on
    the model's parameters, in place; each parameter keeps this step's
    gradient in `.grad`. On a mesh the batch is the rank's rows."""
    d = cfg.data
    h, w = d.image_size
    index, count = batch_shard(mesh) or (0, 1)
    group = mesh.data_group if mesh is not None else None

    def step(state: TrainState, batch):
        canvases, scales = transforms.batch_resize_to_canvas(
            batch.images, d.image_size, batch.src_hws)
        gt_boxes = batch.gt_boxes * scales[:, None, None]
        anchors, scores, deltas, feats = model.dense(canvases)
        mask_logits = model.decode_masks(feats, gt_boxes, (h, w),
                                         impl="direct")
        # the cascade's rois: the net's own top-K stage-1 decodes (no
        # gradient through the selection) + jittered GT boxes
        with torch.no_grad():
            _, idx = _top_k(scores, refine_top_k)
            b1 = box_ops.clip(box_ops.decode(
                anchors[idx], torch.gather(deltas, 1, idx[..., None].expand(
                    -1, -1, 4)), stds=STDS), float(h), float(w))
            b, g = gt_boxes.shape[:2]
            noise = [t[index * b:(index + 1) * b] for t in jitter_draws(
                state.generator, (b * count, g, 2), gt_boxes.device)]
            ref_rois = torch.cat([b1, jitter_boxes(gt_boxes, *noise, h, w)],
                                 dim=1)
            ref_valid = torch.cat([torch.ones(b1.shape[:2], dtype=torch.bool,
                                              device=b1.device),
                                   batch.gt_mask], dim=1)
        ref_deltas, ref_logits = model.refine_boxes(feats, ref_rois, (h, w),
                                                    impl="direct")
        loss, metrics = sharpmask_loss(
            anchors, scores, deltas, mask_logits, gt_boxes, batch.gt_mask,
            batch.gt_masks, ref_rois=ref_rois, ref_deltas=ref_deltas,
            ref_logits=ref_logits, ref_valid=ref_valid, group=group)
        metrics = optimizer_step(state.optimizer, loss, metrics, group,
                                 zero_missing=True)
        return TrainState(state.step + 1, state.optimizer,
                          state.generator), metrics

    return step


class ProposalTrainer(BatchFeeder):
    """Owns the proposal network (float32 parameters, compute in
    cfg.model.dtype) and its train step, on one device: the CUDA card
    unless the caller names another (device="cpu"), or the mesh's device
    (its data axis; the model axis replicates the network).

    As the reference: gradients are clipped by global norm 2.0 when lr >
    1e-2 and no clip is set (the dense-anchor BCE diverges above that rate
    unclipped; `train_cfg_effective` holds what the step uses), anchor
    scales are 0.12 / 0.25 / 0.5 / 0.8 of the canvas's short side, and the
    neck reads c4 below a 256-pixel canvas, c5 from there."""

    def __init__(self, cfg: Config, device=None, anchor_scales=None,
                 neck_level: str | None = None, mesh=None):
        self.cfg = cfg
        if cfg.train.grad_clip_norm <= 0 and cfg.train.lr > 1e-2:
            cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                        grad_clip_norm=2.0))
        self.train_cfg_effective = cfg.train
        size = min(cfg.data.image_size)
        if anchor_scales is None:
            anchor_scales = tuple(round(size * f, 1)
                                  for f in (0.12, 0.25, 0.5, 0.8))
        if neck_level is None:
            neck_level = "c4" if size < 256 else "c5"
        self.mesh = auto_mesh(cfg, mesh, device)
        self.device = (self.mesh.device if self.mesh is not None
                       else resolve_device(device))
        self.model = build_sharpmask(cfg.model, device=self.device,
                                     param_dtype=torch.float32,
                                     anchor_scales=anchor_scales,
                                     neck_level=neck_level)
        self._step = make_proposal_train_step(self.model, cfg,
                                              mesh=self.mesh)
        self.lr_schedule = make_lr_schedule(cfg.train)
        self._copy = HostToDevice(self.device)

    def init_state(self, seed: int | None = None) -> TrainState:
        """Draws the parameters (models/sharpmask.init_sharpmask_) and
        builds the optimizer over all of them; the step's generator is
        seeded with seed + 1."""
        seed = self.cfg.train.seed if seed is None else seed
        init_sharpmask_(self.model,
                        torch.Generator(self.device).manual_seed(seed))
        opt, _ = make_optimizer(self.train_cfg_effective,
                                self.model.parameters())
        return TrainState(0, opt,
                          torch.Generator(self.device).manual_seed(seed + 1))

    def step(self, state: TrainState, batch):
        """One optimizer step; returns (new state, metrics of 0-d
        tensors). The batch needs gt_masks (DetectionPipeline with
        with_masks=True)."""
        batch = self.put_batch(batch)
        if batch.gt_masks is None:
            raise ValueError("the proposal step needs gt_masks: build the "
                             "pipeline with with_masks=True")
        return self._step(state, batch)
