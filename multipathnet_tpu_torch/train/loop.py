"""The training step and its owner — port of multipathnet_tpu/train/loop.py
on one device.

One step, in the reference's order: horizontal flip (torch.flip, then
torch.roll by w - w0 so the valid extent stays left-aligned), resize to the
canvas and scale the boxes, fg/bg ROI sampling (data/sampler.py), the
forward in train mode, `detection_loss`, backward, and one optimizer step
(train/schedule.py). Random draws come, in that order, from the state's
torch.Generator. Parameters are float32; the model computes in
`cfg.model.dtype`. Backbone stages 1..freeze_backbone_stages are frozen
as in the reference: the trunk detaches after them (stop_gradient), and
their parameters are left out of the optimizer, so they get neither an
update nor weight decay. The reference's mesh has no counterpart here:
data parallelism is ROADMAP A17.
"""

from __future__ import annotations

import copy
from typing import Any, NamedTuple

import torch

from multipathnet_tpu_torch.core.config import Config
from multipathnet_tpu_torch.core.device import HostToDevice, resolve_device
from multipathnet_tpu_torch.data import sampler as sampler_lib
from multipathnet_tpu_torch.data import transforms
from multipathnet_tpu_torch.models.multipath import (MultiPathNet,
                                                     build_model,
                                                     init_params_)
from multipathnet_tpu_torch.ops import boxes as box_ops
from multipathnet_tpu_torch.train.losses import detection_loss
from multipathnet_tpu_torch.train.schedule import (Optimizer,
                                                   make_lr_schedule,
                                                   make_optimizer)


class Batch(NamedTuple):
    """Host-assembled raw batch, all fixed shapes."""

    images: torch.Tensor      # (B, H0, W0, 3) uint8, padded raw canvas
    src_hws: torch.Tensor     # (B, 2) f32 valid extents
    proposals: torch.Tensor   # (B, P, 4) f32, original image coords
    prop_mask: torch.Tensor   # (B, P) bool
    gt_boxes: torch.Tensor    # (B, G, 4) f32, original image coords
    gt_classes: torch.Tensor  # (B, G) int32
    gt_mask: torch.Tensor     # (B, G) bool
    gt_masks: Any = None      # (B, G, M, M) f32 instance masks, for the
    #                           proposal net's training (ROADMAP A15)


# each field's dtype on the device
_BATCH_DTYPES = Batch(torch.uint8, torch.float32, torch.float32, torch.bool,
                     torch.float32, torch.int32, torch.bool, torch.float32)


class TrainState(NamedTuple):
    step: int
    optimizer: Optimizer
    generator: torch.Generator


def frozen_parameter_names(model: MultiPathNet, n_stages: int) -> set:
    """Names of the parameters of trunk stages 1..n_stages, from the
    backbone's `frozen_prefixes` table; a backbone without one raises
    rather than silently training everything."""
    if n_stages <= 0:
        return set()
    prefixes = getattr(type(model.backbone), "frozen_prefixes", None)
    if prefixes is None:
        raise ValueError(
            f"backbone {type(model.backbone).__name__} does not define "
            "frozen_prefixes(); set freeze_backbone_stages=0 or add the "
            "stage table to the backbone class")
    prefixes = prefixes(n_stages)
    return {f"backbone.{name}"
            for name, _ in model.backbone.named_parameters()
            if name.startswith(prefixes)}


def _hflip_images(images, widths, do_flip):
    """Flip each image whose do_flip is set within its valid width: the
    reference's roll(flip(img), w - w0) (truncating w - w0 to an int)."""
    w0 = images.shape[2]
    out = []
    for img, w, f in zip(images, widths.tolist(), do_flip):
        flipped = torch.roll(torch.flip(img, dims=(1,)), int(w - w0), dims=1)
        out.append(torch.where(f, flipped, img))
    return torch.stack(out)


def make_train_step(model: MultiPathNet, cfg: Config):
    """-> train_step(state, batch) -> (state, metrics). The step updates
    the model's parameters in place and leaves each trainable parameter's
    gradient of this step in its `.grad`."""
    m, d = cfg.model, cfg.data

    def train_step(state: TrainState, batch: Batch):
        gen = state.generator
        b = batch.images.shape[0]
        dev = batch.images.device
        do_flip = torch.rand(b, generator=gen, device=dev) < d.hflip_prob
        widths = batch.src_hws[:, 1]
        images = _hflip_images(batch.images, widths, do_flip)
        flip = do_flip[:, None, None]
        proposals = torch.where(
            flip, box_ops.hflip(batch.proposals, widths[:, None]),
            batch.proposals)
        gt_boxes = torch.where(
            flip, box_ops.hflip(batch.gt_boxes, widths[:, None]),
            batch.gt_boxes)

        canvases, scales = transforms.batch_resize_to_canvas(
            images, d.image_size, batch.src_hws, preprocess=m.preprocess)
        proposals = proposals * scales[:, None, None]
        gt_boxes = gt_boxes * scales[:, None, None]

        sample = sampler_lib.sample_batch(
            gen, proposals, batch.prop_mask, gt_boxes, batch.gt_classes,
            batch.gt_mask, rois_per_image=d.rois_per_image,
            fg_fraction=d.fg_fraction, fg_iou_threshold=d.fg_iou_threshold,
            bg_iou_range=d.bg_iou_range, bbox_reg_means=m.bbox_reg_means,
            bbox_reg_stds=m.bbox_reg_stds)

        scores, deltas = model(canvases, sample.rois, train=True,
                               generator=gen)
        loss, metrics = detection_loss(
            scores, deltas, sample,
            integral_thresholds=m.integral_thresholds,
            num_classes=m.num_classes,
            class_specific_bbox=m.class_specific_bbox,
            integral_agg=m.integral_loss_agg)
        state.optimizer.zero_grad()
        loss.backward()
        metrics["grad_norm"] = state.optimizer.step()
        metrics = {k: v.detach() for k, v in metrics.items()}
        return TrainState(state.step + 1, state.optimizer, gen), metrics

    return train_step


class Trainer:
    """Owns the model (float32 parameters, frozen stages excluded from the
    optimizer) and the train step, on one device: the CUDA card unless the
    caller names another (device="cpu")."""

    def __init__(self, cfg: Config, device=None):
        if cfg.model.head_quant != "none":
            raise ValueError(
                "training is float-only: set model.head_quant='none' and "
                "quantize the trained checkpoint at export")
        self.cfg = cfg
        self.device = resolve_device(device)
        n_frozen = cfg.train.freeze_backbone_stages
        self.model = build_model(cfg.model, freeze_stages=n_frozen,
                                 param_dtype=torch.float32,
                                 device=self.device)
        self.frozen = frozen_parameter_names(self.model, n_frozen)
        for name, p in self.model.named_parameters():
            p.requires_grad_(name not in self.frozen)
        self._step = make_train_step(self.model, cfg)
        self.lr_schedule = make_lr_schedule(cfg.train)
        self._copy = HostToDevice(self.device)

    def init_state(self, seed: int | None = None) -> TrainState:
        """Draws the parameters (models.multipath.init_params_) and builds
        the optimizer; the step's generator is seeded with seed + 1."""
        seed = self.cfg.train.seed if seed is None else seed
        init_params_(self.model,
                     torch.Generator(self.device).manual_seed(seed))
        opt, _ = make_optimizer(
            self.cfg.train,
            [p for p in self.model.parameters() if p.requires_grad])
        return TrainState(0, opt,
                          torch.Generator(self.device).manual_seed(seed + 1))

    def put_batch(self, batch) -> Batch:
        """numpy arrays or tensors -> a Batch on the trainer's device,
        copied synchronously (a batch already there is used as it is)."""
        return Batch(*(None if x is None
                       else torch.as_tensor(x, dtype=dt, device=self.device)
                       for x, dt in zip(batch, _BATCH_DTYPES)))

    def stream_batch(self, batch) -> Batch:
        """A host batch -> a Batch on the trainer's device, copied ahead of
        its use (core/device.HostToDevice: on the card from pinned memory on
        a side stream): the `put` of DetectionPipeline.epoch_on_device."""
        return Batch(*self._copy(batch, _BATCH_DTYPES))

    def step(self, state: TrainState, batch):
        """One optimizer step; returns (new state, metrics of 0-d
        tensors)."""
        return self._step(state, self.put_batch(batch))


def snapshot_train_state(trainer: Trainer, state: TrainState) -> dict:
    """A copy of what a step reads and changes: the parameters, the
    optimizer's momentum buffers and count, the step and the generator's
    state. restore_train_state puts it back, so a step can be repeated
    from one state."""
    return {"params": {n: p.detach().clone()
                       for n, p in trainer.model.named_parameters()},
            "sgd": copy.deepcopy(state.optimizer.sgd.state_dict()),
            "count": state.optimizer.count, "step": state.step,
            "optimizer": state.optimizer,
            "generator": state.generator.get_state()}


@torch.no_grad()
def restore_train_state(trainer: Trainer, saved: dict) -> TrainState:
    """Puts a snapshot_train_state back into the trainer's model and the
    snapshot's optimizer and generator; returns the state to step from."""
    for n, p in trainer.model.named_parameters():
        p.copy_(saved["params"][n])
    opt = saved["optimizer"]
    opt.sgd.load_state_dict(copy.deepcopy(saved["sgd"]))
    opt.count = saved["count"]
    gen = torch.Generator(trainer.device)
    gen.set_state(saved["generator"])
    return TrainState(saved["step"], opt, gen)
