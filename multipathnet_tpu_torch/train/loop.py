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
update nor weight decay. Frozen BatchNorm's running statistics are
buffers, never parameters, so no step moves them either.

On a mesh (core/mesh.py; `Trainer(cfg, mesh=...)`, or the reference's
auto rule `largest_data_mesh` when ranks were launched and no mesh is
given) each rank steps its rows of the global batch. Every random draw is
made at the global batch's shape from a generator seeded alike on every
rank, and each rank keeps its rows (and, in a sharded head, its columns),
so the step draws what one process draws for the whole batch. The loss's
denominators are global (train/losses.py), the trainable gradients are
summed over the data axis in one fixed-order all-reduce, and the metrics
are the global ones on every rank. On a model axis wider than one the
head is tensor-parallel (models/heads.shard_head_). With no mesh, or a 1 x
1 one, the step is the one-device step, draw for draw.

`Trainer.step` is the root span "train.step" (utils/profiling): its
children are train.put (the batch's copy), train.augment (flip, resize,
box scaling), train.sample, the model's features, pool_rois and
predict_rois, train.loss, train.backward (with the pool's backward,
pool_rois.backward, and a ResNet trunk's training stages' backward,
features.stageN.backward, under it, on whatever thread autograd runs
them) and train.optimizer (`Optimizer.step`, the gradient norm included).

On the card, off a mesh, a Trainer runs a ResNet trunk's training stages
as CUDA graphs of their forward and backward (`stage_graphs`,
models/backbones/resnet.StageGraphs), opened around each step, whose one
forward and one backward are what a graph's buffers allow. Nothing else
that calls the model graphs it (a forward outside a step runs eagerly),
nor does a mesh's step, on which they were never measured.
"""

from __future__ import annotations

import copy
from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from multipathnet_tpu_torch.core import mesh as mesh_lib
from multipathnet_tpu_torch.core.config import Config
from multipathnet_tpu_torch.core.device import (HostToDevice, put,
                                                resolve_device)
from multipathnet_tpu_torch.data import sampler as sampler_lib
from multipathnet_tpu_torch.data import transforms
from multipathnet_tpu_torch.models.backbones.resnet import (ResNet,
                                                            StageGraphs)
from multipathnet_tpu_torch.models.heads import shard_head_, tp_dims
from multipathnet_tpu_torch.models.multipath import (MultiPathNet,
                                                     build_model,
                                                     init_params_)
from multipathnet_tpu_torch.ops import boxes as box_ops
from multipathnet_tpu_torch.train.losses import detection_loss
from multipathnet_tpu_torch.train.schedule import (Optimizer,
                                                   make_lr_schedule,
                                                   make_optimizer)
from multipathnet_tpu_torch.utils import profiling


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
    #                           proposal net's training (train/proposal.py)


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
    profiling.count_sync("hflip_widths", widths.device)
    for img, w, f in zip(images, widths.tolist(), do_flip):
        flipped = torch.roll(torch.flip(img, dims=(1,)), int(w - w0), dims=1)
        out.append(torch.where(f, flipped, img))
    return torch.stack(out)


def batch_shard(mesh):
    """(index, count) of a rank's rows of the global batch; None off a
    data-parallel mesh."""
    if mesh is None or mesh.n_data == 1:
        return None
    return mesh.data_rank, mesh.n_data


def stage_graphs(model: MultiPathNet, mesh=None):
    """The StageGraphs of the model's trunk where the step graphs it: a
    ResNet trunk on the card, off a mesh; else None."""
    trunk = model.backbone
    if (mesh is not None or not isinstance(trunk, ResNet)
            or trunk.stem.weight.device.type != "cuda"):
        return None
    return StageGraphs(trunk)


def make_train_step(model: MultiPathNet, cfg: Config, mesh=None,
                    graphs: StageGraphs | None = None):
    """-> train_step(state, batch) -> (state, metrics). The step updates
    the model's parameters in place and leaves each trainable parameter's
    gradient of this step in its `.grad` (summed over the mesh's data
    axis). On a mesh the batch is the rank's rows of the global batch.
    With `graphs` (stage_graphs) the step is one of theirs."""
    m, d = cfg.model, cfg.data
    shard = batch_shard(mesh)
    index, count = shard or (0, 1)
    group = mesh.data_group if mesh is not None else None

    def train_step(state: TrainState, batch: Batch):
        gen = state.generator
        b = batch.images.shape[0]
        dev = batch.images.device
        with profiling.span("train.augment"):
            do_flip = (torch.rand(b * count, generator=gen, device=dev)
                       < d.hflip_prob)[index * b:(index + 1) * b]
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

        with profiling.span("train.sample"):
            sample = sampler_lib.sample_batch(
                gen, proposals, batch.prop_mask, gt_boxes, batch.gt_classes,
                batch.gt_mask, rois_per_image=d.rois_per_image,
                fg_fraction=d.fg_fraction,
                fg_iou_threshold=d.fg_iou_threshold,
                bg_iou_range=d.bg_iou_range, bbox_reg_means=m.bbox_reg_means,
                bbox_reg_stds=m.bbox_reg_stds, shard=shard)

        scores, deltas = model(canvases, sample.rois, train=True,
                               generator=gen, shard=shard)
        with profiling.span("train.loss"):
            loss, metrics = detection_loss(
                scores, deltas, sample,
                integral_thresholds=m.integral_thresholds,
                num_classes=m.num_classes,
                class_specific_bbox=m.class_specific_bbox,
                integral_agg=m.integral_loss_agg, group=group)
        return TrainState(state.step + 1, state.optimizer, gen), \
            optimizer_step(state.optimizer, loss, metrics, group)

    if graphs is None:
        return train_step

    def graphed_step(state: TrainState, batch: Batch):
        with graphs.step():
            return train_step(state, batch)

    return graphed_step


def optimizer_step(opt, loss, metrics: dict, group, zero_missing=False):
    """Backward of `loss`, the gradients summed over `group` (the data
    axis), one optimizer step -> the metrics, summed over the group, with
    the global gradient norm. zero_missing: a parameter the loss does not
    reach gets a zero gradient (weight decay and momentum still move it)."""
    opt.zero_grad()
    with profiling.span("train.backward", adopt=True):
        loss.backward()
    if zero_missing:
        for p in opt.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
    mesh_lib.all_sum_grads_(opt.params, group)
    metrics = mesh_lib.sum_metrics(
        {k: v.detach() for k, v in metrics.items()}, group)
    with profiling.span("train.optimizer"):
        metrics["grad_norm"] = opt.step()
    return metrics



class BatchFeeder:
    """Puts host batches on `self.device` (a trainer's, with `self._copy`
    a core/device.HostToDevice for it). On a data-parallel `self.mesh` a
    batch of cfg.train.batch_size rows (the global batch) is cut to this
    rank's rows before the copy; a batch of that over the data width is
    taken as the rank's rows already (DetectionPipeline(shard=...))."""

    mesh = None

    def _rows(self, batch):
        shard = batch_shard(self.mesh)
        if shard is None:
            return batch
        n, width = len(batch[0]), self.mesh.n_data
        total = self.cfg.train.batch_size
        if n * width == total:
            return batch
        if n != total:
            raise ValueError(f"a batch of {n} rows is neither the global "
                             f"batch ({total}) nor a rank's rows of it on "
                             f"a {width}-wide data axis")
        rows = self.mesh.rows(n)
        return type(batch)(*(None if x is None else x[rows] for x in batch))

    def put_batch(self, batch) -> Batch:
        """numpy arrays or tensors -> a Batch on the trainer's device,
        copied synchronously (a batch already there is used as it is)."""
        return Batch(*(None if x is None else put(x, dt, self.device)
                       for x, dt in zip(self._rows(batch), _BATCH_DTYPES)))

    def stream_batch(self, batch) -> Batch:
        """A host batch -> a Batch on the trainer's device, copied ahead of
        its use (core/device.HostToDevice: on the card from pinned memory on
        a side stream): the `put` of DetectionPipeline.epoch_on_device."""
        return Batch(*self._copy(self._rows(batch), _BATCH_DTYPES))


def auto_mesh(cfg: Config, mesh, device):
    """The mesh a trainer runs on: `mesh`; else, when ranks were launched
    (an initialized process group), the reference's rule
    largest_data_mesh(batch size); else None (one device). A rank left
    out of the auto mesh raises."""
    if mesh is not None or not (dist.is_available()
                                and dist.is_initialized()):
        return mesh
    mesh = mesh_lib.largest_data_mesh(cfg.train.batch_size, device=device)
    if mesh is None:
        raise RuntimeError(
            f"rank {dist.get_rank()} is outside the data mesh for batch "
            f"{cfg.train.batch_size}; launch as many ranks as divide it")
    return mesh


def shard_state_dict(sd: dict, dims: dict, mesh) -> dict:
    """Each tensor of a whole state dict cut to this rank's part where
    `dims` names the dimension the model axis shards."""
    out = {}
    for k, v in sd.items():
        if k in dims:
            part = mesh.cols(v.shape[dims[k]])
            v = v.narrow(dims[k], part.start, part.stop - part.start)
        out[k] = v
    return out


def gather_state_dict(sd: dict, dims: dict, mesh) -> dict:
    """The whole tensors of a rank's state dict: each sharded one
    all-gathered over the model axis (collective)."""
    return {k: (mesh_lib.all_gather_cat(v.contiguous(), mesh.model_group,
                                        dims[k]) if k in dims else v)
            for k, v in sd.items()}


class Trainer(BatchFeeder):
    """Owns the model (float32 parameters, frozen stages excluded from the
    optimizer) and the train step, on one device: the CUDA card unless the
    caller names another (device="cpu"), or the mesh's device (module
    docstring). `tp_dims` names the head's tensors that a model axis
    wider than one shards (state-dict name -> dimension)."""

    def __init__(self, cfg: Config, device=None, mesh=None):
        if cfg.model.head_quant != "none":
            raise ValueError(
                "training is float-only: set model.head_quant='none' and "
                "quantize the trained checkpoint at export")
        self.cfg = cfg
        self.mesh = auto_mesh(cfg, mesh, device)
        self.device = (self.mesh.device if self.mesh is not None
                       else resolve_device(device))
        n_frozen = cfg.train.freeze_backbone_stages
        self.model = self.build_whole_model()
        self.frozen = frozen_parameter_names(self.model, n_frozen)
        for name, p in self.model.named_parameters():
            p.requires_grad_(name not in self.frozen)
        self.tp_dims = {}
        if self.mesh is not None:
            shard_head_(self.model.head, self.mesh)
            self.tp_dims = {f"head.{k}": v
                            for k, v in tp_dims(self.model.head).items()}
        self.graphs = stage_graphs(self.model, self.mesh)
        self._step = make_train_step(self.model, cfg, self.mesh,
                                     self.graphs)
        self.lr_schedule = make_lr_schedule(cfg.train)
        self._copy = HostToDevice(self.device)

    def build_whole_model(self) -> MultiPathNet:
        """A new model of the trainer's config on its device, unsharded
        (float32 parameters)."""
        return build_model(self.cfg.model,
                           freeze_stages=self.cfg.train.freeze_backbone_stages,
                           param_dtype=torch.float32, device=self.device)

    def load_full_state_dict(self, sd: dict) -> None:
        """Loads a whole (unsharded) state dict, each sharded tensor cut to
        this rank's part."""
        self.model.load_state_dict(shard_state_dict(sd, self.tp_dims,
                                                    self.mesh))

    def full_state_dict(self) -> dict:
        """The model's state dict with the sharded tensors gathered whole
        (collective on a tensor-parallel mesh)."""
        sd = self.model.state_dict()
        return gather_state_dict(sd, self.tp_dims, self.mesh) \
            if self.tp_dims else sd

    def init_state(self, seed: int | None = None) -> TrainState:
        """Draws the parameters (models.multipath.init_params_; with a
        sharded head, drawn whole and cut, so every mesh starts from the
        same weights) and builds the optimizer; the step's generator is
        seeded with seed + 1."""
        seed = self.cfg.train.seed if seed is None else seed
        gen = torch.Generator(self.device).manual_seed(seed)
        if self.tp_dims:
            full = self.build_whole_model()
            init_params_(full, gen)
            self.load_full_state_dict(full.state_dict())
            del full
        else:
            init_params_(self.model, gen)
        named = dict(self.model.named_parameters())
        opt, _ = make_optimizer(
            self.cfg.train,
            [p for p in self.model.parameters() if p.requires_grad],
            sharded=[named[n] for n in self.tp_dims if n in named],
            group=self.mesh.model_group if self.mesh is not None else None)
        return TrainState(0, opt,
                          torch.Generator(self.device).manual_seed(seed + 1))

    @profiling.span("train.step")
    def step(self, state: TrainState, batch):
        """One optimizer step; returns (new state, metrics of 0-d
        tensors)."""
        with profiling.span("train.put"):
            batch = self.put_batch(batch)
        return self._step(state, batch)


def snapshot_train_state(trainer, state: TrainState) -> dict:
    """A copy of what a step reads and changes on this rank (its parts of
    a sharded head): the parameters and buffers
    (frozen BN statistics), the optimizer's momentum buffers and count,
    the step and the generator's state. restore_train_state puts it back,
    so a step can be repeated from one state. `trainer` is a Trainer or a
    train/proposal.ProposalTrainer (anything with .model and .device)."""
    return {"params": {n: p.detach().clone()
                       for n, p in trainer.model.named_parameters()},
            "buffers": {n: b.detach().clone()
                        for n, b in trainer.model.named_buffers()},
            "sgd": copy.deepcopy(state.optimizer.sgd.state_dict()),
            "count": state.optimizer.count, "step": state.step,
            "optimizer": state.optimizer,
            "generator": state.generator.get_state()}


@torch.no_grad()
def restore_train_state(trainer, saved: dict) -> TrainState:
    """Puts a snapshot_train_state back into the trainer's model and the
    snapshot's optimizer and generator; returns the state to step from."""
    for n, p in trainer.model.named_parameters():
        p.copy_(saved["params"][n])
    for n, b in trainer.model.named_buffers():
        b.copy_(saved["buffers"][n])
    opt = saved["optimizer"]
    opt.sgd.load_state_dict(copy.deepcopy(saved["sgd"]))
    opt.count = saved["count"]
    gen = torch.Generator(trainer.device)
    if isinstance(saved["generator"], int):
        # a seed, as tools/convert_orbax_checkpoint.py writes for the
        # reference's PRNG key, which has no torch generator state
        gen.manual_seed(saved["generator"])
    else:
        gen.set_state(saved["generator"])
    return TrainState(saved["step"], opt, gen)
