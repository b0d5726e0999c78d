"""Detection path: (images, proposals) -> final boxes/scores/classes.

Port of multipathnet_tpu/eval/detect.py: resize + normalize, trunk, ROI
pooling through the window kernels, the heads, the mean of the K integral
softmaxes, delta decode and clip, then class-aware NMS — all on the model's
device, with only the fixed-size detection set copied back to the host.
The align route streams fixed windows, so all P proposals go through in
one pass (no chunking); roi_mode="max" pools in plain ops
(models/multipath.py). An int8 head (head_quant="int8") always takes the
quantized pool route: the head's skip bias, ReLU and per-view int8
quantization run in the pool kernels' epilogue, as the reference's
roi_impl="pallas" route does (the port has only the kernel route for
align).

`Detector` takes its weights as a flax-layout tree and transforms them at
load for a serving config, as the reference's Detector does
(`serving_params`): truncated-SVD factorization when the config has fc
ranks, then int8 quantization when it has head_quant="int8"; a tree
already in that form passes through.

On a mesh (core/mesh.py; `Detector(..., mesh=...)`) each rank detects its
rows of the batch, as the reference's shard_map over the data axis does,
and the detections are all-gathered, so every rank returns the whole
batch; the images are independent, so the split is exact. On a model
axis wider than one the head is tensor-parallel (models/heads.
shard_head_), which leaves the int8 head's outputs bit for bit the
unsharded ones.
"""

from __future__ import annotations

import torch

from multipathnet_tpu_torch.core.config import Config, ModelConfig
from multipathnet_tpu_torch.core.mesh import all_gather_cat
from multipathnet_tpu_torch.data import transforms
from multipathnet_tpu_torch.models import convert
from multipathnet_tpu_torch.models.heads import shard_head_
from multipathnet_tpu_torch.models.multipath import MultiPathNet
from multipathnet_tpu_torch.ops import boxes as box_ops
from multipathnet_tpu_torch.ops import lowrank, quant
from multipathnet_tpu_torch.ops import nms as nms_ops


@torch.inference_mode()
def score_batch(model: MultiPathNet, cfg: Config,
                images_u8: torch.Tensor,   # (B, H0, W0, 3) uint8, padded raw
                src_hws: torch.Tensor,     # (B, 2) valid (h, w) per image
                proposals: torch.Tensor):  # (B, P, 4) original image coords
    """Image + proposals -> per-class probabilities and decoded per-class
    boxes in original coordinates, before NMS.
    Returns (boxes (B, P, C, 4), probs (B, P, C))."""
    canvas_hw = cfg.data.image_size
    b, p = proposals.shape[:2]
    canvases, scales = transforms.batch_resize_to_canvas(
        images_u8, canvas_hw, src_hws, preprocess=cfg.model.preprocess)
    rois = proposals.to(torch.float32) * scales[:, None, None]

    feats = model.features(canvases)
    if cfg.model.head_quant == "int8":
        pooled, pooled_scale = model.pool_rois_quantized(
            feats, rois, canvas_hw, model.head.skip_bias)
        scores, deltas = model.predict_rois(pooled,
                                            pooled_scale=pooled_scale)
    else:
        scores, deltas = model.predict_rois(
            model.pool_rois(feats, rois, canvas_hw))

    # integral heads: average the K softmaxes (MultiPath §3.3 test protocol)
    probs = torch.softmax(scores, dim=-1).mean(dim=2)   # (B, P, C)
    num_classes = probs.shape[-1]

    m = cfg.model
    if m.class_specific_bbox:
        d = deltas.reshape(b, p, num_classes, 4)
    else:
        d = deltas[:, :, None, :].expand(b, p, num_classes, 4)
    boxes = box_ops.decode(rois[:, :, None, :], d, means=m.bbox_reg_means,
                           stds=m.bbox_reg_stds)
    # clip to each image's scaled valid extent, then back to original coords
    lim = src_hws.to(torch.float32) * scales[:, None]    # (B, 2) = (h, w)*s
    hi = torch.stack([lim[:, 1], lim[:, 0], lim[:, 1], lim[:, 0]], -1)
    boxes = torch.minimum(torch.clamp(boxes, min=0.0),
                          hi[:, None, None, :])
    return boxes / scales[:, None, None, None], probs


@torch.inference_mode()
def detect_batch(model: MultiPathNet, cfg: Config, images_u8, src_hws,
                 proposals, prop_mask: torch.Tensor) -> dict:
    """Batched detection: dict of (B, D, ...) tensors in ORIGINAL image
    coordinates (boxes, scores, classes with background = 0, indices,
    valid)."""
    boxes, probs = score_batch(model, cfg, images_u8, src_hws, proposals)
    # background column dropped; per-class NMS + global top-D per image
    out = nms_ops.multiclass_nms(
        boxes[:, :, 1:, :], probs[:, :, 1:], prop_mask.to(torch.bool),
        score_threshold=cfg.eval.score_threshold,
        iou_threshold=cfg.eval.nms_iou_threshold,
        pre_nms_per_class=cfg.eval.pre_nms_per_class,
        max_detections=cfg.eval.max_detections)
    out["classes"] = out["classes"] + 1  # back to contiguous labels (bg=0)
    return out


def serving_params(params, cfg: ModelConfig, svd_report: dict | None = None):
    """The load-time transforms of a flax-layout tree (numpy or torch
    leaves) for a serving config, in the reference's order: factorize the
    fc kernels of a full-rank float tree when the config has ranks (or
    check an already factored tree's ranks), then quantize a float head
    when head_quant="int8" (an int8 tree passes). Raises ValueError on an
    int8 tree under head_quant="none": no dequantizing route exists.
    `svd_report`, if a dict, receives each factorized kernel's relative
    truncation error."""
    if cfg.fc6_rank or cfg.fc7_rank:
        if lowrank.is_factored(params):
            lowrank.check_factored_ranks(params, cfg.fc6_rank, cfg.fc7_rank)
        else:
            params = lowrank.factorize_head_params(
                params, cfg.fc6_rank, cfg.fc7_rank, report=svd_report)
    if cfg.head_quant == "int8":
        if not quant.is_quantized(params):
            params = quant.quantize_head_params(params)
    elif quant.is_quantized(params):
        raise ValueError("params are already int8-quantized but the config "
                         "says head_quant='none'; re-export from the float "
                         "checkpoint")
    return params


class Detector:
    """User-facing wrapper: numpy or tensors in, numpy out, on one device.
    A tensor already on the detector's device with the dtype the path
    reads is used as it is, with no round trip through the host.

    `params`, a flax-layout tree (numpy or torch leaves; models/convert.py),
    goes through `serving_params` for cfg.model and into `model`, which must
    be built for cfg.model. Without it the model serves the weights it
    holds. The model is moved to `device` (by default its own, which
    build_model puts on the card; on a mesh, the mesh's) and put in eval
    mode. With a `mesh` the batch size must divide by its data width, and
    a model axis wider than one shards the head (module docstring).
    """

    def __init__(self, model: MultiPathNet, cfg: Config, device=None,
                 params=None, mesh=None):
        if params is not None:
            convert.load_flax_params(model, serving_params(params, cfg.model))
        if mesh is not None:
            device = mesh.device
        self.device = torch.device(device) if device is not None else (
            next(model.parameters()).device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None:
            shard_head_(self.model.head, mesh)

    def __call__(self, images_u8, src_hws, proposals, prop_mask) -> dict:
        """A batch (numpy or tensors) -> its detections as numpy arrays;
        on a mesh each rank detects its rows and returns the whole
        batch's."""
        rows = slice(None)
        if self.mesh is not None and self.mesh.n_data > 1:
            rows = self.mesh.rows(len(images_u8))
        return self.detect_rows(images_u8[rows], src_hws[rows],
                                proposals[rows], prop_mask[rows])

    def detect_rows(self, images_u8, src_hws, proposals, prop_mask) -> dict:
        """This rank's rows of a batch -> the whole batch's detections
        (all-gathered over the mesh's data axis), as numpy arrays."""
        def put(x, dtype):
            return torch.as_tensor(x, dtype=dtype, device=self.device)

        out = detect_batch(self.model, self.cfg,
                           put(images_u8, torch.uint8),
                           put(src_hws, torch.float32),
                           put(proposals, torch.float32),
                           put(prop_mask, torch.bool))
        if self.mesh is not None:
            out = {k: all_gather_cat(v, self.mesh.data_group)
                   for k, v in out.items()}
        return {k: v.cpu().numpy() for k, v in out.items()}
