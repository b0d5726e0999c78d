"""SharpMask-style proposal network — port of
multipathnet_tpu/models/sharpmask.py (BASELINE config 5's proposal source).

  - dense class-agnostic objectness over positions x anchor scales x
    aspects on the trunk (1x1 convolutions over a 3x3 neck),
  - a box regression per anchor,
  - a stage-2 box cascade: the top-K stage-1 boxes are pooled 7 x 7 on the
    neck and given a corrective delta and a quality logit,
  - a coarse 14 x 14 mask per ROI from the pooled neck (mask_fc),
    upsampled bilinearly to 28 x 28, and one refinement stage mixing in
    the c3 trunk features pooled at 28 x 28 (the "Sharp" in SharpMask),
  - `generate_proposals`: images -> top-K boxes, scores and masks on the
    model's device, ready for eval/detect.py.

The pools are plain PyTorch, as the reference computes them in XLA and not
in a Pallas kernel (its window kernels assert G <= 7): "pyramid" in eval,
the bilinear window sampler over each image's avg pyramid built at the
pool's own G (ops/roi_pyramid.batched_pyramid_roi_align), and "direct" in
training, the bilinear gather roi_align with a fixed-order backward
(ops/roi.batched_roi_align). Both take one sample per bin.

Layers compute in cfg.dtype from parameters stored in `param_dtype`
(float32 for training, as flax keeps them), each bias added after its
product (models/layers.py). Modules carry the flax tree's names (backbone,
neck, score, box, mask_fc, refine_conv, refine_out, box_refine_fc,
box_refine_delta, box_refine_logit), so models/convert.py carries the JAX
package's parameters across path for path. The trunk freezes nothing: the
reference's SharpMaskNet trains every stage. Top-k takes the lower anchor
first among equal scores, as lax.top_k does (ops/nms._top_k).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from multipathnet_tpu_torch.core.config import ModelConfig
from multipathnet_tpu_torch.core.device import resolve_device
from multipathnet_tpu_torch.data.transforms import _weight_mat
from multipathnet_tpu_torch.models import layers
from multipathnet_tpu_torch.models.backbones import get_backbone
from multipathnet_tpu_torch.models.multipath import _DTYPES, flax_init_
from multipathnet_tpu_torch.ops import boxes as box_ops
from multipathnet_tpu_torch.ops import roi as roi_ops
from multipathnet_tpu_torch.ops import roi_pyramid
from multipathnet_tpu_torch.ops.nms import _top_k

STDS = (0.1, 0.1, 0.2, 0.2)  # the anchor and cascade box encoding


def anchor_boxes(h: int, w: int, stride: int, scales: Tuple[float, ...],
                 aspects: Tuple[float, ...] = (1.0,),
                 device=None) -> torch.Tensor:
    """(H*W*A*R, 4) float32 anchors centered on each stride cell: per scale
    s and aspect a, width s*sqrt(a) x height s/sqrt(a), ordered cell,
    scale, aspect."""
    f32 = torch.float32
    ys = (torch.arange(h, device=device) + 0.5) * stride
    xs = (torch.arange(w, device=device) + 0.5) * stride
    cy, cx = torch.meshgrid(ys, xs, indexing="ij")
    centers = torch.stack([cx, cy], -1).reshape(-1, 1, 2)   # (HW, 1, 2)
    s = torch.tensor(scales, dtype=f32, device=device)[:, None]
    ra = torch.sqrt(torch.tensor(aspects, dtype=f32, device=device))[None]
    shape = (s.shape[0], ra.shape[1])
    wh = torch.stack([(s * ra).expand(shape), (s / ra).expand(shape)],
                     -1).reshape(1, -1, 2)                   # (1, S*R, 2)
    half = (wh / 2.0).expand(centers.shape[0], -1, -1)
    c = centers.expand_as(half)
    return torch.cat([c - half, c + half], -1).reshape(-1, 4)


def _pool_rois(fmap: torch.Tensor, rois: torch.Tensor, stride: int,
               size: int, impl: str) -> torch.Tensor:
    """(B, H, W, C) features, (B, K, 4) image-coordinate rois -> (B, K,
    size, size, C) float32, one sample per bin. impl="pyramid": the window
    sampler over each image's avg pyramid (eval); "direct": the gather
    roi_align (training)."""
    if impl == "pyramid":
        flat, meta = roi_pyramid.build_pyramid_batch(
            fmap.contiguous(), 1.0 / stride, output_size=size)
        return roi_pyramid.batched_pyramid_roi_align(
            flat, meta, rois, output_size=size, samples_per_bin=1)
    if impl != "direct":
        raise ValueError(f"impl must be pyramid|direct, got {impl!r}")
    return roi_ops.batched_roi_align(fmap, rois, output_size=size,
                                     spatial_scale=1.0 / stride,
                                     samples_per_bin=1)


def upsample_weights(n: int, m: int, device=None) -> torch.Tensor:
    """(m, n) float32 weights of jax.image.resize's "bilinear" from n to m
    cells (the triangle kernel, no widening when upsampling)."""
    scale = torch.tensor([m / n], dtype=torch.float32, device=device)
    return _weight_mat(n, m, scale)[0]


class SharpMaskNet(nn.Module):
    """Trunk + dense objectness/box heads + stage-2 box cascade + refined
    mask decoder, on `device` (the CUDA card unless the caller names
    another, device="cpu"; raises where there is no card); parameters in
    `param_dtype` (default the compute dtype cfg.dtype)."""

    def __init__(self, cfg: ModelConfig,
                 anchor_scales: Tuple[float, ...] = (48.0, 96.0, 192.0,
                                                     384.0),
                 anchor_aspects: Tuple[float, ...] = (0.5, 1.0, 2.0),
                 neck_level: str = "c5", mask_size: int = 28,
                 head_dim: int = 256, device=None, param_dtype=None):
        super().__init__()
        if cfg.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, "
                             f"got {cfg.dtype!r}")
        device = resolve_device(device)
        self.cfg = cfg
        self.anchor_scales = tuple(anchor_scales)
        self.anchor_aspects = tuple(anchor_aspects)
        self.neck_level = neck_level
        self.mask_size = mask_size
        self.dtype = dtype = _DTYPES[cfg.dtype]
        kw = dict(device=device, dtype=param_dtype or dtype)
        self.backbone = get_backbone(cfg.backbone, dtype, device=device,
                                     param_dtype=param_dtype)
        chans = self.backbone.feature_channels
        a = len(self.anchor_scales) * len(self.anchor_aspects)
        pooled = 7 * 7 * head_dim
        self.neck = nn.Conv2d(chans[neck_level], head_dim, 3, padding=1, **kw)
        self.score = nn.Conv2d(head_dim, a, 1, **kw)
        self.box = nn.Conv2d(head_dim, 4 * a, 1, **kw)
        self.mask_fc = nn.Linear(pooled, mask_size * mask_size // 4, **kw)
        self.refine_conv = nn.Conv2d(chans["c3"], 8, 3, padding=1, **kw)
        self.refine_out = nn.Conv2d(9, 1, 3, padding=1, **kw)
        self.box_refine_fc = nn.Linear(pooled, head_dim, **kw)
        self.box_refine_delta = nn.Linear(head_dim, 4, **kw)
        self.box_refine_logit = nn.Linear(head_dim, 1, **kw)

    def _conv(self, mod, x_nhwc: torch.Tensor) -> torch.Tensor:
        """mod on an NHWC map -> NHWC, in the compute dtype."""
        return layers.conv(mod, x_nhwc.permute(0, 3, 1, 2),
                           self.dtype).permute(0, 2, 3, 1)

    # -- dense heads -----------------------------------------------------
    def dense(self, images: torch.Tensor):
        """images (B, H, W, 3) normalized -> (anchors (N, 4), scores (B,
        N) f32, deltas (B, N, 4) f32, feats {c3, c4, c5, neck} NHWC)."""
        feats = dict(self.backbone(images))
        neck = F.relu(self._conv(self.neck, feats[self.neck_level]))
        b, fh, fw, _ = neck.shape
        stride = images.shape[1] // fh
        anchors = anchor_boxes(fh, fw, stride, self.anchor_scales,
                               self.anchor_aspects, device=images.device)
        scores = self._conv(self.score, neck).float().reshape(b, -1)
        deltas = self._conv(self.box, neck).float().reshape(b, -1, 4)
        feats["neck"] = neck
        return anchors, scores, deltas, feats

    # -- mask decoding for given rois ------------------------------------
    def decode_masks(self, feats: dict, rois: torch.Tensor, image_hw,
                     impl: str = "pyramid") -> torch.Tensor:
        """feats from dense(); rois (B, K, 4) -> mask logits (B, K, M, M)
        float32: mask_fc on the 7 x 7 neck pool (read channel-last, the
        flax flatten order), upsampled 14 -> 28 as jax.image.resize does,
        then refine_out over [coarse, relu(refine_conv(c3 pooled 28 x
        28))]."""
        m, half = self.mask_size, self.mask_size // 2
        b, k = rois.shape[:2]
        stride_neck = image_hw[0] // feats["neck"].shape[1]
        stride_c3 = image_hw[0] // feats["c3"].shape[1]
        coarse_feat = _pool_rois(feats["neck"], rois, stride_neck, 7, impl)
        coarse = layers.linear(self.mask_fc, coarse_feat.reshape(b * k, -1),
                               self.dtype).reshape(b * k, half, half)
        wts = upsample_weights(half, m, rois.device).to(coarse.dtype)
        coarse = torch.einsum("nyx,py->npx", coarse, wts)
        coarse = torch.einsum("npx,qx->npq", coarse, wts)[..., None]
        fine = _pool_rois(feats["c3"], rois, stride_c3, m, impl)
        r = F.relu(self._conv(self.refine_conv, fine.reshape(b * k, m, m, -1)))
        out = self._conv(self.refine_out,
                         torch.cat([coarse.to(r.dtype), r], dim=-1))
        return out.float().reshape(b, k, m, m)

    # -- stage-2 box cascade ---------------------------------------------
    def refine_boxes(self, feats: dict, rois: torch.Tensor, image_hw,
                     impl: str = "pyramid"):
        """feats from dense(); rois (B, K, 4) stage-1 boxes in image coords
        -> (deltas (B, K, 4) f32, quality logits (B, K) f32)."""
        b, k = rois.shape[:2]
        stride = image_hw[0] // feats["neck"].shape[1]
        pooled = _pool_rois(feats["neck"], rois, stride, 7, impl)
        x = F.relu(layers.linear(self.box_refine_fc,
                                 pooled.reshape(b * k, -1), self.dtype))
        deltas = layers.linear(self.box_refine_delta, x, self.dtype).float()
        logits = layers.linear(self.box_refine_logit, x, self.dtype).float()
        return deltas.reshape(b, k, 4), logits.reshape(b, k)

    def forward(self, images: torch.Tensor, rois: torch.Tensor,
                train: bool = False):
        """The training contract: dense heads everywhere, the cascade and
        masks for the given rois ("direct" pools in train, "pyramid" in
        eval)."""
        anchors, scores, deltas, feats = self.dense(images)
        impl = "direct" if train else "pyramid"
        hw = images.shape[1:3]
        masks = self.decode_masks(feats, rois, hw, impl=impl)
        return anchors, scores, deltas, masks, self.refine_boxes(
            feats, rois, hw, impl=impl)


def build_sharpmask(cfg: ModelConfig, device=None, param_dtype=None,
                    **kw) -> SharpMaskNet:
    """SharpMaskNet for cfg on `device` (the card unless the caller names
    another), as build_model builds the detector. `kw`: anchor_scales,
    anchor_aspects, neck_level, mask_size, head_dim."""
    return SharpMaskNet(cfg, device=device, param_dtype=param_dtype, **kw)


@torch.no_grad()
def init_sharpmask_(model: SharpMaskNet, generator: torch.Generator):
    """flax's initializers, drawn from `generator`: models/multipath.
    flax_init_, then the box and box_refine_delta kernels normal * 1e-3
    (their kernel_init in the reference)."""
    flax_init_(model, generator)
    for mod in (model.box, model.box_refine_delta):
        w = mod.weight
        w.copy_(torch.randn(w.shape, generator=generator,
                            device=w.device) * 1e-3)
    return model


@torch.no_grad()
def generate_proposals(model: SharpMaskNet, images: torch.Tensor, *,
                       top_k: int = 256, with_masks: bool = True,
                       refine: bool = True, score_activation=torch.sigmoid
                       ) -> dict:
    """images (B, H, W, 3) normalized -> {"boxes" (B, K, 4) decoded and
    clipped, "scores" (B, K), "masks" (B, K, M, M) sigmoid (omitted when
    with_masks=False)}, on the model's device (images elsewhere are copied
    there).

    refine=True runs the cascade: the top-K stage-1 boxes are pooled again
    and corrected (refine_boxes), and the score is the geometric mean of
    the stage-1 and stage-2 probabilities. Masks are decoded at the
    refined boxes."""
    h, w = images.shape[1:3]
    images = images.to(next(model.parameters()).device)
    anchors, scores, deltas, feats = model.dense(images)
    s, idx = _top_k(scores, top_k)                              # (B, K)
    sel_deltas = torch.gather(deltas, 1, idx[..., None].expand(-1, -1, 4))
    boxes = box_ops.clip(box_ops.decode(anchors[idx], sel_deltas,
                                        stds=STDS), float(h), float(w))
    prob = score_activation(s)
    if refine:
        ref_deltas, ref_logits = model.refine_boxes(feats, boxes, (h, w))
        boxes = box_ops.clip(box_ops.decode(boxes, ref_deltas, stds=STDS),
                             float(h), float(w))
        prob = torch.sqrt(prob * torch.sigmoid(ref_logits))
    out = {"boxes": boxes, "scores": prob}
    if with_masks:
        out["masks"] = torch.sigmoid(model.decode_masks(feats, boxes,
                                                        (h, w)))
    return out
