"""MultiPathNet assembly — port of multipathnet_tpu/models/multipath.py on
its align path: trunk, per-level 1x1 skip reduction, foveal views pooled
through the CUDA window kernels, and the head.

Pooling follows the reference's view x level plan. In the "reference"
topology, group 1 (the 1x view over every skip level) goes to K1
(roi_pool.window_pool_multi) and group 2 (the context views over the last
level) to K2 (roi_pool.resident_pool). In training every group goes through
the differentiable K1 (roi_pool.WindowPoolMulti), one level for group 2, as
the reference's `not train` guard routes it. The TPU-only parts of the
reference are gone: C is not padded to the TPU's 128 lanes (only to a
multiple of 8 for the bf16 kernels, whose TMA strides are 16-byte units,
with zero bias on the pad lanes, as the reference pads), and every
single-level eval group goes to K2 whatever its pyramid's size (the
reference's 4 MB VMEM budget has no counterpart here).

Parameters are stored in `param_dtype` (float32 for training, as flax keeps
them) and cast to the compute dtype `cfg.dtype` at each call; an eval model
stores them in the compute dtype.

Serving (`head_quant="int8"`, `fc6_rank`/`fc7_rank`) builds the int8 and
factored head (models/heads.py); its weights come from the load-time
transforms of a float tree (eval/detect.serving_params). An int8 model
pools through `pool_rois_quantized`: the head's skip bias, ReLU and the
per-view int8 quantization run in the pool kernels' epilogue.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multipathnet_tpu_torch.core.config import ModelConfig
from multipathnet_tpu_torch.core.device import resolve_device
from multipathnet_tpu_torch.models import layers
from multipathnet_tpu_torch.models.backbones import get_backbone
from multipathnet_tpu_torch.models.heads import MultiPathHead
from multipathnet_tpu_torch.ops import boxes as box_ops
from multipathnet_tpu_torch.ops import roi_pool, roi_pyramid

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for model options the port does not run
    yet, naming the ROADMAP item that ports each."""
    if cfg.roi_mode != "align":
        raise NotImplementedError(
            f"roi_mode={cfg.roi_mode!r} is not ported yet (ROADMAP A14)")
    if cfg.preprocess != "rgb_unit":
        raise NotImplementedError(
            f"preprocess={cfg.preprocess!r} is not ported yet (ROADMAP A14)")
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, "
                         f"got {cfg.dtype!r}")


class MultiPathNet(nn.Module):
    """MultiPath detector. `cfg.roi_impl` and `cfg.train_roi_impl` are not
    read: the port has one ROI route, the window kernels (their plain
    versions on CPU). `freeze_stages` stops the gradient after trunk stage
    N; it leaves the parameters as they are, so checkpoints interchange."""

    def __init__(self, cfg: ModelConfig, device=None, freeze_stages: int = 0,
                 param_dtype=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dtype = _DTYPES[cfg.dtype]
        self.dtype = dtype
        param_dtype = param_dtype or dtype
        self.backbone = get_backbone(cfg.backbone, dtype, device=device,
                                     freeze_stages=freeze_stages,
                                     param_dtype=param_dtype)
        for lv in cfg.skip_levels:
            # ION-style 1x1 reduction per level, no bias: pooling is linear,
            # so sum_l pool(W_l f_l) == reduce(concat_l pool(f_l)); the
            # shared bias + ReLU live in the head.
            self.add_module(f"reduce_{lv}", nn.Conv2d(
                self.backbone.feature_channels[lv], cfg.skip_reduce_dim, 1,
                bias=False, device=device, dtype=param_dtype))
        self.head = MultiPathHead(
            num_classes=cfg.num_classes,
            foveal_scales=cfg.foveal_scales,
            num_integral_heads=len(cfg.integral_thresholds),
            fc_dim=cfg.fc_dim,
            skip_reduce_dim=cfg.skip_reduce_dim,
            roi_output_size=cfg.roi_output_size,
            class_specific_bbox=cfg.class_specific_bbox,
            dtype=dtype, device=device, param_dtype=param_dtype,
            quant=cfg.head_quant, fc6_rank=cfg.fc6_rank,
            fc7_rank=cfg.fc7_rank)

    def features(self, images: torch.Tensor) -> dict:
        """images (B, H, W, 3) normalized float -> {level: (B, Hl, Wl, C)}
        NHWC, each 1x1-reduced to skip_reduce_dim channels."""
        feats = self.backbone(images)
        out = {}
        for lv in self.cfg.skip_levels:
            x = feats[lv].permute(0, 3, 1, 2)  # NCHW view of the NHWC tap
            out[lv] = layers.conv(getattr(self, f"reduce_{lv}"), x,
                                  self.dtype).permute(0, 2, 3, 1)
        return out

    def _view_level_plan(self):
        """-> [(foveal factors, levels)] in foveal order. "reference": the
        1x view pools all skip levels, the context views the last level;
        "dense": every view pools every level."""
        fs, ls = self.cfg.foveal_scales, self.cfg.skip_levels
        if (self.cfg.foveal_topology == "dense" or len(fs) == 1
                or len(ls) == 1):
            return [(fs, ls)]
        if self.cfg.foveal_topology != "reference":
            raise ValueError(
                f"unknown foveal_topology {self.cfg.foveal_topology!r}")
        return [((fs[0],), ls), (tuple(fs[1:]), (ls[-1],))]

    def pool_rois(self, feats: dict, rois: torch.Tensor, image_hw,
                  train: bool = False, quant_bias=None):
        """feats: level -> (B, Hl, Wl, C); rois (B, R, 4) image coords ->
        (B, F, R, G, G, C) in the trunk dtype. `train` sends every group
        through the differentiable K1. With `quant_bias` (the head's skip
        bias in its dtype; eval only) the kernels' int8 epilogue runs:
        returns (int8 (B, F, R, G, G, C), float32 scales (B, F, R, 1))."""
        b, r = rois.shape[:2]
        g = self.cfg.roi_output_size
        s = self.cfg.roi_samples_per_bin
        strides = self.backbone.feature_strides
        first = feats[self.cfg.skip_levels[0]]
        c = first.shape[-1]
        # the bf16 kernels take C % 8 == 0: zero pad lanes, sliced off below
        # (exact: a zero lane pools to zero, and with a zero bias its int8
        # code is 0 and it leaves the view's amax as it is)
        pad = (-c) % 8 if first.dtype == torch.bfloat16 else 0
        if pad:
            feats = {lv: F.pad(feats[lv], (0, pad))
                     for lv in self.cfg.skip_levels}
            if quant_bias is not None:
                quant_bias = F.pad(quant_bias, (0, pad))
        pyramids = {
            lv: roi_pyramid.build_pyramid_batch(
                feats[lv].contiguous(), 1.0 / strides[lv], output_size=g)
            for lv in self.cfg.skip_levels}
        outs, scales = [], []
        for factors, levels in self._view_level_plan():
            nf = len(factors)
            views = torch.stack(
                [box_ops.expand(rois, f, image_hw[0], image_hw[1])
                 for f in factors], dim=1).reshape(-1, 4)  # (B*nf*R, 4)
            if len(levels) == 1 and not train:
                flat, meta = pyramids[levels[0]]
                out = roi_pool.batched_pyramid_pool_resident(
                    flat, meta, views, b, output_size=g, samples_per_bin=s,
                    quant_bias=quant_bias)
            else:
                img_idx = torch.arange(
                    b, dtype=torch.int32,
                    device=rois.device).repeat_interleave(nf * r)
                out = roi_pool.batched_pyramid_pool_multi(
                    [pyramids[lv][0] for lv in levels],
                    [pyramids[lv][1] for lv in levels],
                    views, img_idx, output_size=g, samples_per_bin=s,
                    trainable=train, quant_bias=quant_bias)
            if quant_bias is not None:
                out, scale = out
                scales.append(scale.reshape(b, nf, r, 1))
            outs.append(out.reshape(b, nf, r, g, g, c + pad)[..., :c])
        if quant_bias is not None:
            return torch.cat(outs, dim=1), torch.cat(scales, dim=1)
        return torch.cat(outs, dim=1)

    def pool_rois_quantized(self, feats: dict, rois: torch.Tensor, image_hw,
                            skip_bias: torch.Tensor):
        """Eval pooling with the int8 head's input stage in the kernels'
        epilogue (head_quant="int8"): the skip bias in the head dtype, ReLU
        and one int8 scale per (image, view, ROI). Returns (pooled int8
        (B, F, R, G, G, C), scales (B, F, R, 1) float32) for predict_rois.
        """
        return self.pool_rois(feats, rois, image_hw, train=False,
                              quant_bias=skip_bias.to(self.head.dtype))

    def predict_rois(self, pooled: torch.Tensor, train: bool = False,
                     generator: torch.Generator | None = None,
                     pooled_scale: torch.Tensor | None = None):
        """pooled (B, F, R, G, G, C) -> scores (B, R, K, classes) f32,
        deltas (B, R, D) f32. `generator` draws the train-mode dropout;
        `pooled_scale` goes with the int8 output of pool_rois_quantized."""
        b, r = pooled.shape[0], pooled.shape[2]
        scores, deltas = self.head(pooled, train=train, generator=generator,
                                   pooled_scale=pooled_scale)
        return (scores.reshape(b, r, scores.shape[1], -1),
                deltas.reshape(b, r, -1))

    def forward(self, images: torch.Tensor, rois: torch.Tensor,
                train: bool = False,
                generator: torch.Generator | None = None):
        """{images (B, H, W, 3), rois (B, R, 4)} -> (class_scores,
        bbox_deltas), the reference's contract."""
        feats = self.features(images)
        pooled = self.pool_rois(feats, rois, images.shape[1:3], train=train)
        return self.predict_rois(pooled, train=train, generator=generator)


def build_model(cfg: ModelConfig, freeze_stages: int = 0, param_dtype=None,
                device=None) -> MultiPathNet:
    """The model for `cfg` on `device`: the CUDA card unless the caller
    names another (device="cpu"); raises where there is no card."""
    return MultiPathNet(cfg, device=resolve_device(device),
                        freeze_stages=freeze_stages, param_dtype=param_dtype)


@torch.no_grad()
def init_params_(model: MultiPathNet, generator: torch.Generator):
    """flax's initializers, drawn from `generator`: conv and dense kernels
    LeCun-normal (normal truncated at 2 sigma, rescaled to variance
    1 / fan_in), biases and the skip bias zero, and the bbox rows of
    cls_bbox normal * 1e-3 (the reference's mixed_init)."""
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            p.zero_()
            continue
        std = (1.0 / p[0].numel()) ** 0.5 / 0.87962566103423978
        nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
    bbox = model.head.cls_bbox.weight[model.head.cls_dim:]
    bbox.copy_(torch.randn(bbox.shape, generator=generator,
                           device=bbox.device) * 1e-3)
    return model
