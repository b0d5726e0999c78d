"""MultiPathNet assembly — port of multipathnet_tpu/models/multipath.py on
its eval align path: trunk, per-level 1x1 skip reduction, foveal views
pooled through the CUDA window kernels, and the head.

Pooling follows the reference's view x level plan. In the "reference"
topology, group 1 (the 1x view over every skip level) goes to K1
(roi_pool.window_pool_multi) and group 2 (the context views over the last
level) to K2 (roi_pool.resident_pool). The TPU-only parts of the reference
are gone: there is no lane padding of C, and every single-level eval group
goes to K2 whatever its pyramid's size (the reference's 4 MB VMEM budget
has no counterpart here).
"""

from __future__ import annotations

import torch
from torch import nn

from multipathnet_tpu_torch.core.config import ModelConfig
from multipathnet_tpu_torch.models.backbones import get_backbone
from multipathnet_tpu_torch.models.heads import MultiPathHead
from multipathnet_tpu_torch.ops import boxes as box_ops
from multipathnet_tpu_torch.ops import roi_pool, roi_pyramid

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for model options the port does not run
    yet, naming the ROADMAP item that ports each."""
    if cfg.head_quant != "none":
        raise NotImplementedError(
            f"head_quant={cfg.head_quant!r} is not ported yet (ROADMAP A9)")
    if cfg.fc6_rank or cfg.fc7_rank:
        raise NotImplementedError(
            "low-rank fc6_rank/fc7_rank heads are not ported yet "
            "(ROADMAP A10)")
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
    """Eval-only MultiPath detector. `cfg.roi_impl` is not read: the port
    has one ROI route, the window kernels (their plain versions on CPU)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dtype = _DTYPES[cfg.dtype]
        self.dtype = dtype
        self.backbone = get_backbone(cfg.backbone, dtype, device=device)
        for lv in cfg.skip_levels:
            # ION-style 1x1 reduction per level, no bias: pooling is linear,
            # so sum_l pool(W_l f_l) == reduce(concat_l pool(f_l)); the
            # shared bias + ReLU live in the head.
            self.add_module(f"reduce_{lv}", nn.Conv2d(
                self.backbone.feature_channels[lv], cfg.skip_reduce_dim, 1,
                bias=False, device=device, dtype=dtype))
        self.head = MultiPathHead(
            num_classes=cfg.num_classes,
            foveal_scales=cfg.foveal_scales,
            num_integral_heads=len(cfg.integral_thresholds),
            fc_dim=cfg.fc_dim,
            skip_reduce_dim=cfg.skip_reduce_dim,
            roi_output_size=cfg.roi_output_size,
            class_specific_bbox=cfg.class_specific_bbox,
            dtype=dtype, device=device)

    def features(self, images: torch.Tensor) -> dict:
        """images (B, H, W, 3) normalized float -> {level: (B, Hl, Wl, C)}
        NHWC, each 1x1-reduced to skip_reduce_dim channels."""
        feats = self.backbone(images)
        out = {}
        for lv in self.cfg.skip_levels:
            x = feats[lv].permute(0, 3, 1, 2)  # NCHW view of the NHWC tap
            out[lv] = getattr(self, f"reduce_{lv}")(x).permute(0, 2, 3, 1)
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

    def pool_rois(self, feats: dict, rois: torch.Tensor, image_hw
                  ) -> torch.Tensor:
        """feats: level -> (B, Hl, Wl, C); rois (B, R, 4) image coords ->
        (B, F, R, G, G, C) in the trunk dtype."""
        b, r = rois.shape[:2]
        g = self.cfg.roi_output_size
        s = self.cfg.roi_samples_per_bin
        strides = self.backbone.feature_strides
        pyramids = {
            lv: roi_pyramid.build_pyramid_batch(
                feats[lv].contiguous(), 1.0 / strides[lv], output_size=g)
            for lv in self.cfg.skip_levels}
        outs = []
        for factors, levels in self._view_level_plan():
            nf = len(factors)
            views = torch.stack(
                [box_ops.expand(rois, f, image_hw[0], image_hw[1])
                 for f in factors], dim=1).reshape(-1, 4)  # (B*nf*R, 4)
            if len(levels) == 1:
                flat, meta = pyramids[levels[0]]
                out = roi_pool.batched_pyramid_pool_resident(
                    flat, meta, views, b, output_size=g, samples_per_bin=s)
            else:
                img_idx = torch.arange(
                    b, dtype=torch.int32,
                    device=rois.device).repeat_interleave(nf * r)
                out = roi_pool.batched_pyramid_pool_multi(
                    [pyramids[lv][0] for lv in levels],
                    [pyramids[lv][1] for lv in levels],
                    views, img_idx, output_size=g, samples_per_bin=s)
            outs.append(out.reshape(b, nf, r, g, g, out.shape[-1]))
        return torch.cat(outs, dim=1)

    def predict_rois(self, pooled: torch.Tensor):
        """pooled (B, F, R, G, G, C) -> scores (B, R, K, classes) f32,
        deltas (B, R, D) f32."""
        b, r = pooled.shape[0], pooled.shape[2]
        scores, deltas = self.head(pooled)
        return (scores.reshape(b, r, scores.shape[1], -1),
                deltas.reshape(b, r, -1))

    def forward(self, images: torch.Tensor, rois: torch.Tensor):
        """{images (B, H, W, 3), rois (B, R, 4)} -> (class_scores,
        bbox_deltas), the reference's contract."""
        feats = self.features(images)
        pooled = self.pool_rois(feats, rois, images.shape[1:3])
        return self.predict_rois(pooled)


def build_model(cfg: ModelConfig, device=None) -> MultiPathNet:
    return MultiPathNet(cfg, device=device)
