"""MultiPathNet assembly — port of multipathnet_tpu/models/multipath.py:
trunk, per-level 1x1 skip reduction, foveal views pooled by the route
`cfg.roi_impl` names (`cfg.train_roi_impl` in training), and the head.

Pooling follows the reference's view x level plan (`_view_level_plan`).
The align routes, as the reference's `pool_rois` picks them:
  - "pallas" and "auto": the CUDA window kernels. In the "reference"
    topology group 1 (the 1x view over every skip level) goes to K1
    (roi_pool.window_pool_multi) and group 2 (the context views over the
    last level) to K2 (roi_pool.resident_pool). In training every group
    goes through the differentiable K1 (roi_pool.WindowPoolMulti), one
    level for group 2, as the reference's `not train` guard routes it.
    The reference's "auto" means its kernels on the TPU and "direct"
    elsewhere; here the card plays the TPU's part, so "auto" means the
    kernels on every device (their plain versions on the CPU).
  - "direct": the gather-based bilinear roi_align on each level's reduced
    map, image by image, each group's levels summed in float32
    (ops/roi.multilevel_foveal_roi_features(combine="sum")).
  - "pyramid": the reference's XLA oracle of the kernels: each image's
    avg pyramids (roi_pyramid.build_pyramid) and the window sampler
    (roi_pyramid.multilevel_foveal_pyramid_features(mode="avg",
    combine="sum")), float32. Training takes "direct" in its place, as the
    reference does.
The last two are plain PyTorch: the reference computes them in XLA,
outside any Pallas kernel. They return float32 and the head casts to its
dtype. The TPU-only parts of the kernel route are gone: C is not padded to
the TPU's 128 lanes (only to a multiple of 8 for the bf16 kernels, whose
TMA strides are 16-byte units, with zero bias on the pad lanes, as the
reference pads), and every single-level eval group goes to K2 whatever
its pyramid's size (the reference's 4 MB VMEM budget has no counterpart
here).

Parameters are stored in `param_dtype` (float32 for training, as flax keeps
them) and cast to the compute dtype `cfg.dtype` at each call; an eval model
stores them in the compute dtype.

roi_mode="max" (the `multipath_vgg16_reference` preset) is the
reference's order: `features` returns the RAW trunk maps, each view x
level plan group is max-pooled with inn.ROIPooling semantics and its levels
concatenated, then each level's 1x1 reduce runs on its slice of the pooled
channels in the compute dtype and the levels are summed in level order
(`_pool_rois_max`). There "direct" is the exact route (ops/roi.py,
bit-equal to the reference's oracle at every scale), "pyramid"/"pallas"/
"auto" the windowed one (max pyramids and window masks,
ops/roi_pyramid.py; exact for views whose bins span at most one base
cell). Training always takes the exact route. Both are plain PyTorch.

Serving (`head_quant="int8"`, `fc6_rank`/`fc7_rank`) builds the int8 and
factored head (models/heads.py); its weights come from the load-time
transforms of a float tree (eval/detect.serving_params). An int8 model on
the kernel route in align mode pools through `pool_rois_quantized`: the
head's skip bias, ReLU and the per-view int8 quantization run in the pool
kernels' epilogue. On every other route it pools through `pool_rois` and
the head quantizes its rows.

`features`, `pool_rois` and `predict_rois` are the spans of those names
(utils/profiling). No other span opens inside them, but for a ResNet
trunk's features.stem and features.stage2..4 inside `features`.
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
from multipathnet_tpu_torch.ops import roi as roi_ops
from multipathnet_tpu_torch.ops import roi_pool, roi_pyramid
from multipathnet_tpu_torch.utils import profiling

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
ROI_ROUTES = ("auto", "direct", "pallas", "pyramid")
KERNEL_ROUTES = ("auto", "pallas")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ValueError for options the model does not know."""
    if cfg.roi_mode not in ("align", "max"):
        raise ValueError(f"roi_mode must be align|max, got {cfg.roi_mode!r}")
    if cfg.preprocess not in ("rgb_unit", "caffe_bgr"):
        raise ValueError(f"unknown preprocess {cfg.preprocess!r}")
    for impl in (cfg.roi_impl, cfg.train_roi_impl):
        if impl not in ROI_ROUTES:
            raise ValueError(f"unknown roi_impl {impl!r}; have "
                             f"{list(ROI_ROUTES)}")
    if cfg.dtype not in _DTYPES:
        raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, "
                         f"got {cfg.dtype!r}")


class MultiPathNet(nn.Module):
    """MultiPath detector. `cfg.roi_impl` (`cfg.train_roi_impl` in
    training) picks the ROI route: in align mode the window kernels
    (their plain versions on CPU), the direct roi_align or the pyramid
    oracle; in max mode the exact or the windowed max route (module
    docstring).
    `freeze_stages` stops the gradient after trunk stage N; it leaves the
    parameters as they are, so checkpoints interchange."""

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

    @profiling.span("features")
    def features(self, images: torch.Tensor) -> dict:
        """images (B, H, W, 3) normalized float -> {level: (B, Hl, Wl, C)}
        NHWC, each 1x1-reduced to skip_reduce_dim channels; in max mode the
        raw trunk maps (max pooling is not linear, so the reduction cannot
        run before it)."""
        feats = self.backbone(images)
        if self.cfg.roi_mode == "max":
            return {lv: feats[lv] for lv in self.cfg.skip_levels}
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

    def roi_route(self, train: bool = False) -> str:
        """The route pool_rois takes: "kernels", "direct" or "pyramid" in
        align mode, "exact" or "windowed" in max mode."""
        impl = self.cfg.train_roi_impl if train else self.cfg.roi_impl
        if self.cfg.roi_mode == "max":
            return "exact" if train or impl == "direct" else "windowed"
        if impl in KERNEL_ROUTES:
            return "kernels"
        return "direct" if train else impl

    @profiling.span("pool_rois")
    def pool_rois(self, feats: dict, rois: torch.Tensor, image_hw,
                  train: bool = False, quant_bias=None):
        """feats: level -> (B, Hl, Wl, C); rois (B, R, 4) image coords ->
        (B, F, R, G, G, C): the trunk dtype on the kernel route, float32
        on "direct" and "pyramid" (roi_route; module docstring). `train`
        sends every kernel group through the differentiable K1. With
        `quant_bias` (the head's skip bias in its dtype; eval on the
        kernel route only) the kernels' int8 epilogue runs: returns (int8
        (B, F, R, G, G, C), float32 scales (B, F, R, 1))."""
        route = self.roi_route(train)
        if quant_bias is not None and route != "kernels":
            raise ValueError(f"the int8 pool epilogue needs the kernel "
                             f"route in align mode, not {route!r}")
        if route in ("exact", "windowed"):
            return self._pool_rois_max(feats, rois, image_hw,
                                       exact=route == "exact")
        if route != "kernels":   # "direct" or "pyramid", float32
            return torch.cat([pooled for _, _, pooled in self._pool_images(
                feats, rois, image_hw, route == "direct", "avg", "sum")],
                dim=1)
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

    def _pool_images(self, feats: dict, rois: torch.Tensor, image_hw,
                     gather: bool, mode: str, combine: str = "concat"):
        """The plain routes: [(factors, levels, (B, f, R, G, G, C')
        pooled)] for each plan group, each image's views pooled on its
        levels' maps in `mode` and the levels combined, images stacked.
        gather=True: ops/roi's routes on the maps; else each image's
        pyramids (max pyramids for mode="exact_max") and the window
        sampler."""
        strides = self.backbone.feature_strides
        scales = {lv: 1.0 / strides[lv] for lv in self.cfg.skip_levels}
        g = self.cfg.roi_output_size
        kw = dict(image_hw=image_hw, output_size=g,
                  samples_per_bin=self.cfg.roi_samples_per_bin, mode=mode,
                  combine=combine)

        def pool(maps, r, factors):
            if gather:
                return roi_ops.multilevel_foveal_roi_features(
                    maps, r, scales=scales, foveal_factors=factors, **kw)
            pyramids = {lv: roi_pyramid.build_pyramid(
                f, scales[lv], output_size=g,
                mode="max" if mode == "exact_max" else "avg")
                for lv, f in maps.items()}
            return roi_pyramid.multilevel_foveal_pyramid_features(
                pyramids, r, foveal_factors=factors, **kw)

        return [(factors, levels, torch.stack([
            pool({lv: feats[lv][i] for lv in levels}, rois[i], factors)
            for i in range(rois.shape[0])]))
            for factors, levels in self._view_level_plan()]

    def _pool_rois_max(self, feats: dict, rois: torch.Tensor, image_hw,
                       exact: bool) -> torch.Tensor:
        """roi_mode="max": each plan group's views max-pooled on the raw
        maps of its levels, image by image, levels concatenated; then each
        level's 1x1 reduce on its slice of the channels, in the compute
        dtype, summed in level order -> (B, F, R, G, G, skip_reduce_dim).
        exact=True is ops/roi.py's route, else the windowed one over max
        pyramids."""
        b, r = rois.shape[:2]
        g = self.cfg.roi_output_size
        outs = []
        for factors, levels, pooled in self._pool_images(
                feats, rois, image_hw, exact, "exact_max"):
            nf = len(factors)    # pooled (B, nf, R, G, G, sum C_l)
            out, lo = None, 0
            for lv in levels:
                c_l = feats[lv].shape[-1]
                part = pooled[..., lo:lo + c_l].reshape(b * nf * r, g, g, c_l)
                lo += c_l
                red = layers.conv(getattr(self, f"reduce_{lv}"),
                                  part.permute(0, 3, 1, 2), self.dtype)
                out = red if out is None else out + red
            outs.append(out.permute(0, 2, 3, 1).reshape(b, nf, r, g, g, -1))
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

    @profiling.span("predict_rois")
    def predict_rois(self, pooled: torch.Tensor, train: bool = False,
                     generator: torch.Generator | None = None,
                     pooled_scale: torch.Tensor | None = None,
                     shard=None):
        """pooled (B, F, R, G, G, C) -> scores (B, R, K, classes) f32,
        deltas (B, R, D) f32. `generator` draws the train-mode dropout (at
        the global batch's shape, `shard` (index, count) naming this
        batch's part of it); `pooled_scale` goes with the int8 output of
        pool_rois_quantized."""
        b, r = pooled.shape[0], pooled.shape[2]
        scores, deltas = self.head(pooled, train=train, generator=generator,
                                   pooled_scale=pooled_scale, shard=shard)
        return (scores.reshape(b, r, scores.shape[1], -1),
                deltas.reshape(b, r, -1))

    def forward(self, images: torch.Tensor, rois: torch.Tensor,
                train: bool = False,
                generator: torch.Generator | None = None, shard=None):
        """{images (B, H, W, 3), rois (B, R, 4)} -> (class_scores,
        bbox_deltas), the reference's contract."""
        feats = self.features(images)
        pooled = self.pool_rois(feats, rois, images.shape[1:3], train=train)
        return self.predict_rois(pooled, train=train, generator=generator,
                                 shard=shard)


def build_model(cfg: ModelConfig, freeze_stages: int = 0, param_dtype=None,
                device=None) -> MultiPathNet:
    """The model for `cfg` on `device`: the CUDA card unless the caller
    names another (device="cpu"); raises where there is no card."""
    return MultiPathNet(cfg, device=resolve_device(device),
                        freeze_stages=freeze_stages, param_dtype=param_dtype)


@torch.no_grad()
def flax_init_(model: nn.Module, generator: torch.Generator):
    """flax's default initializers, drawn from `generator` in parameter
    order: conv and dense kernels LeCun-normal (normal truncated at 2
    sigma, rescaled to variance 1 / fan_in), biases zero; frozen BN scale
    1, running mean 0 and variance 1."""
    for mod in model.modules():
        if isinstance(mod, layers.FrozenBatchNorm):
            mod.weight.fill_(1.0)
            mod.running_mean.zero_()
            mod.running_var.fill_(1.0)
    for name, p in model.named_parameters():
        if name.endswith("bias"):
            p.zero_()
            continue
        if p.dim() == 1:  # a BN scale, set above
            continue
        std = (1.0 / p[0].numel()) ** 0.5 / 0.87962566103423978
        nn.init.trunc_normal_(p, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
    return model


@torch.no_grad()
def init_params_(model: MultiPathNet, generator: torch.Generator):
    """flax_init_, then the bbox rows of cls_bbox normal * 1e-3 (the
    reference's mixed_init); the skip bias is zero."""
    flax_init_(model, generator)
    bbox = model.head.cls_bbox.weight[model.head.cls_dim:]
    bbox.copy_(torch.randn(bbox.shape, generator=generator,
                           device=bbox.device) * 1e-3)
    return model
