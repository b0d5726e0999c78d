"""Config tree — a jax-free copy of multipathnet_tpu/core/config.py.

The JAX package's config module is itself jax-free, but importing it runs
multipathnet_tpu/core/__init__.py, which imports core/mesh.py and with it
jax. So the port carries this copy, and tests/test_torch_config.py holds it
field for field equal to the reference for every preset.

Every model option of the reference runs in the port; the one CLI option
that does not yet (`cli.train --tensorboard`) raises NotImplementedError
where it is read (utils/metrics.py).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Architecture knobs (MultiPath paper §3; Fast R-CNN §2)."""

    backbone: str = "vgg16"  # vgg16 | resnet18 | resnet50 | resnet101 | alexnet
    num_classes: int = 81  # 80 COCO categories + background (index 0)
    # Foveal context scales (MultiPath §3.1). () => plain Fast R-CNN head.
    foveal_scales: Tuple[float, ...] = (1.0, 1.5, 2.0, 4.0)
    # Backbone stages to ROI-pool for skip connections (MultiPath §3.2).
    # ("c5",) => plain Fast R-CNN single-level pooling.
    skip_levels: Tuple[str, ...] = ("c3", "c4", "c5")
    # Which (foveal view x skip level) pairs are pooled. "reference" =
    # SURVEY.md §3.1's call stack ("ROIPool x7"): the 1x view pools ALL skip
    # levels, the context views (1.5/2/4x) pool only the LAST level — 7
    # windows/ROI. "dense" = every view pools every level (SURVEY §2.2's
    # "4x(foveal) x 3(skips)" reading — 12 windows/ROI, ~2x the ROI DMA).
    # The empty reference mount makes both readings defensible; "reference"
    # follows the explicit call-stack count and is the fast default.
    foveal_topology: str = "reference"
    skip_reduce_dim: int = 512  # 1x1-conv channel reduction after skip concat
    # Integral-loss classifier heads: fg IoU thresholds (MultiPath §3.3).
    # A single (0.5,) => vanilla Fast R-CNN classification loss.
    integral_thresholds: Tuple[float, ...] = (0.50, 0.55, 0.60, 0.65, 0.70, 0.75)
    # Aggregation of the K integral CE terms: "mean" (default; cls:bbox 1:1,
    # measured to train far better from random init) or "sum" (paper-literal
    # L = sum_k CE_k). See train/losses.py docstring for the measurements.
    integral_loss_agg: str = "mean"
    roi_output_size: int = 7  # ROI pooling output bins (Fast R-CNN: 7x7)
    roi_samples_per_bin: int = 2  # bilinear samples per bin axis (roi_align)
    # ROI pooling semantics: "align" (bilinear roi_align, the TPU-native
    # default) or "max" (reference-exact inn.ROIPooling max semantics:
    # integer bin extents, max over covered cells, pool RAW trunk maps then
    # concat+1x1-reduce — routed to the XLA oracle path; for mAP parity runs
    # against Torch checkpoints). SURVEY.md §2.2 row 1.
    roi_mode: str = "align"
    # Pixel preprocessing: "rgb_unit" ([0,1] RGB, ImageNet mean/std — the
    # torchvision convention) or "caffe_bgr" (BGR order, 0-255 mean-pixel
    # subtraction, no std — the reference's Caffe-origin trunks,
    # SURVEY.md §2.1 ImageTransformer).
    preprocess: str = "rgb_unit"
    # ROI feature implementation for inference: "auto" (Pallas kernel on TPU,
    # direct XLA elsewhere), "pallas", "pyramid" (XLA oracle of the kernel),
    # "direct" (gather-based roi_align).
    roi_impl: str = "auto"
    # Training-path implementation: "auto" = Pallas forward + windowed
    # scatter-add backward (custom VJP) on TPU, direct XLA elsewhere;
    # or "direct" / "pallas" explicitly.
    train_roi_impl: str = "auto"
    fc_dim: int = 4096  # FC6/FC7 width (VGG-16 heads)
    # FC-head quantization for SERVING: "none" (bf16 GEMMs) or "int8"
    # (dynamic-activation / static-per-channel-weight int8 on the MXU,
    # ~2x the bf16 GEMM rate on v5e — ops/quant.py). Inference-only; load a
    # float checkpoint through ops.quant.quantize_head_params first.
    head_quant: str = "none"
    # Truncated-SVD FC compression for SERVING (Fast R-CNN §3.1 "Truncated
    # SVD for faster detection"; ops/lowrank.py): rank t > 0 factors that FC
    # family into (in -> t) + (t -> fc_dim) GEMMs at load/export time.
    # Composes with head_quant="int8". 0 = full-rank. Inference-only.
    fc6_rank: int = 0
    fc7_rank: int = 0
    dtype: str = "bfloat16"  # trunk compute dtype; heads/losses stay f32
    # bbox regression target normalization (Fast R-CNN §2.3 / BBoxNorm.lua)
    bbox_reg_means: Tuple[float, ...] = (0.0, 0.0, 0.0, 0.0)
    bbox_reg_stds: Tuple[float, ...] = (0.1, 0.1, 0.2, 0.2)
    class_specific_bbox: bool = True  # 4*num_classes regression outputs


@dataclass(frozen=True)
class DataConfig:
    """Data layer (SURVEY.md §2.1 loaders + BatchProviderROI)."""

    dataset: str = "synthetic"  # synthetic | coco
    root: str = ""  # dataset root (images + annotations)
    annotations: str = ""  # path to instances_*.json
    proposals: str = ""  # path to proposals .npz
    image_size: Tuple[int, int] = (640, 640)  # fixed canvas HxW (static shapes)
    max_proposals: int = 1000  # P: proposal padding size
    # Fast R-CNN sampling (paper §2.3): per-image ROI minibatch
    rois_per_image: int = 64
    fg_fraction: float = 0.25
    fg_iou_threshold: float = 0.5
    bg_iou_range: Tuple[float, float] = (0.1, 0.5)
    max_gt_per_image: int = 100  # GT padding size
    hflip_prob: float = 0.5
    prefetch: int = 2  # host->device prefetch depth


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 8  # global images per step (split over the data mesh axis)
    lr: float = 1e-3
    momentum: float = 0.9
    weight_decay: float = 5e-4
    lr_decay_steps: Tuple[int, ...] = (240_000,)  # step LR decay boundaries
    lr_decay_factor: float = 0.1
    total_steps: int = 320_000
    warmup_steps: int = 500
    checkpoint_every: int = 1000
    log_every: int = 20
    seed: int = 0
    checkpoint_dir: str = "/tmp/mpnet_ckpt"
    grad_clip_norm: float = 0.0  # 0 => off
    freeze_backbone_stages: int = 2  # NoBackprop analog: freeze c1..cN


@dataclass(frozen=True)
class EvalConfig:
    score_threshold: float = 0.05
    nms_iou_threshold: float = 0.5
    # top-k per class before NMS; 100 suffices for the COCO <=100 det/img cap
    # and halves NMS time vs 256 (docs/PERF.md)
    pre_nms_per_class: int = 100
    max_detections: int = 100  # COCO protocol: <=100 det/img
    roi_chunk: int = 512  # SequentialSplitBatch analog: ROI chunking at test time


@dataclass(frozen=True)
class MeshConfig:
    data_axis: int = -1  # -1 => all devices on the data axis
    model_axis: int = 1  # reserved; >1 enables tensor sharding of FC heads


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    name: str = "default"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "Config":
        """Inverse of to_json (serving bundles / config dumps). JSON arrays
        come back as the tuples the frozen dataclasses declare."""
        raw = json.loads(text)

        subtrees = {"model": ModelConfig, "data": DataConfig,
                    "train": TrainConfig, "eval": EvalConfig,
                    "mesh": MeshConfig}

        def build(cls, d):
            kw = {}
            for f in dataclasses.fields(cls):
                if f.name not in d:
                    continue  # forward-compat: missing field -> default
                v = d[f.name]
                if f.name in subtrees and cls is Config:
                    kw[f.name] = build(subtrees[f.name], v)
                elif isinstance(v, list):
                    kw[f.name] = tuple(v)
                else:
                    kw[f.name] = v
            return cls(**kw)

        return build(Config, raw)

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)


def _replace(cfg: Config, path: str, **kw: Any) -> Config:
    sub = dataclasses.replace(getattr(cfg, path), **kw)
    return dataclasses.replace(cfg, **{path: sub})


def preset(name: str) -> Config:
    """Named presets mirroring BASELINE.json's five configs."""
    c = Config(name=name)
    if name == "fastrcnn_vgg16_single":
        # config 1: Fast R-CNN VGG-16, single image, precomputed proposals
        c = _replace(c, "model", foveal_scales=(1.0,), skip_levels=("c5",),
                     integral_thresholds=(0.5,))
        c = _replace(c, "train", batch_size=1)
    elif name == "multipath_vgg16_b1":
        # config 2: MultiPath VGG-16 foveal+skip, batch-1 inference
        c = _replace(c, "train", batch_size=1)
    elif name == "multipath_vgg16_batched":
        # config 3: batched inference 8 imgs x 1000 proposals, fused kernels
        c = _replace(c, "train", batch_size=8)
    elif name == "multipath_vgg16_int8":
        # config 3 + int8 FC heads: the serving configuration. Same float
        # checkpoint, quantized at load (ops/quant.quantize_head_params);
        # accuracy pinned within noise of bf16 by tests/test_quant.py.
        c = _replace(c, "model", head_quant="int8")
        c = _replace(c, "train", batch_size=8)
    elif name == "multipath_vgg16_int8_svd":
        # int8 serving + truncated-SVD FC compression at the Fast R-CNN
        # §3.1 operating point (fc6 t=1024, fc7 t=256 — the paper's VGG-16
        # deployment ranks). Load a float checkpoint: it is factorized
        # (ops/lowrank.py) then quantized at load/export.
        c = _replace(c, "model", head_quant="int8", fc6_rank=1024,
                     fc7_rank=256)
        c = _replace(c, "train", batch_size=8)
    elif name == "multipath_vgg16_train":
        # config 4: integral-loss fine-tuning, data-parallel over the TPU mesh
        pass
    elif name == "sharpmask_multipath_e2e":
        # config 5: SharpMask proposal generation -> MultiPath detection, ResNet
        c = _replace(c, "model", backbone="resnet50")
    elif name == "multipath_vgg16_reference":
        # reference-exact evaluation mode: inn.ROIPooling max semantics +
        # Caffe-origin pixel pipeline (BGR, 0-255 mean-pixel). For mAP-parity
        # runs against Torch checkpoints (BASELINE "within 0.3 mAP").
        c = _replace(c, "model", roi_mode="max", preprocess="caffe_bgr",
                     roi_impl="direct")
    elif name == "multipath_resnet18_integral":
        # the reference's released demo model family
        # (resnet18_integral_coco.t7): ResNet-18 trunk, integral heads,
        # Caffe-free torchvision preprocessing via import_weights
        c = _replace(c, "model", backbone="resnet18")
    elif name == "tiny":
        # test-sized preset: everything shrunk so CPU tests run in seconds
        c = _replace(c, "model", backbone="tinynet", fc_dim=64, skip_reduce_dim=32,
                     num_classes=5)
        c = _replace(c, "data", image_size=(64, 64), max_proposals=32,
                     rois_per_image=16, max_gt_per_image=8)
        c = _replace(c, "train", batch_size=2, total_steps=20, lr=2e-2,
                     checkpoint_every=10, warmup_steps=0,
                     freeze_backbone_stages=0)  # random-init trunk: train all
        c = _replace(c, "eval", pre_nms_per_class=16, max_detections=10,
                     roi_chunk=32)
    elif name != "default":
        raise KeyError(f"unknown preset: {name!r} (have {sorted(PRESETS)})")
    return c


PRESETS = (
    "default",
    "tiny",
    "fastrcnn_vgg16_single",
    "multipath_vgg16_b1",
    "multipath_vgg16_batched",
    "multipath_vgg16_int8",
    "multipath_vgg16_int8_svd",
    "multipath_vgg16_train",
    "multipath_vgg16_reference",
    "multipath_resnet18_integral",
    "sharpmask_multipath_e2e",
)
