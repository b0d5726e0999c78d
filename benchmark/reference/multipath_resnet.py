"""Plain reference of MultiPath detection on a ResNet-101 trunk, in float32
PyTorch.

It imports nothing of the program: it reads the float checkpoint the
benchmark drew ({name: tensor}, the port's parameter names in torch
layout, the frozen BatchNorm statistics among them) and the raw batch.
The trunk is written out here; the pixels, the pool, the head's int8 and
SVD arithmetic and the box decode are those of the VGG-16 reference
(benchmark/reference/multipath.py), imported, so that the two serving
cells differ in their trunk alone.

The trunk follows He, Zhang, Ren and Sun, "Deep Residual Learning for
Image Recognition" (arXiv:1512.03385), Table 1, up to conv4_x:

- conv1: 7x7 stride 2, 64 channels, zero padding 3; BatchNorm; ReLU;
  then a 3x3 stride-2 max-pool with padding 1 that pads with -inf;
- conv2_x, conv3_x, conv4_x: 3, 4 and 23 bottlenecks [1x1 f, 3x3 f,
  1x1 4f] with f = 64, 128, 256, each convolution followed by its
  BatchNorm, ReLU after the first two and after the residual sum; the
  first block of each stage adds a projection shortcut (1x1, 4f, its own
  BatchNorm), strided where the stage halves the map;
- BatchNorm with frozen statistics, unfolded:
  (x - running_mean) * rsqrt(running_var + eps) * weight + bias,
  eps 1e-5;
- taps c3, c4, c5: the outputs of conv2_x, conv3_x, conv4_x (strides 4,
  8, 16), each reduced by its 1x1 convolution (no bias) to
  skip_reduce_dim, as in the VGG-16 reference.

Departures from the published description, as the detector is built:
- no conv5_x and no classifier: the detector's trunk ends at conv4_x, as
  the MultiPath release's ResNet models (resnet18_integral_coco.t7) do;
- the stride of a halving block sits on its 3x3 convolution (and on the
  projection), not on its first 1x1, as in fb.resnet.torch and
  torchvision, whose models the detector loads; the paper's Table 1
  does not place it.

`Precision` lowers it for the control as in the VGG-16 reference: every
convolution's operands and the pooled maps in fp8 (e4m3, one scale a
tensor), the head in int4.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import multipath as base

STAGES = {"resnet101": (3, 4, 23)}
BN_EPS = 1e-5


def _conv(x, w, prec: base.Precision, stride: int = 1, pad: int = 0):
    if prec.fp8:
        x, w = base.fp8(x), base.fp8(w)
    if pad:
        x = F.pad(x, (pad, pad, pad, pad))
    return F.conv2d(x, w, None, stride)


def _bn(sd: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    def c(key):
        return sd[f"{name}.{key}"][:, None, None]
    return ((x - c("running_mean")) * torch.rsqrt(c("running_var") + BN_EPS)
            * c("weight") + c("bias"))


def _bottleneck(sd: dict, name: str, x, stride: int, project: bool,
                prec: base.Precision):
    def conv_bn(k, inp, s=1, pad=0):
        return _bn(sd, f"{name}.BatchNorm_{k}",
                   _conv(inp, sd[f"{name}.Conv_{k}.weight"], prec, s, pad))

    y = F.relu(conv_bn(0, x))
    y = F.relu(conv_bn(1, y, stride, 1))
    y = conv_bn(2, y)
    if project:
        x = conv_bn(3, x, stride)
    return F.relu(x + y)


def taps(sd: dict, backbone: str, x: torch.Tensor,
         prec: base.Precision = base.Precision()) -> dict:
    """Normalized canvases (B, S, S, 3) -> {"c3", "c4", "c5"}: the outputs
    of conv2_x..conv4_x, NCHW, float32."""
    if backbone not in STAGES:
        raise ValueError(f"no plain ResNet reference for {backbone!r}")
    x = x.permute(0, 3, 1, 2)
    x = _conv(x, sd["backbone.stem.weight"], prec, 2, 3)
    x = F.relu(_bn(sd, "backbone.stem_bn", x))
    x = F.max_pool2d(F.pad(x, (1, 1, 1, 1), value=float("-inf")), 3, 2)
    out = {}
    for stage, blocks in enumerate(STAGES[backbone], start=2):
        for i in range(blocks):
            stride = 2 if stage > 2 and i == 0 else 1
            x = _bottleneck(sd, f"backbone.stage{stage}_block{i}", x, stride,
                            i == 0, prec)
        out[f"c{stage + 1}"] = x
    return out


def trunk(sd: dict, backbone: str, x: torch.Tensor, levels,
          prec: base.Precision) -> dict:
    """Normalized canvases (B, S, S, 3) -> {level: reduced (B, H, W, C)}."""
    t = taps(sd, backbone, x, prec)
    out = {}
    for lv in levels:
        y = _conv(t[lv], sd[f"reduce_{lv}.weight"], prec).permute(0, 2, 3, 1)
        out[lv] = base.fp8(y) if prec.fp8 else y.contiguous()
    return out


@torch.no_grad()
def detect_scores(sd: dict, model: dict, canvas: int, images_u8, src_hws,
                  proposals, prec: base.Precision = base.Precision()):
    """A batch -> (probs (B, P, classes), boxes (B, P, classes, 4)) in
    source coordinates, before NMS."""
    base.exact_float32()
    x, scale = base.canvases(images_u8, src_hws, canvas)
    maps = trunk(sd, model["backbone"], x, model["skip_levels"], prec)
    del x
    rois = proposals.float() * scale[:, None, None]
    pooled = base.pool(model, maps, rois, canvas)
    del maps
    scores, deltas = base.head(sd, model, pooled, prec.head_bits
                               if model["head_quant"] == "int8" else 0)
    del pooled
    probs = torch.softmax(scores, -1).mean(2)
    b, p, ncls = probs.shape
    if model["class_specific_bbox"]:
        d = deltas.reshape(b, p, ncls, 4)
    else:
        d = deltas[:, :, None, :].expand(b, p, ncls, 4)
    boxes = base.decode(rois[:, :, None, :], d, model["bbox_reg_means"],
                        model["bbox_reg_stds"])
    lim = src_hws.float() * scale[:, None]
    hi = torch.stack([lim[:, 1], lim[:, 0], lim[:, 1], lim[:, 0]], -1)
    boxes = torch.minimum(boxes.clamp(min=0.0), hi[:, None, None, :])
    return probs, boxes / scale[:, None, None, None]
