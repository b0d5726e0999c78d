"""Plain reference of MultiPath fine-tuning on a ResNet-101 trunk, in
float32 PyTorch with TF32 off.

It imports nothing of the program. The step is that of
benchmark/reference/train.py (the flip, the resize, the sampling, the
float head in train mode with its dropout draws, the integral loss, SGD
with momentum and weight decay at the warm-up schedule's rate, the random
draws taken in the same order from one generator); the trunk is that of
benchmark/reference/multipath_resnet.py (He et al., arXiv:1512.03385,
Table 1, conv1-conv4_x: the stem, 3, 4 and 23 bottlenecks, each
convolution followed by its BatchNorm with frozen statistics), written
out again here with each convolution's operands lowered on the way in,
so that `Precision(fp8=True)` can round them while the gradient passes
through unchanged. Then the 1x1 reductions of c3, c4 and c5.

Training, as the configuration describes it (MultiPath sec. 4, Fast
R-CNN sec. 2.3, Detectron's FREEZE_AT 2): the stem, its BatchNorm and
conv2_x are cut from the gradient (their parameters take none, and
nothing below them needs one); in conv3_x and conv4_x every convolution
and each BatchNorm's scale and bias train; no BatchNorm statistic ever
changes (they are read, never updated, as flax's use_running_average and
the program's FrozenBatchNorm do); the reductions and the head train.

Departures from the published description, as the detector is built:
- no conv5_x and no classifier: the detector's trunk ends at conv4_x, as
  the MultiPath release's ResNet models do;
- the stride of a halving block sits on its 3x3 convolution (and on the
  projection), as in fb.resnet.torch and torchvision;
- BatchNorm statistics frozen in training, where the paper trains them:
  at 8 images a step they cannot be estimated, and fine-tuning recipes
  freeze them (Detectron's FrozenBN).

`Precision(fp8=True)` lowers every convolution's operands (the trunk's
and the reductions', and the head's GEMMs as benchmark/reference/train.py
does) to scaled e4m3 in the forward (the control); `trunk_fp8` lowers the
trunk's convolutions alone (the trunk-only control).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import multipath as base
from benchmark.reference import multipath_resnet as rn
from benchmark.reference import train as step_ref

FROZEN = ("backbone.stem.", "backbone.stem_bn.", "backbone.stage2_")
STATISTICS = ("running_mean", "running_var")


def _conv(x, w, fp8: bool, stride: int = 1, pad: int = 0):
    prec = base.Precision(fp8=fp8)
    if pad:
        x = F.pad(x, (pad, pad, pad, pad))
    return F.conv2d(step_ref._fp8(x, prec), step_ref._fp8(w, prec), None,
                    stride)


def _bottleneck(p: dict, name: str, x, stride: int, project: bool,
                fp8: bool):
    def conv_bn(k, inp, s=1, pad=0):
        return rn._bn(p, f"{name}.BatchNorm_{k}",
                      _conv(inp, p[f"{name}.Conv_{k}.weight"], fp8, s, pad))

    y = F.relu(conv_bn(0, x))
    y = F.relu(conv_bn(1, y, stride, 1))
    y = conv_bn(2, y)
    if project:
        x = conv_bn(3, x, stride)
    return F.relu(x + y)


def trunk(p: dict, backbone: str, x, levels, trunk_fp8: bool,
          prec: base.Precision) -> dict:
    """Normalized canvases (B, S, S, 3) -> {level: reduced (B, H, W, C)}:
    the taps c3, c4, c5 (conv2_x..conv4_x outputs), each through its 1x1
    reduction."""
    x = x.permute(0, 3, 1, 2)
    x = _conv(x, p["backbone.stem.weight"], trunk_fp8, 2, 3)
    x = F.relu(rn._bn(p, "backbone.stem_bn", x))
    x = F.max_pool2d(F.pad(x, (1, 1, 1, 1), value=float("-inf")), 3, 2)
    taps = {}
    for stage, blocks in enumerate(rn.STAGES[backbone], start=2):
        for i in range(blocks):
            x = _bottleneck(p, f"backbone.stage{stage}_block{i}", x,
                            2 if stage > 2 and i == 0 else 1, i == 0,
                            trunk_fp8)
        taps[f"c{stage + 1}"] = x
    return {lv: step_ref._fp8(F.conv2d(step_ref._fp8(taps[lv], prec),
                                       step_ref._fp8(p[f"reduce_{lv}.weight"],
                                                     prec)),
                              prec).permute(0, 2, 3, 1)
            for lv in levels}


class Reference(step_ref.Reference):
    """benchmark/reference/train.py's Reference on the ResNet trunk: the
    same step(), first_grads() and fault (`keep_images`), over the
    parameters outside the frozen stem and conv2_x, the BatchNorm
    statistics never among them."""

    def __init__(self, sd: dict, config: dict, canvas: int, seed: int,
                 device, prec=base.Precision(head_bits=0),
                 trunk_fp8: bool | None = None):
        super().__init__(sd, config, canvas, seed, device, prec)
        if config["train"]["freeze_backbone_stages"] != 2:
            raise ValueError("the ResNet training reference freezes the "
                             "stem and conv2_x (freeze_backbone_stages 2)")
        self.trunk_fp8 = prec.fp8 if trunk_fp8 is None else trunk_fp8
        for k in self.trainable:
            self.params[k].requires_grad_(False)
        self.trainable = [k for k in self.params
                          if not k.startswith(FROZEN)
                          and not k.endswith(STATISTICS)]
        for k in self.trainable:
            self.params[k].requires_grad_(True)

    def forward_loss(self, batch, keep_images=None):
        """benchmark/reference/train.py's forward_loss with this trunk."""
        images, hws, props, pmask, gt, gcls, gmask = [
            torch.as_tensor(x, device=self.device) for x in batch]
        b = images.shape[0]
        dev, gen = self.device, self.gen
        flip = torch.rand(b, generator=gen, device=dev) < self.data[
            "hflip_prob"]
        w = hws[:, 1]
        images = step_ref.hflip_images(images, w, flip)
        props = torch.where(flip[:, None, None],
                            step_ref.hflip_boxes(props, w[:, None]), props)
        gt = torch.where(flip[:, None, None],
                         step_ref.hflip_boxes(gt, w[:, None]), gt)
        x, scale = base.canvases(images, hws, self.canvas)
        props = props * scale[:, None, None]
        gt = gt * scale[:, None, None]
        noise = torch.rand((b, 2, props.shape[1] + gt.shape[1]),
                           generator=gen, device=dev)
        s = step_ref.sample(noise, props, pmask, gt, gcls.long(), gmask,
                            self.data, self.model)
        maps = trunk(self.params, self.model["backbone"], x,
                     self.model["skip_levels"], self.trunk_fp8, self.prec)
        pooled = base.pool(self.model, maps, s["rois"], self.canvas)
        rows = b * s["rois"].shape[1]
        masks = (torch.rand((rows, self.model["fc_dim"]), generator=gen,
                            device=dev)
                 for _ in range(2 * len(self.model["foveal_scales"])))
        scores, deltas = step_ref.head(self.params, self.model, pooled,
                                       masks, self.prec)
        if keep_images is not None:   # a fault: part of the batch
            scores, deltas = scores[keep_images], deltas[keep_images]
            s = {k: v[keep_images] for k, v in s.items()}
        return step_ref.loss(scores, deltas, s, self.model)
