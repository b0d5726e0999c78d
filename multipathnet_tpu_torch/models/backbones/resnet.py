"""ResNet trunks — port of multipathnet_tpu/models/backbones/resnet.py.

Residual v1 trunks with frozen BatchNorm (models/layers.FrozenBatchNorm:
running statistics in train and eval alike, only the affine scale and
bias train). c3/c4/c5 are the outputs of the stages at strides 4/8/16;
the stride-32 stage is past the detection trunk, as in the reference.

Each convolution feeds its BatchNorm in float32 (models/layers.conv_f32),
which rounds once to the compute dtype, as the reference's XLA computes
it; residual sums run in the compute dtype.

Padding is explicit, as in the reference: every 3x3 convolution (the
stride-2 ones too) pads (1, 1), the 1x1 downsample pads nothing, the stem
is a 7x7 stride-2 convolution padded (3, 3), then a 3x3 stride-2 max-pool
padded (1, 1) with -inf. Modules carry the flax paths' names (stem,
stem_bn, stage{2,3,4}_block{i} with Conv_k/BatchNorm_k, the downsample on
the next free index: Conv_2 in a basic block, Conv_3 in a bottleneck), so
models/convert.py maps trees path for path. `freeze_stages` detaches the
activations after stage N (stage 1 = the stem), the reference's
stop_gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multipathnet_tpu_torch.models import layers


def _conv(cin, cout, k, stride, pad, device, dtype):
    return nn.Conv2d(cin, cout, k, stride, pad, bias=False, device=device,
                     dtype=dtype)


class _Block(nn.Module):
    def _conv_bn(self, k: int, x: torch.Tensor) -> torch.Tensor:
        """Conv_k, then BatchNorm_k on its float32 sum, in self.dtype."""
        conv = getattr(self, f"Conv_{k}")
        return getattr(self, f"BatchNorm_{k}")(
            layers.conv_f32(conv, x, self.dtype), self.dtype)


class BasicBlock(_Block):
    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 dtype=torch.bfloat16, device=None, param_dtype=None):
        super().__init__()
        pd = param_dtype or dtype
        self.dtype = dtype
        self.Conv_0 = _conv(cin, filters, 3, stride, 1, device, pd)
        self.BatchNorm_0 = layers.FrozenBatchNorm(filters, device=device)
        self.Conv_1 = _conv(filters, filters, 3, 1, 1, device, pd)
        self.BatchNorm_1 = layers.FrozenBatchNorm(filters, device=device)
        self.down = cin != filters or stride != 1
        if self.down:
            self.Conv_2 = _conv(cin, filters, 1, stride, 0, device, pd)
            self.BatchNorm_2 = layers.FrozenBatchNorm(filters, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._conv_bn(1, F.relu(self._conv_bn(0, x)))
        if self.down:
            x = self._conv_bn(2, x)
        return F.relu(x + y)


class BottleneckBlock(_Block):
    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 dtype=torch.bfloat16, device=None, param_dtype=None):
        super().__init__()
        pd = param_dtype or dtype
        self.dtype = dtype
        out = filters * 4
        self.Conv_0 = _conv(cin, filters, 1, 1, 0, device, pd)
        self.BatchNorm_0 = layers.FrozenBatchNorm(filters, device=device)
        self.Conv_1 = _conv(filters, filters, 3, stride, 1, device, pd)
        self.BatchNorm_1 = layers.FrozenBatchNorm(filters, device=device)
        self.Conv_2 = _conv(filters, out, 1, 1, 0, device, pd)
        self.BatchNorm_2 = layers.FrozenBatchNorm(out, device=device)
        self.down = cin != out or stride != 1
        if self.down:
            self.Conv_3 = _conv(cin, out, 1, stride, 0, device, pd)
            self.BatchNorm_3 = layers.FrozenBatchNorm(out, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self._conv_bn(1, F.relu(self._conv_bn(0, x))))
        y = self._conv_bn(2, y)
        if self.down:
            x = self._conv_bn(3, x)
        return F.relu(x + y)


class ResNet(nn.Module):
    feature_strides = {"c3": 4, "c4": 8, "c5": 16}

    def __init__(self, stage_sizes=(2, 2, 2), block=BasicBlock,
                 dtype=torch.bfloat16, device=None, freeze_stages: int = 0,
                 param_dtype=None):
        super().__init__()
        self.dtype = dtype
        self.freeze_stages = freeze_stages
        self.stage_sizes = tuple(stage_sizes)
        self.stem = _conv(3, 64, 7, 2, 3, device, param_dtype or dtype)
        self.stem_bn = layers.FrozenBatchNorm(64, device=device)
        cin, filters = 64, 64
        self.feature_channels = {}
        for si, n_blocks in enumerate(self.stage_sizes):
            for bi in range(n_blocks):
                stride = 2 if si > 0 and bi == 0 else 1
                self.add_module(f"stage{si + 2}_block{bi}", block(
                    cin, filters, stride, dtype=dtype, device=device,
                    param_dtype=param_dtype))
                cin = filters * block.expansion
            self.feature_channels[f"c{si + 3}"] = cin
            filters *= 2

    @staticmethod
    def frozen_prefixes(n_stages: int) -> tuple:
        """Parameter-name prefixes of the first n stages: stage 1 is the
        stem conv and its BN, stages 2..4 the residual groups."""
        out = []
        if n_stages >= 1:
            out += ["stem", "stem_bn"]
        for s in range(2, min(n_stages, 4) + 1):
            out.append(f"stage{s}_")
        return tuple(out)

    def forward(self, x: torch.Tensor) -> dict:
        """x (B, H, W, 3) normalized float -> {"c3","c4","c5"} NHWC maps."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        x = F.relu(self.stem_bn(layers.conv_f32(self.stem, x, self.dtype),
                                 self.dtype))
        x = F.max_pool2d(x, 3, 2, padding=1)  # -inf padding, /4
        if self.freeze_stages >= 1:
            x = x.detach()
        feats = {}
        for si, n_blocks in enumerate(self.stage_sizes):
            for bi in range(n_blocks):
                x = getattr(self, f"stage{si + 2}_block{bi}")(x)
            if si + 2 <= self.freeze_stages:
                x = x.detach()
            feats[f"c{si + 3}"] = x.permute(0, 2, 3, 1)
        return feats


def ResNet18(dtype=torch.bfloat16, device=None, freeze_stages=0,
             param_dtype=None):
    return ResNet((2, 2, 2), BasicBlock, dtype, device, freeze_stages,
                  param_dtype)


def ResNet50(dtype=torch.bfloat16, device=None, freeze_stages=0,
             param_dtype=None):
    return ResNet((3, 4, 6), BottleneckBlock, dtype, device, freeze_stages,
                  param_dtype)


def ResNet101(dtype=torch.bfloat16, device=None, freeze_stages=0,
              param_dtype=None):
    # torchvision resnet101's layer1-3; layer4 (/32) is past the trunk
    return ResNet((3, 4, 23), BottleneckBlock, dtype, device, freeze_stages,
                  param_dtype)
