"""Small trunks — port of multipathnet_tpu/models/backbones/small.py:
AlexNetLike (the reference's model "S" family) and TinyNet, the test-sized
trunk that lets CPU tests run the whole slice at the `tiny` preset.

flax `padding="SAME"` at stride 2 pads asymmetrically: (0, 1) for a 3x3
conv or max-pool over an even size, (2, 3) for AlexNet's 7x7 conv1, where
`Conv2d(padding=k // 2)` pads symmetrically. So the padding is computed the
SAME way and applied explicitly (`same_pad`), with -inf for max-pools as
flax pads them. `freeze_stages` detaches after conv N, as the reference's
stop_gradient does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multipathnet_tpu_torch.models import layers


def same_pad(x: torch.Tensor, kernel: int, stride: int,
             value: float = 0.0) -> torch.Tensor:
    """Pad an NCHW tensor the way XLA's SAME padding does: the total
    (ceil(n / s) - 1) * s + k - n, with the odd cell at the high end,
    filled with `value` (-inf for a max-pool)."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad takes the last dim first
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value)


def _same_max_pool(x: torch.Tensor) -> torch.Tensor:
    """flax nn.max_pool(x, (3, 3), (2, 2), padding="SAME") on NCHW."""
    return F.max_pool2d(same_pad(x, 3, 2, float("-inf")), 3, 2)


class AlexNetLike(nn.Module):
    """AlexNet-shaped trunk with SAME padding and strides that keep the
    c3/c4/c5 contract (strides 4/8/16): conv1 7x7/2 (64), max-pool, conv2
    5x5 (192) = c3, max-pool, conv3 3x3 (384) = c4, max-pool, conv4 3x3
    (256), conv5 3x3 (256) = c5, each conv with a bias and a ReLU."""

    feature_strides = {"c3": 4, "c4": 8, "c5": 16}
    feature_channels = {"c3": 192, "c4": 384, "c5": 256}
    _CONVS = ((3, 64, 7, 2), (64, 192, 5, 1), (192, 384, 3, 1),
              (384, 256, 3, 1), (256, 256, 3, 1))

    def __init__(self, dtype=torch.bfloat16, device=None,
                 freeze_stages: int = 0, param_dtype=None):
        super().__init__()
        for i, (cin, cout, k, s) in enumerate(self._CONVS, start=1):
            self.add_module(f"conv{i}", nn.Conv2d(
                cin, cout, k, stride=s, device=device,
                dtype=param_dtype or dtype))
        self.dtype = dtype
        self.freeze_stages = freeze_stages

    @staticmethod
    def frozen_prefixes(n_stages: int) -> tuple:
        """conv1..convN (5 convs in all)."""
        return tuple(f"conv{i}" for i in range(1, min(n_stages, 5) + 1))

    def _conv(self, i: int, x: torch.Tensor) -> torch.Tensor:
        mod = getattr(self, f"conv{i}")
        k, s = mod.kernel_size[0], mod.stride[0]
        x = F.relu(layers.conv(mod, same_pad(x, k, s), self.dtype))
        return x.detach() if i <= self.freeze_stages else x

    def forward(self, x: torch.Tensor) -> dict:
        """x (B, H, W, 3) -> {"c3","c4","c5"} NHWC maps."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        x = _same_max_pool(self._conv(1, x))                 # /4
        x = self._conv(2, x)
        feats = {"c3": x.permute(0, 2, 3, 1)}
        x = self._conv(3, _same_max_pool(x))                 # /8
        feats["c4"] = x.permute(0, 2, 3, 1)
        x = self._conv(5, self._conv(4, _same_max_pool(x)))  # /16
        feats["c5"] = x.permute(0, 2, 3, 1)
        return feats


class TinyNet(nn.Module):
    """4-conv trunk (8/8/16/32 channels) honoring the c3/c4/c5 contract."""

    feature_strides = {"c3": 4, "c4": 8, "c5": 16}
    feature_channels = {"c3": 8, "c4": 16, "c5": 32}

    def __init__(self, dtype=torch.float32, device=None,
                 freeze_stages: int = 0, param_dtype=None):
        super().__init__()
        chans = (3, 8, 8, 16, 32)
        for i in range(1, 5):
            self.add_module(f"conv{i}", nn.Conv2d(
                chans[i - 1], chans[i], 3, stride=2, device=device,
                dtype=param_dtype or dtype))
        self.dtype = dtype
        self.freeze_stages = freeze_stages

    @staticmethod
    def frozen_prefixes(n_stages: int) -> tuple:
        return tuple(f"conv{i}" for i in range(1, min(n_stages, 4) + 1))

    def forward(self, x: torch.Tensor) -> dict:
        """x (B, H, W, 3) -> {"c3","c4","c5"} NHWC maps."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        feats = {}
        for i in range(1, 5):
            x = F.relu(layers.conv(getattr(self, f"conv{i}"),
                                   same_pad(x, 3, 2), self.dtype))
            if i <= self.freeze_stages:
                x = x.detach()
            if i >= 2:
                feats[f"c{i + 1}"] = x.permute(0, 2, 3, 1)
        return feats
