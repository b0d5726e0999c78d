"""TinyNet — port of the test-sized trunk in
multipathnet_tpu/models/backbones/small.py, so CPU tests can run the whole
slice at the `tiny` preset.

flax `padding="SAME"` on a stride-2 3x3 conv pads (0, 1) over an even size
where `Conv2d(padding=1)` pads (1, 1), so the padding is computed the SAME
way and applied explicitly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def same_pad(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """Pad an NCHW tensor the way XLA's SAME padding does: the total
    (ceil(n / s) - 1) * s + k - n, with the odd cell at the high end."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad takes the last dim first
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class TinyNet(nn.Module):
    """4-conv trunk (8/8/16/32 channels) honoring the c3/c4/c5 contract."""

    feature_strides = {"c3": 4, "c4": 8, "c5": 16}
    feature_channels = {"c3": 8, "c4": 16, "c5": 32}

    def __init__(self, dtype=torch.float32, device=None):
        super().__init__()
        chans = (3, 8, 8, 16, 32)
        for i in range(1, 5):
            self.add_module(f"conv{i}", nn.Conv2d(
                chans[i - 1], chans[i], 3, stride=2, device=device,
                dtype=dtype))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> dict:
        """x (B, H, W, 3) -> {"c3","c4","c5"} NHWC maps."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        feats = {}
        for i in range(1, 5):
            x = F.relu(getattr(self, f"conv{i}")(same_pad(x, 3, 2)))
            if i >= 2:
                feats[f"c{i + 1}"] = x.permute(0, 2, 3, 1)
        return feats
