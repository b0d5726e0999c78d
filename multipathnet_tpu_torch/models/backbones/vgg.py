"""VGG-16 trunk — port of multipathnet_tpu/models/backbones/vgg.py.

Skip levels tap conv3_3 (stride 4), conv4_3 (stride 8) and conv5_3
(stride 16); there is no pool5. The convolutions run through
torch.nn.functional.conv2d (cuDNN on the card, as XLA ran them outside any
Pallas kernel in the reference), in the channels_last memory format so the
NHWC taps the reference returns are free views.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

# (out_channels, num_convs) per block
_CFG = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


class VGG16(nn.Module):
    feature_strides = {"c3": 4, "c4": 8, "c5": 16}
    feature_channels = {"c3": 256, "c4": 512, "c5": 512}

    def __init__(self, dtype=torch.bfloat16, device=None):
        super().__init__()
        in_ch = 3
        for b, (ch, n) in enumerate(_CFG, start=1):
            for c in range(1, n + 1):
                self.add_module(f"conv{b}_{c}", nn.Conv2d(
                    in_ch, ch, 3, padding=1, device=device, dtype=dtype))
                in_ch = ch
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> dict:
        """x (B, H, W, 3) normalized float -> {"c3","c4","c5"} NHWC maps."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = x.contiguous(memory_format=torch.channels_last)
        feats = {}
        for b, (_, n) in enumerate(_CFG, start=1):
            for c in range(1, n + 1):
                x = F.relu(getattr(self, f"conv{b}_{c}")(x))
            if b >= 3:
                feats[f"c{b}"] = x.permute(0, 2, 3, 1)
            if b == 5:
                break  # no pool5: the detector taps conv5_3
            x = F.max_pool2d(x, 2, 2)
        return feats
