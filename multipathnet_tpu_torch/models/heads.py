"""Detection head — port of the bf16/float path of
multipathnet_tpu/models/heads.py: MultiPathHead.

Input is the level-summed, pre-reduced pooled tensor (B, F, R, G, G, C),
channel-last. The head adds the shared skip bias + ReLU that completes the
per-level 1x1 reduction (MultiPathNet.features), runs one fc6 -> fc7 branch
per foveal view, and ONE fused GEMM for the K integral classifiers and the
bbox regressor. fc6 reads each view's (G, G, C) block flattened channel-
last, exactly as the reference, so imported weights line up (models/
convert.py keeps that row order). The GEMMs are F.linear (cuBLAS on the
card); the reference left them to XLA. Eval only: dropout is the identity.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class MultiPathHead(nn.Module):
    def __init__(self, num_classes: int, foveal_scales=(1.0, 1.5, 2.0, 4.0),
                 num_integral_heads: int = 6, fc_dim: int = 4096,
                 skip_reduce_dim: int = 512, roi_output_size: int = 7,
                 class_specific_bbox: bool = True, dtype=torch.bfloat16,
                 device=None):
        super().__init__()
        self.num_classes = num_classes
        self.num_views = len(foveal_scales)
        self.num_integral_heads = num_integral_heads
        self.skip_reduce_dim = skip_reduce_dim
        self.dtype = dtype
        g, c = roi_output_size, skip_reduce_dim
        kw = dict(device=device, dtype=dtype)
        self.skip_bias = nn.Parameter(torch.zeros(c, **kw))
        for i in range(self.num_views):
            self.add_module(f"fc6_f{i}", nn.Linear(g * g * c, fc_dim, **kw))
            self.add_module(f"fc7_f{i}", nn.Linear(fc_dim, fc_dim, **kw))
        self.cls_dim = num_integral_heads * num_classes
        bbox_dim = 4 * num_classes if class_specific_bbox else 4
        self.cls_bbox = nn.Linear(self.num_views * fc_dim,
                                  self.cls_dim + bbox_dim, **kw)

    def forward(self, pooled: torch.Tensor):
        """pooled (B, F, R, G, G, C) -> (scores (B*R, K, num_classes) f32,
        bbox_deltas (B*R, D) f32)."""
        b, f, r, g, _, c = pooled.shape
        if f != self.num_views or c != self.skip_reduce_dim:
            raise ValueError(f"pooled {tuple(pooled.shape)} does not match "
                             f"{self.num_views} views x {self.skip_reduce_dim}"
                             f" channels")
        n = b * r
        x = F.relu(pooled.to(self.dtype) + self.skip_bias.to(self.dtype))
        branches = []
        for i in range(f):
            h = F.relu(getattr(self, f"fc6_f{i}")(
                x[:, i].reshape(n, g * g * c)))
            branches.append(F.relu(getattr(self, f"fc7_f{i}")(h)))
        out = self.cls_bbox(torch.cat(branches, dim=-1))
        scores = out[:, :self.cls_dim].reshape(
            n, self.num_integral_heads, self.num_classes)
        return scores.float(), out[:, self.cls_dim:].float()
