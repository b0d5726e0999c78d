"""Detection head — port of multipathnet_tpu/models/heads.py:
MultiPathHead and Int8Dense (here Int8Linear).

Input is the level-summed, pre-reduced pooled tensor (B, F, R, G, G, C),
channel-last. The head adds the shared skip bias + ReLU that completes the
per-level 1x1 reduction (MultiPathNet.features), runs one fc6 -> fc7 branch
per foveal view, and ONE fused GEMM for the K integral classifiers and the
bbox regressor. fc6 reads each view's (G, G, C) block flattened channel-
last, exactly as the reference, so imported weights line up (models/
convert.py keeps that row order). The float GEMMs are F.linear (cuBLAS on
the card); the reference left them to XLA. Parameters are stored in
`param_dtype` and computed in `dtype` (models/layers.py). In train mode
each fc6 and fc7 ReLU is followed by dropout with flax's semantics: keep
with probability 1 - rate, scale kept values by 1 / (1 - rate), the mask
drawn from an explicit generator.

Serving forms (inference only, weights from a load-time transform of a
float checkpoint, eval/detect.serving_params):
  quant="int8": every GEMM is an Int8Linear (ops/quant.py). The pooled
      tensor is quantized once per (ROI, view) row, or arrives already
      quantized from the pool kernels with its scales (`pooled_scale`).
  fc6_rank/fc7_rank = t > 0: that FC family is a bias-free (in -> t)
      factor `{name}_u` followed by the (t -> fc_dim) layer `{name}` that
      keeps the bias, with no ReLU between (ops/lowrank.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multipathnet_tpu_torch.models import layers
from multipathnet_tpu_torch.ops import quant

_INT8_BUFFERS = ("weight_i8", "weight_scale", "bias")


class Int8Linear(nn.Module):
    """The counterpart of the reference's Int8Dense: a per-output-channel
    int8 weight, dynamic per-row int8 activations, the int32 GEMM, the
    float32 rescale and bias, the result in `dtype`.

    Buffers, not parameters (int8 tensors cannot be Parameters): weight_i8
    (N, K) int8 (torch's (out, in) order; models/convert.py maps it to the
    reference's kernel_i8 (K, N)), weight_scale (N,) float32, bias (N,)
    float32. N is padded to a multiple of 8 in memory, once, because
    torch._int_mm takes no other width; the padding is zero weights, unit
    scales and zero bias, and every state-dict round trip drops it."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype=torch.bfloat16, device=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.dtype = dtype
        n_pad = -(-out_features // 8) * 8
        self.register_buffer("weight_i8", torch.zeros(
            (n_pad, in_features), dtype=torch.int8, device=device))
        self.register_buffer("weight_scale", torch.ones(
            n_pad, dtype=torch.float32, device=device))
        self.register_buffer("bias", torch.zeros(
            n_pad, dtype=torch.float32, device=device) if bias else None)

    def _save_to_state_dict(self, destination, prefix, keep_vars):
        super()._save_to_state_dict(destination, prefix, keep_vars)
        for name in _INT8_BUFFERS:
            if prefix + name in destination:
                destination[prefix + name] = (
                    destination[prefix + name][:self.out_features])

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        for name in _INT8_BUFFERS:
            key, own = prefix + name, getattr(self, name)
            t = state_dict.get(key)
            if (own is not None and t is not None and t.dim() == own.dim()
                    and t.shape[0] == self.out_features < own.shape[0]):
                state_dict[key] = torch.cat(
                    [t, own[self.out_features:].to(t.device, t.dtype)])
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor, x_scale: torch.Tensor | None = None):
        """x float (quantized here per row), or int8 with its (M, 1) float32
        row scales."""
        if x_scale is None:
            x, x_scale = quant.quantize_rows(x)
        out = quant.matmul_int8(x, x_scale, self.weight_i8,
                                self.weight_scale, self.bias)
        return out[:, :self.out_features].to(self.dtype)


class MultiPathHead(nn.Module):
    dropout_rate = 0.5  # the reference's; tests set 0 on an instance

    def __init__(self, num_classes: int, foveal_scales=(1.0, 1.5, 2.0, 4.0),
                 num_integral_heads: int = 6, fc_dim: int = 4096,
                 skip_reduce_dim: int = 512, roi_output_size: int = 7,
                 class_specific_bbox: bool = True, dtype=torch.bfloat16,
                 device=None, param_dtype=None, quant: str = "none",
                 fc6_rank: int = 0, fc7_rank: int = 0):
        super().__init__()
        if quant not in ("none", "int8"):
            raise ValueError(f"quant must be 'none' or 'int8', got {quant!r}")
        g, c = roi_output_size, skip_reduce_dim
        if not 0 <= fc6_rank <= min(g * g * c, fc_dim):
            raise ValueError(f"fc6_rank={fc6_rank} exceeds full rank "
                             f"{min(g * g * c, fc_dim)}")
        if not 0 <= fc7_rank <= fc_dim:
            raise ValueError(f"fc7_rank={fc7_rank} exceeds full rank {fc_dim}")
        self.num_classes = num_classes
        self.num_views = len(foveal_scales)
        self.num_integral_heads = num_integral_heads
        self.skip_reduce_dim = skip_reduce_dim
        self.dtype = dtype
        self.quant = quant
        self.serving_only = quant != "none" or bool(fc6_rank or fc7_rank)
        kw = dict(device=device, dtype=param_dtype or dtype)

        def dense(name, k, n, bias=True):
            self.add_module(name, Int8Linear(k, n, bias, dtype, device)
                            if quant == "int8" else nn.Linear(k, n, bias, **kw))

        def fc(name, k, rank):
            if rank:
                dense(f"{name}_u", k, rank, bias=False)
                k = rank
            dense(name, k, fc_dim)

        self.skip_bias = nn.Parameter(torch.zeros(c, **kw))
        for i in range(self.num_views):
            fc(f"fc6_f{i}", g * g * c, fc6_rank)
            fc(f"fc7_f{i}", fc_dim, fc7_rank)
        self.cls_dim = num_integral_heads * num_classes
        bbox_dim = 4 * num_classes if class_specific_bbox else 4
        dense("cls_bbox", self.num_views * fc_dim, self.cls_dim + bbox_dim)

    def _dropout(self, h, train: bool, generator):
        if not train or self.dropout_rate == 0.0:
            return h
        keep = 1.0 - self.dropout_rate
        mask = torch.rand(h.shape, generator=generator,
                          device=h.device) < keep
        return torch.where(mask, h / keep, torch.zeros_like(h))

    def _dense(self, name, x, x_scale=None):
        mod = getattr(self, name)
        if isinstance(mod, Int8Linear):
            return mod(x, x_scale)
        return layers.linear(mod, x, self.dtype)

    def _fc(self, name, x, x_scale=None):
        """One FC: the factor then the named layer when it is factored
        (only the first GEMM takes a pre-quantized input), else the named
        layer alone."""
        if hasattr(self, f"{name}_u"):
            x, x_scale = self._dense(f"{name}_u", x, x_scale), None
        return self._dense(name, x, x_scale)

    def forward(self, pooled: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None,
                pooled_scale: torch.Tensor | None = None):
        """pooled (B, F, R, G, G, C) -> (scores (B*R, K, num_classes) f32,
        bbox_deltas (B*R, D) f32). `generator` draws the dropout masks
        (train mode only). `pooled_scale` (B, F, R, 1) float32: pooled is
        int8 from the pool kernels, skip bias, ReLU and quantization
        already applied (int8 serving only)."""
        b, f, r, g, _, c = pooled.shape
        if f != self.num_views or c != self.skip_reduce_dim:
            raise ValueError(f"pooled {tuple(pooled.shape)} does not match "
                             f"{self.num_views} views x {self.skip_reduce_dim}"
                             f" channels")
        if train and self.serving_only:
            raise ValueError(
                "the int8 and low-rank heads are inference-only; train "
                "full-rank float and transform the checkpoint at load")
        n = b * r
        dt = self.dtype
        if pooled_scale is not None:
            if self.quant != "int8" or pooled.dtype != torch.int8:
                raise ValueError("a pre-quantized pooled input needs the int8"
                                 f" head and int8 input, got {self.quant!r} "
                                 f"and {pooled.dtype}")
            x, xs = pooled.reshape(b, f, r, g * g * c), pooled_scale
        else:
            x = F.relu(pooled.to(dt) + self.skip_bias.to(dt))
            xs = None
            if self.quant == "int8":
                # once per (ROI, view) row, then int8 slices per branch
                x, xs = quant.quantize_rows(x.reshape(b, f, r, g * g * c))
        branches = []
        for i in range(f):
            h = self._fc(f"fc6_f{i}", x[:, i].reshape(n, g * g * c),
                         None if xs is None else xs[:, i].reshape(n, 1))
            h = self._dropout(F.relu(h), train, generator)
            h = F.relu(self._fc(f"fc7_f{i}", h))
            branches.append(self._dropout(h, train, generator))
        out = self._dense("cls_bbox", torch.cat(branches, dim=-1))
        scores = out[:, :self.cls_dim].reshape(
            n, self.num_integral_heads, self.num_classes)
        return scores.float(), out[:, self.cls_dim:].float()
