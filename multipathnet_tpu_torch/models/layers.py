"""Layers that store their parameters in one dtype and compute in another.

flax's `nn.Conv(dtype=bf16)` and `nn.Dense(dtype=bf16)` keep float32
parameters and cast them to bf16 at each call. These helpers do the same
with a `nn.Conv2d`/`nn.Linear` as the parameter holder: the weights are cast
to the compute dtype inside the call, so gradients reach the stored
(float32, for training) master copy through the cast. Where the two dtypes
agree (the bf16 eval models) the cast is a no-op.

The bias is added after the product, in the compute dtype, as flax adds it:
in bf16 the product is rounded to bf16 and the sum rounded again. Passing
the bias into F.conv2d/F.linear would add it before the one rounding to
bf16, and about a quarter of a bf16 layer's outputs would differ from the
reference's by one bf16 step. The price is one more elementwise pass over
each biased layer's output.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multipathnet_tpu_torch.utils import profiling


def conv(mod: nn.Conv2d, x: torch.Tensor, dtype) -> torch.Tensor:
    """mod's convolution of the NCHW x, computed in dtype, then its bias
    added in dtype."""
    y = F.conv2d(x.to(dtype), mod.weight.to(dtype), None, mod.stride,
                 mod.padding, mod.dilation, mod.groups)
    return y if mod.bias is None else y + mod.bias.to(dtype)[:, None, None]


def conv_f32(mod: nn.Conv2d, x: torch.Tensor, dtype) -> torch.Tensor:
    """mod's bias-free convolution of the NCHW x with both operands rounded
    to dtype, its sum returned in float32 without the rounding to dtype.

    This is what the reference computes where a bf16 convolution feeds a
    BatchNorm: XLA runs the convolution in float32 on the rounded operands
    and, allowed excess precision, drops the round trip through bf16
    between it and the normalization, which rounds once at its end. On the
    card the float32 convolution runs with TF32 allowed when dtype is
    bf16: a bf16 operand is exact in TF32, and the tensor cores sum in
    float32."""
    w = mod.weight.to(dtype)
    x = x.to(dtype)
    if dtype != torch.float32:
        w, x = w.float(), x.float()
    args = (w, None, mod.stride, mod.padding, mod.dilation, mod.groups)
    if not x.is_cuda or dtype == torch.float32:
        return F.conv2d(x, *args)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        return F.conv2d(x, *args)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def linear(mod: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """mod's linear map of x, computed in dtype, then its bias added in
    dtype."""
    y = F.linear(x.to(dtype), mod.weight.to(dtype))
    return y if mod.bias is None else y + mod.bias.to(dtype)


class FrozenBatchNorm(nn.Module):
    """BatchNorm with frozen statistics, flax's `nn.BatchNorm(
    use_running_average=True)` in train and eval alike: the running mean
    and variance are buffers (never trained, never decayed), the scale
    (`weight`) and `bias` parameters. Both stay float32 whatever the
    model's parameter dtype, as flax keeps them.

    The arithmetic is flax 0.12.3's `_normalize`, in its order: y = x -
    mean in float32, mul = rsqrt(var + eps) * scale, y = y * mul + bias in
    two float32 roundings, then one cast to the compute dtype. The input
    is the float32 output of `conv_f32` (module docstring there). Folding
    the affine into the convolution, or F.batch_norm (which may fold it
    into one scale and shift), rounds differently.

    Each forward adds one to the counter bn.passes (utils/profiling): 94
    a ResNet-101 trunk's forward, 0 for VGG-16."""

    def __init__(self, channels: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        f32 = dict(device=device, dtype=torch.float32)
        self.weight = nn.Parameter(torch.ones(channels, **f32))
        self.bias = nn.Parameter(torch.zeros(channels, **f32))
        self.register_buffer("running_mean", torch.zeros(channels, **f32))
        self.register_buffer("running_var", torch.ones(channels, **f32))

    def forward(self, x: torch.Tensor, dtype) -> torch.Tensor:
        """x (B, C, H, W) -> the same shape in the compute dtype."""
        profiling.count("bn.passes")
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = x.float() - self.running_mean[:, None, None]
        y = y * mul[:, None, None]
        return (y + self.bias[:, None, None]).to(dtype)
