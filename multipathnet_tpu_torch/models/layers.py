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

from multipathnet_tpu_torch.ops import batchnorm, conv_bn as conv_bn_ops
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
    A float32 x is taken to hold values of dtype already (a ResNet block's
    input widened once, or FrozenBatchNorm's widened output) and is read
    as it is.

    This is what the reference computes where a bf16 convolution feeds a
    BatchNorm: XLA runs the convolution in float32 on the rounded operands
    and, allowed excess precision, drops the round trip through bf16
    between it and the normalization, which rounds once at its end. On the
    card the float32 convolution runs with TF32 allowed when dtype is
    bf16: a bf16 operand is exact in TF32, and the tensor cores sum in
    float32."""
    w = mod.weight.to(dtype).float()
    if x.dtype != torch.float32:
        x = x.to(dtype).float()
    args = (w, None, mod.stride, mod.padding, mod.dilation, mod.groups)
    if not x.is_cuda or dtype == torch.float32:
        return F.conv2d(x, *args)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        return F.conv2d(x, *args)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def fused_conv1x1(mod: nn.Conv2d, dtype) -> bool:
    """Whether mod, followed by a FrozenBatchNorm, has the shape and dtype
    that csrc/conv1x1_bn.cu takes: a bias-free, ungrouped 1x1 convolution
    of stride 1 without padding, computed in bf16, its input and output
    channels multiples of the kernel's 64. (A ResNet-101 trunk's 30
    Conv_0, 30 Conv_2 and stage 2's downsample; not the stride-2
    downsamples, whose rows a tile could not take as one box.)"""
    return (mod.kernel_size == (1, 1) and mod.stride == (1, 1)
            and mod.padding == (0, 0) and mod.dilation == (1, 1)
            and mod.groups == 1 and mod.bias is None
            and dtype == torch.bfloat16
            and mod.in_channels % conv_bn_ops.CHANNELS == 0
            and mod.out_channels % conv_bn_ops.CHANNELS == 0)


def takes_conv1x1_bn(mod: nn.Conv2d, x: torch.Tensor, dtype) -> bool:
    """Whether conv_bn runs mod and its BN on x as one launch of
    csrc/conv1x1_bn.cu: x on the card, no gradient recorded, and mod as
    fused_conv1x1 takes it."""
    return (not torch.is_grad_enabled() and x.is_cuda
            and fused_conv1x1(mod, dtype))


def tensor_state(*ts) -> tuple | None:
    """What a cache computed from the tensors ts keys on: each one's id,
    storage and version; None for inference tensors, which keep no
    version (a cache then computes again every time). The cache holds the
    tensors themselves, so their ids stay theirs."""
    try:
        return tuple([(id(t), t.data_ptr(), t._version) for t in ts])
    except RuntimeError:   # an inference tensor
        return None


def packed_weight(mod: nn.Conv2d) -> torch.Tensor:
    """mod's 1x1 weight as csrc/conv1x1_bn.cu reads it: bf16 (C_out, C_in),
    contiguous (a view of a bf16 weight, else its cast), computed again
    whenever the weight's tensor_state changes."""
    w = mod._parameters["weight"]
    state = tensor_state(w)
    cached = mod.__dict__.get("_packed_weight")
    if state is None or cached is None or cached[1] != state:
        packed = w.detach().to(torch.bfloat16).reshape(
            w.shape[0], w.shape[1]).contiguous()
        cached = mod.__dict__["_packed_weight"] = (w, state, packed)
    return cached[2]


def conv_bn(mod: nn.Conv2d, bn: "FrozenBatchNorm", x: torch.Tensor, dtype,
            **epilogue) -> torch.Tensor:
    """mod's bias-free convolution of the NCHW x, then bn on its float32
    sum in dtype with what follows it (FrozenBatchNorm.forward's relu,
    residual and out_dtype). Where takes_conv1x1_bn holds (serving a bf16
    trunk on the card) the two are one launch of csrc/conv1x1_bn.cu on the
    bf16 x (ops/conv_bn.conv1x1_bn), which counts bn.passes as the BN
    does; elsewhere conv_f32 and bn."""
    if takes_conv1x1_bn(mod, x, dtype):
        profiling.count("bn.passes")
        return conv_bn_ops.conv1x1_bn(x, packed_weight(mod), *bn.affine(),
                                      **epilogue)
    return bn(conv_f32(mod, x, dtype), dtype, **epilogue)


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

    The forward also takes what follows a ResNet convolution's BN: the
    residual add and the ReLU, and the output widened to float32 where a
    convolution is its only reader (ops/batchnorm.bn_epilogue_ref says
    how). Where no gradient is recorded and x is on the card (serving,
    under inference_mode) that is one launch of csrc/bn_epilogue.cu, bit
    for bit the plain ops, with mul computed once while the parameters
    and statistics are unchanged; elsewhere (training, where scale and
    bias train, and the CPU) the plain ops.

    Each forward adds one to the counter bn.passes (utils/profiling), as
    conv_bn does for a BN it runs with its convolution: 94 a ResNet-101
    trunk's forward, 0 for VGG-16."""

    def __init__(self, channels: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        f32 = dict(device=device, dtype=torch.float32)
        self.weight = nn.Parameter(torch.ones(channels, **f32))
        self.bias = nn.Parameter(torch.zeros(channels, **f32))
        self.register_buffer("running_mean", torch.zeros(channels, **f32))
        self.register_buffer("running_var", torch.ones(channels, **f32))
        self._affine = None   # affine()'s (tensors, state, rows)

    def mul(self) -> torch.Tensor:
        """rsqrt(var + eps) * scale, as flax computes it."""
        return torch.rsqrt(self.running_var + self.eps) * self.weight

    def affine(self) -> tuple:
        """(mean, mul, bias) as the kernels read them: rows of one (3, C)
        float32 tensor, computed again whenever the tensor_state of a
        parameter or statistic changes."""
        b, p = self._buffers, self._parameters
        ts = (b["running_mean"], b["running_var"], p["weight"], p["bias"])
        state = tensor_state(*ts)
        cached = self._affine
        if state is None or cached is None or cached[1] != (state, self.eps):
            rows = torch.stack([ts[0], self.mul(), ts[3]]).unbind(0)
            cached = self._affine = (ts, (state, self.eps), rows)
        return cached[2]

    def forward(self, x: torch.Tensor, dtype, *, relu: bool = False,
                residual: torch.Tensor | None = None,
                out_dtype=None) -> torch.Tensor:
        """x (B, C, H, W) float32 -> the same shape in out_dtype (dtype by
        default): normalized, rounded to dtype, `residual` (dtype) added,
        then the ReLU if `relu`."""
        profiling.count("bn.passes")
        flags = dict(relu=relu, residual=residual, out_dtype=out_dtype)
        if x.device.type == "cpu" or torch.is_grad_enabled():
            return batchnorm.bn_epilogue_ref(
                x, self.running_mean, self.mul(), self.bias, dtype, **flags)
        return batchnorm.bn_epilogue(x, *self.affine(), dtype, **flags)
