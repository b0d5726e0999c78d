"""A ResNet 1x1 convolution and the frozen BatchNorm after it, in one
launch on the card.

`conv1x1_bn_ref` is the plain version: the float32 convolution of the bf16
operands, as models/layers.conv_f32 computes it, then
ops/batchnorm.bn_epilogue_ref (the BN in three float32 roundings, the
rounding to bf16, the residual add, the ReLU, the output widened to
float32 where asked). `conv1x1_bn` runs it for CPU tensors and, for CUDA
tensors, launches csrc/conv1x1_bn.cu: the bf16 GEMM on the tensor cores
with float32 accumulators and the same epilogue in its registers, so that
the two differ only in the order of the float32 additions. It takes x
(B, C_in, H, W) bf16 channels-last, the weight as bf16 (C_out, C_in),
C_in and C_out multiples of 64, a bf16 residual only with a bf16 output,
every tensor 16-byte aligned on one device, and raises on anything else,
on every device. models/layers.conv_bn picks the route. Each launch counts
in the counter launches.conv1x1_bn (utils/profiling.kernel_launches).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from multipathnet_tpu_torch.ops import _build, batchnorm
from multipathnet_tpu_torch.utils import profiling

BF16 = torch.bfloat16
# the kernel's granularity of C_in (one 64-channel stage of K) and C_out
# (its narrowest tile)
CHANNELS = 64


def conv1x1_bn_ref(x: torch.Tensor, weight: torch.Tensor, mean: torch.Tensor,
                   mul: torch.Tensor, bias: torch.Tensor, *,
                   relu: bool = False, residual: torch.Tensor | None = None,
                   out_dtype=None) -> torch.Tensor:
    """x (B, C_in, H, W) bf16 and weight (C_out, C_in) bf16: F.conv2d of
    their float32 widenings (layers.conv_f32's sum), then
    bn_epilogue_ref in bf16 with the flags."""
    y = F.conv2d(x.float(), weight.float()[:, :, None, None])
    return batchnorm.bn_epilogue_ref(y, mean, mul, bias, BF16, relu=relu,
                                     residual=residual, out_dtype=out_dtype)


def _check(x, weight, mean, mul, bias, residual, out_dtype) -> None:
    """Raises unless the kernel takes the arguments (module docstring).
    On the card its tests are cheap ones (no message is built unless one
    fails): a trunk's pace can hang on the wrapper's host time."""
    if out_dtype != BF16 and out_dtype != torch.float32:
        raise TypeError(f"output {out_dtype}: bf16 or float32")
    if x.dtype != BF16 or weight.dtype != BF16:
        raise TypeError(f"x and weight must be bf16, got {x.dtype} and "
                        f"{weight.dtype}")
    xs, ws = x.shape, weight.shape
    if len(xs) != 4 or len(ws) != 2 or ws[1] != xs[1]:
        raise ValueError(f"x (B, C_in, H, W) and weight (C_out, C_in), got "
                         f"{tuple(xs)} and {tuple(ws)}")
    if xs[1] % CHANNELS or ws[0] % CHANNELS:
        raise ValueError(f"C_in = {xs[1]}, C_out = {ws[0]}: the kernel "
                         f"takes multiples of {CHANNELS}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"x must be channels-last contiguous, got strides "
                         f"{x.stride()}")
    if not weight.is_contiguous():
        raise ValueError("weight must be contiguous")
    vec = (ws[0],)
    for name, t in (("mean", mean), ("mul", mul), ("bias", bias)):
        if t.dtype != torch.float32 or t.shape != vec or t.stride(0) != 1:
            raise TypeError(f"{name} must be a contiguous float32 {vec} "
                            f"vector, got {t.dtype} {tuple(t.shape)}")
    if residual is not None:
        if out_dtype != BF16:
            raise ValueError("the kernel adds a residual only to a bf16 "
                             "output")
        shape = (xs[0], ws[0], xs[2], xs[3])
        if residual.dtype != BF16 or residual.shape != shape:
            raise TypeError(f"residual must be bf16 {shape}, got "
                            f"{residual.dtype} {tuple(residual.shape)}")
        if not residual.is_contiguous(memory_format=torch.channels_last):
            raise ValueError("residual must be channels-last contiguous")
    d = x.get_device()   # -1 off the card: then compare the devices
    for name, t in (("x", x), ("weight", weight), ("mean", mean),
                    ("mul", mul), ("bias", bias), ("residual", residual)):
        if t is None:
            continue
        if t.get_device() != d or d < 0 and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def conv1x1_bn(x: torch.Tensor, weight: torch.Tensor, mean: torch.Tensor,
               mul: torch.Tensor, bias: torch.Tensor, *, relu: bool = False,
               residual: torch.Tensor | None = None,
               out_dtype=None) -> torch.Tensor:
    """conv1x1_bn_ref, in one launch of csrc/conv1x1_bn.cu for CUDA
    tensors. Returns a new channels-last (B, C_out, H, W) tensor in
    out_dtype (bf16 by default, or float32)."""
    out_dtype = BF16 if out_dtype is None else out_dtype
    _check(x, weight, mean, mul, bias, residual, out_dtype)
    if not x.is_cuda:
        if x.device.type != "cpu":
            raise ValueError(f"x is on {x.device}: the kernel takes CUDA "
                             f"tensors, its plain version CPU tensors")
        return conv1x1_bn_ref(x, weight, mean, mul, bias, relu=relu,
                              residual=residual, out_dtype=out_dtype)
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    out = torch.empty((b, cout, h, w), dtype=out_dtype, device=x.device,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    d = x.get_device()
    with contextlib.nullcontext() if d == torch.cuda.current_device() \
            else torch.cuda.device(d):
        rc = _build.kernels().mpn_conv1x1_bn(
            relu, out_dtype == torch.float32, b * h * w, cin, cout,
            x.data_ptr(), weight.data_ptr(), mean.data_ptr(),
            mul.data_ptr(), bias.data_ptr(),
            None if residual is None else residual.data_ptr(),
            out.data_ptr(), torch._C._cuda_getCurrentRawStream(d))
    if rc != 0:
        raise RuntimeError(f"conv1x1_bn launch failed: cudaError {rc}")
    profiling.count("launches.conv1x1_bn")
    return out


# the launch counter, at 0 from import on
profiling.count("launches.conv1x1_bn", 0)
