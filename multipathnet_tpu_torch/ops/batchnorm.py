"""The frozen-BatchNorm epilogue of a ResNet convolution: normalization,
the rounding to the compute dtype, the residual add and the ReLU.

`bn_epilogue_ref` is the plain version, PyTorch ops in the order that
models/layers.FrozenBatchNorm has always computed them (flax's
`_normalize`, then the block's residual add and ReLU). `bn_epilogue` is
one launch of csrc/bn_epilogue.cu, bit-equal to it, for CUDA tensors in
the layout the trunk's convolutions give: channels-last, C a multiple of
8. It raises on anything else, a CPU tensor included; FrozenBatchNorm
picks the route (the kernel where no gradient is recorded on the card,
the plain version elsewhere). Each launch counts in the counter
launches.bn_epilogue (utils/profiling.kernel_launches).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from multipathnet_tpu_torch.utils import profiling

_DTYPES = (torch.bfloat16, torch.float32)


def _out_dtype(dtype, out_dtype):
    out_dtype = dtype if out_dtype is None else out_dtype
    if dtype not in _DTYPES or out_dtype not in (dtype, torch.float32):
        raise TypeError(f"compute dtype {dtype} with output {out_dtype}: "
                        f"bf16 out in bf16 or float32, float32 in float32")
    return out_dtype


def bn_epilogue_ref(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
                    bias: torch.Tensor, dtype, *, relu: bool = False,
                    residual: torch.Tensor | None = None,
                    out_dtype=None) -> torch.Tensor:
    """x (B, C, H, W), a convolution's float32 sum: y = x - mean, y * mul,
    y + bias in float32, one cast to dtype; then `residual + y` in dtype
    where a residual is given, F.relu if `relu`, and the cast to
    `out_dtype` (dtype by default; float32 widens a bf16 result)."""
    out_dtype = _out_dtype(dtype, out_dtype)
    y = x.float() - mean[:, None, None]
    y = y * mul[:, None, None]
    y = (y + bias[:, None, None]).to(dtype)
    if residual is not None:
        y = residual + y
    if relu:
        y = F.relu(y)
    return y.to(out_dtype)


def _check_vector(name, t, c, device):
    if t.dtype != torch.float32 or t.shape != (c,) or t.device != device:
        raise TypeError(f"{name} must be a float32 ({c},) vector on "
                        f"{device}, got {t.dtype} {tuple(t.shape)} on "
                        f"{t.device}")
    if t.stride(0) != 1 or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _check_map(name, t, shape, dtype):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != 4 or tuple(t.shape) != shape:
        raise ValueError(f"{name} must be (B, C, H, W) {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous(memory_format=torch.channels_last) \
            or t.data_ptr() % 16:
        raise ValueError(f"{name} must be channels-last contiguous and "
                         f"16-byte aligned, got strides {t.stride()}")


def bn_epilogue(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
                bias: torch.Tensor, dtype, *, relu: bool = False,
                residual: torch.Tensor | None = None,
                out_dtype=None) -> torch.Tensor:
    """bn_epilogue_ref in one launch of csrc/bn_epilogue.cu, bit for bit:
    x float32 and `residual` (in dtype) channels-last contiguous, C % 8 ==
    0, mean/mul/bias float32 (C,) vectors, all 16-byte aligned on one CUDA
    device; anything else raises. Returns a new channels-last tensor."""
    out_dtype = _out_dtype(dtype, out_dtype)
    shape = tuple(x.shape)
    _check_map("x", x, shape, torch.float32)
    b, c, h, w = shape
    if c % 8:
        raise ValueError(f"C = {c}: the kernel takes a multiple of 8")
    if residual is not None:
        _check_map("residual", residual, shape, dtype)
    if x.device.type != "cuda":
        raise ValueError(f"x is on {x.device}: the kernel takes CUDA "
                         f"tensors, FrozenBatchNorm the plain version for "
                         f"others")
    dev = x.device
    for name, t in (("mean", mean), ("mul", mul), ("bias", bias)):
        _check_vector(name, t, c, dev)
    if residual is not None and residual.device != dev:
        raise ValueError(f"residual is on {residual.device}, x on {dev}")
    out = torch.empty(shape, dtype=out_dtype, device=dev,
                      memory_format=torch.channels_last)
    if out.numel() == 0:
        return out
    from multipathnet_tpu_torch.ops import _build

    d = dev.index   # no device context where it is current: host time
    with contextlib.nullcontext() if d == torch.cuda.current_device() \
            else torch.cuda.device(d):
        rc = _build.kernels().mpn_bn_epilogue(
            int(dtype == torch.bfloat16), int(out_dtype == torch.float32),
            int(relu), b * h * w, c, x.data_ptr(), mean.data_ptr(),
            mul.data_ptr(), bias.data_ptr(),
            None if residual is None else residual.data_ptr(),
            out.data_ptr(), torch._C._cuda_getCurrentRawStream(d))
    if rc != 0:
        raise RuntimeError(f"bn_epilogue launch failed: cudaError {rc}")
    profiling.count("launches.bn_epilogue")
    return out


# the launch counter, at 0 from import on
profiling.count("launches.bn_epilogue", 0)
