"""The frozen-BatchNorm epilogue of a ResNet convolution: normalization,
the rounding to the compute dtype, the residual add and the ReLU.

`bn_epilogue_ref` is the plain version, PyTorch ops in the order that
models/layers.FrozenBatchNorm has always computed them (flax's
`_normalize`, then the block's residual add and ReLU). `bn_epilogue` is
one launch of csrc/bn_epilogue.cu, bit-equal to it, for CUDA tensors in
the layout the trunk's convolutions give (channels-last, C a multiple of
8). It raises on anything else, a CPU tensor included; `takes` says
whether it would, by the same checks.

Under a gradient the epilogue is `BNEpilogue`, an autograd Function with
`bn_epilogue` as its forward and `bn_epilogue_backward` (the same file's
backward kernel) as its backward, which computes the gradients autograd
computes through the plain ops: the input's and the residual's bit for
bit, the scale's and bias's per-channel sums in another order.
`bn_epilogue_backward_ref` is its plain version, autograd's chain written
out; the wrapper runs it for CPU tensors. FrozenBatchNorm picks the
route: BNEpilogue on the card under a gradient, the kernel where no
gradient is recorded there, the plain version elsewhere. Each launch
counts in the counters launches.bn_epilogue and
launches.bn_epilogue_backward (utils/profiling.kernel_launches).
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


def _check(x, dtype, residual=None, **vectors):
    """Raises unless the kernels take x (float32, channels-last contiguous
    and 16-byte aligned on a CUDA device, C % 8 == 0), a residual like it
    in dtype, and the named (C,) vectors (float32, contiguous, 16-byte
    aligned, on x's device)."""
    shape = tuple(x.shape)
    _check_map("x", x, shape, torch.float32)
    c = shape[1]
    if c % 8:
        raise ValueError(f"C = {c}: the kernel takes a multiple of 8")
    if residual is not None:
        _check_map("residual", residual, shape, dtype)
    if x.device.type != "cuda":
        raise ValueError(f"x is on {x.device}: the kernel takes CUDA "
                         f"tensors, FrozenBatchNorm the plain version for "
                         f"others")
    for name, t in vectors.items():
        _check_vector(name, t, c, x.device)
    if residual is not None and residual.device != x.device:
        raise ValueError(f"residual is on {residual.device}, x on "
                         f"{x.device}")


def takes(x: torch.Tensor, dtype, residual: torch.Tensor | None = None,
          **vectors) -> bool:
    """Whether bn_epilogue (and so BNEpilogue) takes x, the residual in
    the compute dtype `dtype` and the vectors (mean=, mul=, bias=): what
    it would otherwise raise on, as _check says."""
    try:
        _check(x, dtype, residual, **vectors)
    except (TypeError, ValueError):
        return False
    return True


def bn_epilogue(x: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
                bias: torch.Tensor, dtype, *, relu: bool = False,
                residual: torch.Tensor | None = None,
                out_dtype=None) -> torch.Tensor:
    """bn_epilogue_ref in one launch of csrc/bn_epilogue.cu, bit for bit:
    x float32 and `residual` (in dtype) channels-last contiguous, C % 8 ==
    0, mean/mul/bias float32 (C,) vectors, all 16-byte aligned on one CUDA
    device; anything else raises. Returns a new channels-last tensor."""
    out_dtype = _out_dtype(dtype, out_dtype)
    _check(x, dtype, residual, mean=mean, mul=mul, bias=bias)
    shape = tuple(x.shape)
    b, c, h, w = shape
    dev = x.device
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


def bn_epilogue_backward_ref(g: torch.Tensor, x: torch.Tensor,
                             mean: torch.Tensor, mul: torch.Tensor,
                             out: torch.Tensor | None, dtype, *,
                             relu: bool = False,
                             residual_grad: bool = False,
                             out_dtype=None) -> tuple:
    """The gradients of bn_epilogue_ref(x, mean, mul, bias, dtype, relu=,
    residual=, out_dtype=) given g, the gradient of its output `out`
    (read where `relu`), as autograd computes them through its ops:
    (x's, the residual's where residual_grad else None, mul's, bias's)."""
    out_dtype = _out_dtype(dtype, out_dtype)
    g = g.to(dtype)   # the widening's backward
    if relu:   # F.relu's backward, on its result in g's dtype
        g = torch.ops.aten.threshold_backward(g, out.to(g.dtype), 0)
    dres = g if residual_grad else None
    g = g.float()     # the rounding's backward
    y = x.float() - mean[:, None, None]
    dmul = (g * y).sum_to_size(mul[:, None, None].shape).view(-1)
    dbias = g.sum_to_size(mul[:, None, None].shape).view(-1)
    return g * mul[:, None, None], dres, dmul, dbias


def bn_epilogue_backward(g: torch.Tensor, x: torch.Tensor,
                         mean: torch.Tensor, mul: torch.Tensor,
                         out: torch.Tensor | None, dtype, *,
                         relu: bool = False, residual_grad: bool = False,
                         out_dtype=None) -> tuple:
    """bn_epilogue_backward_ref in one call of csrc/bn_epilogue.cu's
    backward (two launches: the pass over the maps, then the per-channel
    sums over its blocks in a fixed order): x's and the residual's
    gradients bit for bit, mul's and bias's sums in another order. x,
    mean and mul as bn_epilogue takes them, g in the output dtype (copied
    to channels-last where it arrives in another layout), `out` the
    forward's output where `relu`. CPU tensors take the plain version; any
    other input it does not take raises. The outputs are new tensors,
    channels-last."""
    out_dtype = _out_dtype(dtype, out_dtype)
    if x.device.type == "cpu":
        return bn_epilogue_backward_ref(
            g, x, mean, mul, out, dtype, relu=relu,
            residual_grad=residual_grad, out_dtype=out_dtype)
    _check(x, dtype, mean=mean, mul=mul)
    shape = tuple(x.shape)
    b, c, h, w = shape
    dev = x.device
    if g.dtype != out_dtype or tuple(g.shape) != shape or g.device != dev:
        raise TypeError(f"g must be {out_dtype} {shape} on {dev}, got "
                        f"{g.dtype} {tuple(g.shape)} on {g.device}")
    if not g.is_contiguous(memory_format=torch.channels_last) \
            or g.data_ptr() % 16:
        g = g.clone(memory_format=torch.channels_last)
    if relu:
        _check_map("out", out, shape, out_dtype)
        if out.device != dev:
            raise ValueError(f"out is on {out.device}, x on {dev}")
    cl = dict(device=dev, memory_format=torch.channels_last)
    dx = torch.empty(shape, dtype=torch.float32, **cl)
    dres = torch.empty(shape, dtype=dtype, **cl) if residual_grad else None
    # two tensors, not views of one: a parameter's gradient held by a
    # graph would keep the other's storage too
    dmul, dbias = (torch.empty(c, dtype=torch.float32, device=dev)
                   for _ in range(2))
    if x.numel() == 0:
        return dx, dres, dmul.zero_(), dbias.zero_()
    from multipathnet_tpu_torch.ops import _build

    # a row of the blocks' partial sums for each block, one block an SM
    rows = torch.cuda.get_device_properties(dev).multi_processor_count
    partial = torch.empty((rows, 2, c), dtype=torch.float32, device=dev)
    d = dev.index   # no device context where it is current: host time
    with contextlib.nullcontext() if d == torch.cuda.current_device() \
            else torch.cuda.device(d):
        rc = _build.kernels().mpn_bn_epilogue_backward(
            int(dtype == torch.bfloat16), int(out_dtype == torch.float32),
            int(relu), b * h * w, c, g.data_ptr(), x.data_ptr(),
            mean.data_ptr(), mul.data_ptr(),
            out.data_ptr() if relu else None,
            dx.data_ptr(), None if dres is None else dres.data_ptr(),
            partial.data_ptr(), rows, dbias.data_ptr(), dmul.data_ptr(),
            torch._C._cuda_getCurrentRawStream(d))
    if rc != 0:
        raise RuntimeError(f"bn_epilogue_backward launch failed: "
                           f"cudaError {rc}")
    profiling.count("launches.bn_epilogue_backward")
    return dx, dres, dmul, dbias


class BNEpilogue(torch.autograd.Function):
    """bn_epilogue under autograd: apply(x, mean, mul, bias, residual,
    dtype, relu, out_dtype), the arguments as bn_epilogue takes them
    (residual None for none). It saves x and, with the ReLU, the output;
    its backward is bn_epilogue_backward, which writes the residual's
    gradient only where the residual needs one (autograd drops the other
    gradients of inputs that need none), and gives mean no gradient (the
    running statistics never train)."""

    @staticmethod
    def forward(ctx, x, mean, mul, bias, residual, dtype, relu, out_dtype):
        out = bn_epilogue(x, mean, mul, bias, dtype, relu=relu,
                          residual=residual, out_dtype=out_dtype)
        ctx.save_for_backward(x, mean, mul, out if relu else None)
        ctx.flags = (dtype, relu, out_dtype, residual is not None)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, mean, mul, out = ctx.saved_tensors
        dtype, relu, out_dtype, residual = ctx.flags
        dx, dres, dmul, dbias = bn_epilogue_backward(
            g, x, mean, mul, out, dtype, relu=relu,
            residual_grad=residual and ctx.needs_input_grad[4],
            out_dtype=out_dtype)
        return dx, None, dmul, dbias, dres, None, None, None


# the launch counters, at 0 from import on
profiling.count("launches.bn_epilogue", 0)
profiling.count("launches.bn_epilogue_backward", 0)
