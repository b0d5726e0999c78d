"""Int8 quantization of the FC detection heads (serving only) — port of
multipathnet_tpu/ops/quant.py.

Weights: symmetric per-output-channel int8, quantized once at load
(`quantize_head_params`). Activations: symmetric per-row int8, quantized in
the forward (`quantize_rows`). The int8 x int8 product accumulates in int32
and is rescaled in float32 by (row scale x column scale).

Both quantizers round half to even (`torch.round`), as jnp.round does; C's
roundf would round half away from zero. Where the reference's arithmetic
depends on how XLA compiles it, the port mirrors what the reference
computes where it runs (each case is named below and held by
tests/test_torch_quant.py).

The int8 GEMM is left to a library call, as the reference leaves it to
lax.dot_general outside any Pallas kernel: `torch._int_mm` on the card,
an int32 `torch.matmul` of the widened operands on the CPU (exact, as is
the int32 accumulation on the card: 25088 * 127^2 < 2^31).

The serving head (models/heads.py) runs the steps around that GEMM through
two wrappers: `quantize_rows_padded` (an input's row quantize, its codes
padded to the weight's K) and `int8_epilogue` (rescale, bias, the cast to
the compute dtype and the ReLU, written into a column slice if asked). For
a CUDA tensor each launches its kernel (csrc/int8_head.cu) or raises; for a
CPU tensor each runs the plain functions below. Each counts its launches
in the counter launches.int8_epilogue or launches.quantize_rows
(utils/profiling.kernel_launches). The plain functions
(`quantize_rows`, `rescale_int32`, `matmul_int8`) never launch a kernel.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from multipathnet_tpu_torch.utils import profiling

# float32(1/127): the reference's jnp.float32(1.0 / 127.0)
INV_127 = float(np.float32(1.0 / 127.0))


def quantize_weight(w: torch.Tensor):
    """(K, N) float kernel -> ((K, N) int8, (N,) float32 per-output-channel
    scale), w ~= w_i8 * scale[None, :]. The scale is amax / 127, a true
    division, as the reference computes it eagerly in Detector's load
    transform (under jax.jit XLA rewrites it to amax * (1/127), which can
    differ by one ulp); a zero column gets scale 1e-12."""
    w = w.float()
    scale = torch.clamp(w.abs().amax(dim=0) / 127.0, min=1e-12)
    w_i8 = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return w_i8, scale


def row_amax(x: torch.Tensor) -> torch.Tensor:
    """(..., K) -> (..., 1) float32 largest magnitude of each row."""
    return x.float().abs().amax(dim=-1, keepdim=True)


def quantize_rows(x: torch.Tensor, amax: torch.Tensor | None = None):
    """(..., K) float activations -> ((..., K) int8, (..., 1) float32 row
    scale). The scale is amax * float32(1/127), a constant multiply and not
    amax / 127, exactly as the reference (a one-ulp gap in the scale flips
    round() ties). `amax` (..., 1), when given, is each row's largest
    magnitude over the whole row of which x holds some columns (a
    row-parallel layer's input, models/heads.py)."""
    xf = x.float()
    if amax is None:
        amax = row_amax(xf)
    scale = torch.clamp(amax * INV_127, min=1e-12)
    x_i8 = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return x_i8, scale


def int_mm(x_i8: torch.Tensor, w_nk: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (N, K) int8 -> (M, N) int32 = x @ w_nk.T.

    On the card torch._int_mm, which takes M > 16 and K, N multiples of 8:
    a batch of 16 rows or fewer is padded with zero rows, and N is the
    caller's to pad (Int8Linear pads its weights once, at load). The
    weight passes as the transpose of a row-major (N, K) tensor, the
    column-major operand cuBLASLt's int8 GEMM takes."""
    x_i8 = x_i8.contiguous()
    if x_i8.device.type == "cpu":
        return torch.matmul(x_i8.int(), w_nk.int().t())
    m, k = x_i8.shape
    if k % 8 or w_nk.shape[0] % 8:
        raise ValueError(f"torch._int_mm needs K and N multiples of 8, got "
                         f"K={k}, N={w_nk.shape[0]}")
    if m <= 16:
        x_i8 = torch.cat([x_i8, x_i8.new_zeros((17 - m, k))])
    return torch._int_mm(x_i8, w_nk.t())[:m]


def matmul_int8(x_i8: torch.Tensor, x_scale: torch.Tensor,
                w_nk: torch.Tensor, w_scale: torch.Tensor,
                bias: torch.Tensor | None = None) -> torch.Tensor:
    """int8 x int8 -> int32 GEMM on pre-quantized operands (w_nk is the
    (N, K) int8 weight, w_scale (N,)), rescaled in float32:
    float32(acc) * (x_scale * w_scale) + bias, in the reference's order.
    Under jax.jit XLA contracts that multiply and add into one fused
    multiply-add, one rounding; the port rounds once too: addcmul computes
    in float64, where the product of two float32 is exact, and its sum is
    rounded to the float32 output (a double rounding that differs from a
    true fused multiply-add only on an exact float32 tie of the float64
    sum). Returns float32."""
    return rescale_int32(int_mm(x_i8, w_nk), x_scale, w_scale, bias)


def rescale_int32(acc: torch.Tensor, x_scale: torch.Tensor,
                  w_scale: torch.Tensor,
                  bias: torch.Tensor | None = None) -> torch.Tensor:
    """matmul_int8's epilogue on the int32 products: float32(acc) *
    (x_scale * w_scale) + bias, rounded once."""
    acc = acc.float()
    sc = x_scale * w_scale
    if bias is None:
        return acc * sc
    return torch.addcmul(bias.double(), acc, sc, out=torch.empty_like(acc))


# the widest row csrc/int8_head.cu's quantize holds in registers
MAX_ROW = 32768
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _cuda_only(name, t):
    if t.device.type != "cuda":
        raise ValueError(f"{name} is on {t.device}: the kernel takes CUDA "
                         f"tensors, the plain version CPU ones")


def _check_vector(name, t, n, device):
    if t.device != device or t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32 on {device}, got {t.dtype}"
                        f" on {t.device}")
    if t.shape != (n,) or t.data_ptr() % 16:
        raise ValueError(f"{name} must be a 16-byte aligned ({n},) vector, "
                         f"got {tuple(t.shape)}")


def quantize_rows_padded(x: torch.Tensor, width: int,
                         amax: torch.Tensor | None = None):
    """(M, K) float activations -> ((M, width) int8 codes, (M, 1) float32
    row scales): quantize_rows' codes and scales, with zero codes in the
    columns K..width (an Int8Linear's input padded to its weight's K).
    `amax` (M, 1) as quantize_rows takes it.

    On a CUDA tensor one launch of csrc/int8_head.cu's row quantize: x
    bf16 or float32 with its last dimension contiguous (any row stride),
    K <= MAX_ROW; anything else raises. On a CPU tensor its plain version,
    quantize_rows_padded_ref."""
    if x.dim() != 2:
        raise ValueError(f"x must be (M, K), got {tuple(x.shape)}")
    m, k = x.shape
    if width < k:
        raise ValueError(f"width {width} is narrower than K = {k}")
    if x.device.type == "cpu":
        return quantize_rows_padded_ref(x, width, amax)
    _cuda_only("x", x)
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"x must be bfloat16 or float32, got {x.dtype}")
    if k > MAX_ROW or (k > 1 and x.stride(1) != 1) or x.stride(0) < k:
        raise ValueError(f"x {tuple(x.shape)} with strides {x.stride()}: "
                         f"rows of at most {MAX_ROW} contiguous elements")
    dev = x.device
    if amax is not None:
        if amax.numel() != m:
            raise ValueError(f"amax has {amax.numel()} values for {m} rows")
        amax = amax.reshape(m).contiguous()
        _check_vector("amax", amax, m, dev)
    codes = torch.empty((m, width), dtype=torch.int8, device=dev)
    scale = torch.empty((m, 1), dtype=torch.float32, device=dev)
    if m == 0:
        return codes, scale
    from multipathnet_tpu_torch.ops import _build

    with torch.cuda.device(dev):
        rc = _build.kernels().mpn_quantize_rows(
            _KERNEL_DTYPES[x.dtype], m, k, x.stride(0), width, x.data_ptr(),
            None if amax is None else amax.data_ptr(), codes.data_ptr(),
            scale.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quantize_rows launch failed: cudaError {rc}")
    profiling.count("launches.quantize_rows")
    return codes, scale


def quantize_rows_padded_ref(x: torch.Tensor, width: int,
                             amax: torch.Tensor | None = None):
    """Plain version of quantize_rows_padded: quantize_rows, then zero
    codes up to `width` columns."""
    q, s = quantize_rows(x, amax)
    k = q.shape[-1]
    return (q if width == k else F.pad(q, (0, width - k))), s


def int8_epilogue(acc: torch.Tensor, x_scale: torch.Tensor,
                  w_scale: torch.Tensor, bias: torch.Tensor | None = None,
                  *, width: int | None = None, dtype=torch.float32,
                  relu: bool = False, out: torch.Tensor | None = None):
    """rescale_int32 of the (M, N_pad) int32 products, its first `width`
    columns (all by default) rounded to `dtype`, then the ReLU if `relu`
    (as F.relu after the cast). Written into `out` (M, width) when given,
    a view with any row stride (a column slice of a wider buffer), else
    into a new tensor; returns it. x_scale has M values, w_scale and bias
    (N_pad,) float32.

    On a CUDA tensor one launch of csrc/int8_head.cu's epilogue, whose
    true fused multiply-add differs from rescale_int32's float64 sum only
    where that sum is an exact float32 tie: acc int32, contiguous, 16-byte
    aligned, N_pad % 4 == 0, `dtype` bf16 or float32; anything else
    raises. On a CPU tensor its plain version, int8_epilogue_ref."""
    if acc.dim() != 2:
        raise ValueError(f"acc must be (M, N), got {tuple(acc.shape)}")
    m, n_pad = acc.shape
    width = n_pad if width is None else width
    if not 0 < width <= n_pad:
        raise ValueError(f"width {width} outside 1..{n_pad}")
    if out is not None and (tuple(out.shape) != (m, width)
                            or out.dtype != dtype):
        raise ValueError(f"out must be ({m}, {width}) {dtype}, got "
                         f"{tuple(out.shape)} {out.dtype}")
    if acc.device.type == "cpu":
        return int8_epilogue_ref(acc, x_scale, w_scale, bias, width=width,
                                 dtype=dtype, relu=relu, out=out)
    _cuda_only("acc", acc)
    dev = acc.device
    if acc.dtype != torch.int32 or not acc.is_contiguous() or n_pad % 4 \
            or acc.data_ptr() % 16:
        raise ValueError(f"acc must be contiguous 16-byte aligned int32 "
                         f"with N % 4 == 0, got {acc.dtype} "
                         f"{tuple(acc.shape)}")
    if dtype not in _KERNEL_DTYPES:
        raise TypeError(f"dtype must be bfloat16 or float32, got {dtype}")
    if x_scale.numel() != m:
        raise ValueError(f"x_scale has {x_scale.numel()} values for {m} "
                         f"rows")
    x_scale = x_scale.reshape(m).contiguous()
    _check_vector("x_scale", x_scale, m, dev)
    _check_vector("w_scale", w_scale, n_pad, dev)
    if bias is not None:
        _check_vector("bias", bias, n_pad, dev)
    if out is None:
        out = torch.empty((m, width), dtype=dtype, device=dev)
    elif out.device != dev or (width > 1 and out.stride(1) != 1) \
            or out.stride(0) < width:
        raise ValueError(f"out on {out.device} with strides {out.stride()}:"
                         f" rows of contiguous elements on {dev}")
    if m == 0:
        return out
    from multipathnet_tpu_torch.ops import _build

    with torch.cuda.device(dev):
        rc = _build.kernels().mpn_int8_epilogue(
            _KERNEL_DTYPES[dtype], int(relu), m, n_pad, width, out.stride(0),
            acc.data_ptr(), x_scale.data_ptr(), w_scale.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8_epilogue launch failed: cudaError {rc}")
    profiling.count("launches.int8_epilogue")
    return out


def int8_epilogue_ref(acc, x_scale, w_scale, bias=None, *, width=None,
                      dtype=torch.float32, relu=False, out=None):
    """Plain version of int8_epilogue: rescale_int32, the first `width`
    columns, the cast to `dtype`, F.relu if `relu`, copied into `out` when
    given."""
    y = rescale_int32(acc, x_scale, w_scale, bias)[:, :width].to(dtype)
    if relu:
        y = F.relu(y)
    return y if out is None else out.copy_(y)


def quantize_rows_padded_ref(x: torch.Tensor, width: int,
                             amax: torch.Tensor | None = None):
    """Plain version of quantize_rows_padded: quantize_rows, then zero
    codes up to `width` columns."""
    q, s = quantize_rows(x, amax)
    k = q.shape[-1]
    return (q if width == k else F.pad(q, (0, width - k))), s


# the launch counters, at 0 from import on
profiling.count("launches.int8_epilogue", 0)
profiling.count("launches.quantize_rows", 0)


def dense_int8(x: torch.Tensor, w_nk: torch.Tensor, w_scale: torch.Tensor,
               bias: torch.Tensor | None = None) -> torch.Tensor:
    """Quantized `x @ w.T + b`: per-row int8 activations, the int8 GEMM,
    the float32 rescale. Returns float32."""
    x_i8, x_scale = quantize_rows(x)
    return matmul_int8(x_i8, x_scale, w_nk, w_scale, bias)


def _is_head_dense(name: str) -> bool:
    return name.startswith(("fc6_f", "fc7_f")) or name == "cls_bbox"


def quantize_head_params(params):
    """Load transform: every fc6_f*/fc7_f*/cls_bbox {kernel, bias} of a
    flax-layout tree (nested dicts; numpy or torch leaves) becomes
    {kernel_i8 (K, N), kernel_scale (N,), bias}, the int8 layout. The
    rest of the tree is untouched. numpy leaves give numpy leaves; torch
    leaves are quantized on their own device."""

    def quantize(w):
        if isinstance(w, torch.Tensor):
            return quantize_weight(w)
        w_i8, scale = quantize_weight(torch.from_numpy(
            np.asarray(w, np.float32)))
        return w_i8.numpy(), scale.numpy()

    def walk(d):
        out = {}
        for k, v in d.items():
            if isinstance(v, Mapping) and _is_head_dense(k) and "kernel" in v:
                w_i8, scale = quantize(v["kernel"])
                out[k] = {"kernel_i8": w_i8, "kernel_scale": scale,
                          **({"bias": v["bias"]} if "bias" in v else {})}
            elif isinstance(v, Mapping):
                out[k] = walk(v)
            else:
                out[k] = v
        return out

    return walk(params)


def is_quantized(params) -> bool:
    """True if a flax-layout tree carries int8 head layers."""
    return "kernel_i8" in params or any(
        is_quantized(v) for v in params.values() if isinstance(v, Mapping))
