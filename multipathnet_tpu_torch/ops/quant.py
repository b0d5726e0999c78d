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
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

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
