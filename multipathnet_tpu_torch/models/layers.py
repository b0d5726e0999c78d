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


def conv(mod: nn.Conv2d, x: torch.Tensor, dtype) -> torch.Tensor:
    """mod's convolution of the NCHW x, computed in dtype, then its bias
    added in dtype."""
    y = F.conv2d(x.to(dtype), mod.weight.to(dtype), None, mod.stride,
                 mod.padding, mod.dilation, mod.groups)
    return y if mod.bias is None else y + mod.bias.to(dtype)[:, None, None]


def linear(mod: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """mod's linear map of x, computed in dtype, then its bias added in
    dtype."""
    y = F.linear(x.to(dtype), mod.weight.to(dtype))
    return y if mod.bias is None else y + mod.bias.to(dtype)
