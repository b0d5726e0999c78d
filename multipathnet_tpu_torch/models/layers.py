"""Layers that store their parameters in one dtype and compute in another.

flax's `nn.Conv(dtype=bf16)` and `nn.Dense(dtype=bf16)` keep float32
parameters and cast them to bf16 at each call. These helpers do the same
with a `nn.Conv2d`/`nn.Linear` as the parameter holder: the weights are cast
to the compute dtype inside the call, so gradients reach the stored
(float32, for training) master copy through the cast. Where the two dtypes
agree (the bf16 eval models) the cast is a no-op.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _cast(p, dtype):
    return None if p is None else p.to(dtype)


def conv(mod: nn.Conv2d, x: torch.Tensor, dtype) -> torch.Tensor:
    """mod's convolution of the NCHW x, computed in dtype."""
    return F.conv2d(x.to(dtype), mod.weight.to(dtype), _cast(mod.bias, dtype),
                    mod.stride, mod.padding, mod.dilation, mod.groups)


def linear(mod: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """mod's affine map of x, computed in dtype."""
    return F.linear(x.to(dtype), mod.weight.to(dtype), _cast(mod.bias, dtype))
