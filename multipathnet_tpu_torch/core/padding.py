"""Static-shape padding/masking conventions — a copy of
multipathnet_tpu/core/padding.py (the port cannot import the JAX package;
tests/test_torch_data.py holds the two equal).

Every ragged axis (proposals, GT boxes, detections) is padded to a fixed size
with an explicit validity mask; every op is expected to honor the mask.
"""

from __future__ import annotations

import numpy as np


def pad_axis_to(x: np.ndarray, size: int, axis: int = 0, value=0.0) -> np.ndarray:
    """Pad (or truncate) `x` along `axis` to exactly `size`."""
    n = x.shape[axis]
    if n == size:
        return x
    if n > size:
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(0, size)
        return x[tuple(sl)]
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, size - n)
    return np.pad(x, pad, constant_values=value)


def pad_to(x: np.ndarray, size: int, value=0.0):
    """Pad axis 0 to `size`; return (padded, valid_mask)."""
    n = min(x.shape[0], size)
    mask = np.zeros((size,), dtype=bool)
    mask[:n] = True
    return pad_axis_to(x, size, 0, value), mask
