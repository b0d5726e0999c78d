"""Weights from the seed for a ResNet trunk with frozen BatchNorm, drawn
on the device.

bench.py's draw (benchmark/weights.py: every entry normal * 0.02) makes
about half of the BatchNorm running variances negative, and a ResNet's
features then come out NaN. This draw keeps a 101-layer trunk finite and
its taps of a useful size. A configuration's `weights`
{"draw": "he_bn", "std": s, "bn_weight": [lo, hi], "bn_bias_std": b,
 "bn_mean_std": m, "bn_var": [lo, hi]} draws, entry by entry in
state-dict order from one torch.Generator on the device:

- the trunk's convolutions (4-D entries under `backbone.`): He-normal,
  normal * sqrt(2 / fan_in);
- each frozen BatchNorm (1-D entries under `backbone.`): `weight`
  uniform in bn_weight, `bias` normal * bn_bias_std, `running_mean`
  normal * bn_mean_std, `running_var` uniform in bn_var (always
  positive);
- everything else (the 1x1 reductions, the head): normal * s, as the
  VGG-16 cell draws it.

The result is a plain {name: float32 tensor} dict, the checkpoint that
both the program and the reference are given.
"""

from __future__ import annotations

import math

import torch

from benchmark.weights import seed64

BN = {"weight": "bn_weight", "bias": "bn_bias_std",
      "running_mean": "bn_mean_std", "running_var": "bn_var"}


def _entry(name: str, shape, spec: dict, gen, device) -> torch.Tensor:
    size = torch.Size(shape)
    kw = dict(generator=gen, device=device, dtype=torch.float32)
    if name.startswith("backbone.") and len(size) == 4:
        return torch.randn(size, **kw) * math.sqrt(2.0 / size[1:].numel())
    if name.startswith("backbone.") and len(size) == 1:
        arg = spec[BN[name.rsplit(".", 1)[1]]]
        if isinstance(arg, list):
            lo, hi = arg
            return torch.rand(size, **kw) * (hi - lo) + lo
        return torch.randn(size, **kw) * arg
    return torch.randn(size, **kw) * spec["std"]


def draw(shapes: dict, spec: dict, seed: int, device) -> dict:
    """{name: shape} -> {name: float32 tensor on device}, drawn by spec
    (module docstring) from `seed`."""
    if spec["draw"] != "he_bn":
        raise ValueError(f"unknown weight draw {spec['draw']!r}")
    gen = torch.Generator(device=device).manual_seed(seed64(seed))
    return {name: _entry(name, shape, spec, gen, device)
            for name, shape in shapes.items()}
