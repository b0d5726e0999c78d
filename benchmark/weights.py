"""Weights from the seed, made on the device in one draw.

A configuration's `weights` names the draw: {"draw": "normal", "std": s}
is bench.py's, every entry of the float model's state dict normal * s,
here drawn as one flat tensor from a torch.Generator on the device and
cut into the entries in state-dict order. The result is a plain
{name: float32 tensor} dict (the port's parameter names and shapes, torch
layout), the checkpoint that both the program and the reference are
given.
"""

from __future__ import annotations

import torch


def seed64(seed: int) -> int:
    """A torch or numpy seed from any whole number."""
    return seed % (1 << 63)


def draw(shapes: dict, spec: dict, seed: int, device) -> dict:
    """{name: shape} -> {name: float32 tensor on device}, drawn by
    spec ({"draw": "normal", "std": s}) from `seed`."""
    if spec["draw"] != "normal":
        raise ValueError(f"unknown weight draw {spec['draw']!r}")
    sizes = [torch.Size(s).numel() for s in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(seed64(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    flat.mul_(float(spec["std"]))
    return {name: part.view(shape) for (name, shape), part in
            zip(shapes.items(), torch.split(flat, sizes))}
