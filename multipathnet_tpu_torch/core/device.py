"""The device an entry point runs on when its caller names none."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the CUDA card. Without one,
    raise rather than carry on on the CPU: a caller who wants the CPU (the
    tests do) passes device="cpu"."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on an NVIDIA GPU by default; "
            "pass device='cpu' to run on the CPU")
    return torch.device("cuda")
