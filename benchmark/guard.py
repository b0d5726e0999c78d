"""The benchmark measures the PyTorch port alone: no JAX, no JAX package.

Names are compared whole, by the part before the first dot, so the port
(`multipathnet_tpu_torch`) is not taken for the JAX package
(`multipathnet_tpu`) whose name it begins with.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "multipathnet_tpu"})
PROGRAM = "multipathnet_tpu_torch"


def top(name: str) -> str:
    return name.split(".", 1)[0]


def loaded_jax_modules(modules=None) -> list:
    """The loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if top(n) in FORBIDDEN)
