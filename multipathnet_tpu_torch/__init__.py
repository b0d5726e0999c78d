"""multipathnet_tpu_torch — the PyTorch + CUDA port of multipathnet_tpu.

The JAX package beside it is the reference: each module here mirrors the
module of the same path there, keeps its public layouts (NHWC images and
trunk taps, channel-last pooled features), and is tested against it on the
CPU (tests/test_torch_*.py). The TPU's Pallas kernels become hand-written
CUDA kernels for Hopper under csrc/, built with nvcc at first use
(ops/_build.py). This package imports torch and numpy, never jax or flax.
"""

__version__ = "0.1.0"
