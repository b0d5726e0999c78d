"""Window-read probe: how fast the pool kernels' window reads can go, bf16
windows against int8 — the port of tools/probe_int8_window_dma.py.

Each of N views reads its (10, 16, C) window at (row0, x0) from a
pyramid-shaped (rows, Wmax, C) buffer, converts it to bf16, sums its 160
cells per channel in float32 (the reference's ones(49, 160) @ window
product) and writes the sum, rounded to bf16, to all 49 rows of its (49, C)
output. The kernel is csrc/window_read_probe.cu: it does 160 adds per
channel and nothing else, so its time is the time to read the windows and
write the output.

Run on a machine with an NVIDIA GPU:

    python -m multipathnet_tpu_torch.tools.probe_int8_window_dma

It prints the card's name and power limit as nvidia-smi gives them, then for
bf16 and for int8 windows at the reference tool's shapes (32000 views over a
(4096, 160, 512) buffer) the mean time of one launch (CUDA events over
repeated launches after a warm-up), the window-read rate N * 160 * C *
itemsize / time, millions of views per second, and the bf16 / int8 time
ratio. It raises without a card.
"""

from __future__ import annotations

import subprocess

import torch

from multipathnet_tpu_torch.core.device import resolve_device
from multipathnet_tpu_torch.ops.roi_pool import _check, _stream

WINDOW, WINDOW_X = 10, 16
OUT_ROWS = 49
_IS_INT8 = {torch.bfloat16: 0, torch.int8: 1}
_VEC = 4              # channels per thread: one 8-byte bf16 or 4-byte int8 load
_REF_SCRATCH = 1 << 30  # bytes of float32 windows per chunk of the plain version


def window_read_probe_ref(flat, row0, x0) -> torch.Tensor:
    """Plain version of P: each view's window gathered, cast to bf16 and to
    float32, summed over its 160 cells, one cast to bf16, the row repeated
    49 times -> (N, 49, C) bf16. Chunked over the views so that the float32
    windows stay near 1 GB."""
    n, c = row0.shape[0], flat.shape[-1]
    dev = flat.device
    out = torch.empty((n, OUT_ROWS, c), dtype=torch.bfloat16, device=dev)
    step = max(1, _REF_SCRATCH // (WINDOW * WINDOW_X * c * 4))
    dy = torch.arange(WINDOW, device=dev)
    dx = torch.arange(WINDOW_X, device=dev)
    for s in range(0, n, step):
        ys = row0[s:s + step].long()[:, None] + dy
        xs = x0[s:s + step].long()[:, None] + dx
        win = flat[ys[:, :, None], xs[:, None, :]]
        total = win.to(torch.bfloat16).float().sum(dim=(1, 2))
        out[s:s + step] = total.to(torch.bfloat16)[:, None, :]
    return out


def window_read_probe(flat, row0, x0) -> torch.Tensor:
    """P: flat (rows, Wmax, C) bf16 or int8, C a multiple of 4; row0/x0
    (N,) int32 window origins -> (N, 49, C) bf16. The kernel for a CUDA
    tensor, the plain version for a CPU one; a window outside the buffer
    gives NaN on the card. Replaces the Pallas probe's run."""
    if flat.device.type == "cpu":
        return window_read_probe_ref(flat, row0, x0)
    if flat.device.type != "cuda":
        raise ValueError(f"flat must be a CPU or CUDA tensor, got "
                         f"{flat.device}")
    dev = flat.device
    if flat.dtype not in _IS_INT8:
        raise TypeError(f"flat: the probe takes bfloat16 or int8, got "
                        f"{flat.dtype}")
    if flat.dim() != 3 or not flat.is_contiguous():
        raise ValueError(f"flat must be a contiguous (rows, Wmax, C) tensor, "
                         f"got {tuple(flat.shape)}")
    rows, wmax, c = flat.shape
    if c % _VEC or flat.data_ptr() % 8:
        raise ValueError(f"the probe needs C a multiple of {_VEC} and an "
                         f"8-byte aligned buffer, got C = {c}")
    n = row0.shape[0]
    _check("row0", row0, (n,), torch.int32, dev)
    _check("x0", x0, (n,), torch.int32, dev)
    out = torch.empty((n, OUT_ROWS, c), dtype=torch.bfloat16, device=dev)
    if n == 0:
        return out
    from multipathnet_tpu_torch.ops import _build

    with torch.cuda.device(dev):
        rc = _build.kernels().mpn_window_read_probe(
            _IS_INT8[flat.dtype], n, rows, wmax, c, flat.data_ptr(),
            row0.data_ptr(), x0.data_ptr(), out.data_ptr(), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"window_read_probe launch failed: cudaError {rc}")
    window_read_probe.launches += 1
    return out


window_read_probe.launches = 0


def probe_inputs(dtype, n_views: int = 32000, rows: int = 4096,
                 wmax: int = 160, c: int = 512, device=None):
    """The reference tool's inputs, drawn on `device` (default the card)
    from a torch.Generator seeded 0: a (rows, wmax, c) buffer of normal
    draws, for int8 clip(x * 40, -127, 127) truncated toward zero; row0 in
    [0, rows - 10); x0 a multiple of 8 in [0, wmax - 16)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    flat = torch.randn((rows, wmax, c), generator=gen, device=dev)
    if dtype == torch.int8:
        flat = torch.clamp(flat * 40, -127, 127).to(torch.int8)
    else:
        flat = flat.to(dtype)
    row0 = torch.randint(0, rows - WINDOW, (n_views,), generator=gen,
                         device=dev, dtype=torch.int32)
    x0 = torch.randint(0, (wmax - WINDOW_X) // 8, (n_views,), generator=gen,
                       device=dev, dtype=torch.int32) * 8
    return flat, row0, x0


def bench(dtype, n_views: int = 32000, rows: int = 4096, wmax: int = 160,
          c: int = 512, iters: int = 20) -> dict:
    """Times the kernel on the card at these shapes and prints one line.
    Returns {"ms": mean ms per launch, "gb_s": window-read GB/s,
    "mviews_s": millions of views per second}."""
    flat, row0, x0 = probe_inputs(dtype, n_views, rows, wmax, c)
    window_read_probe(flat, row0, x0)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        window_read_probe(flat, row0, x0)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    read_bytes = n_views * WINDOW * WINDOW_X * c * flat.element_size()
    res = {"ms": ms, "gb_s": read_bytes / ms / 1e6,
           "mviews_s": n_views / ms / 1e3}
    print(f"{str(dtype)[6:]:8s}: {ms:8.4f} ms  {res['gb_s']:7.1f} GB/s  "
          f"({res['mviews_s']:.2f} Mviews/s)", flush=True)
    return res


def main() -> None:
    resolve_device()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    t_bf16 = bench(torch.bfloat16)["ms"]
    t_int8 = bench(torch.int8)["ms"]
    print(f"bf16 / int8 time: {t_bf16 / t_int8:.3f}x")


if __name__ == "__main__":
    main()
