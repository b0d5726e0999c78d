"""Chip smoke test of the PyTorch + CUDA port (multipathnet_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):
  1. device: a CUDA device must be present; prints nvidia-smi's name and
     power limit.
  2. build: compiles csrc/ with nvcc (ops/_build.py) and prints the time,
     ptxas's report and each pool instance's registers, local memory
     (spills) and static/dynamic shared memory (cudaFuncGetAttributes).
  3. kernels: K1 (window_pool_multi) and K2 (resident_pool) against their
     plain PyTorch versions on random 640^2 c3/c4/c5 maps in float32
     (atol 1e-4) and bfloat16 (rtol 1e-2, atol 1e-2: one bf16 rounding of a
     float32 sum; the share of outputs that differ at all is printed), at
     the main path's shapes (8 images x 1000 proposals: K1 8000 views x 3
     levels, K2 8 x 3000 views) and on 2 images with 2048 ROIs at every
     pyramid scale, border ROIs included; then both timed against their
     plain versions on the main path's bf16 inputs, with the rate at which
     they read windows.
  4. main path: Detector on `multipath_vgg16_batched` (bf16 VGG-16,
     8 images x 1000 proposals, 640^2 canvas, weights normal * 0.02 drawn
     on the card from a seeded generator): first-call time, steady img/s
     over 10 batches, a profiler breakdown of one batch; both kernels must
     have launched, outputs finite with shapes (8, 100, 4) / (8, 100).
  5. NMS under load: the same with eval.score_threshold = 0, so NMS sees
     candidates (random weights put every class near 1/81 < 0.05);
     detections must be > 0.
  6. train kernels: at the train path's geometry (multipath_vgg16_train:
     8 images x 64 ROIs, 640^2, C = 512), K1's forward on its two train
     groups (512 1x views over c3+c4+c5; 1536 context views over c5 alone,
     the single-level instance eval never launches) against its plain
     version in float32 (atol 1e-4) and bfloat16 (rtol/atol 1e-2), each
     timed against it; K3 (window_grad) and K4 (window_rmw_grad) against
     their plain versions (K3 on c5 with all 2048 foveal views, K4 on c3
     with the 512 1x views) on random float32 cotangents, float32 (atol
     1e-4) and cast to bfloat16 (rtol/atol 1e-2), then both timed against
     their plain versions; and WindowPoolMulti's backward on the card (K3
     on c5, the placement GEMMs on c4, K4 on c3) against autograd through
     the plain forward.
  7. training: Trainer on `multipath_vgg16_train` at full width (VGG-16,
     conv1-2 frozen, float32 parameters, bf16 compute, batch 8 at 640^2,
     1000 proposals and 64 sampled ROIs per image), weights normal * 0.02
     from a seeded generator on the card, a synthetic batch from seed 0:
     the first step's time, 10 timed steps (ms/step, img/s), peak device
     memory and a profiler breakdown of one step. Every loss finite, fg
     sampled, K1/K3/K4 launched and K2 not, frozen blocks bit-identical,
     conv3_1's gradient nonzero.
  8. int8 epilogue: K1 and K2 with the skip bias (the quant instances) at
     the main path's shapes (K1 8000 views x 3 levels, K2 8 x 3000 views,
     C = 512), float32 and bfloat16: bit for bit against the plain epilogue
     (roi_pool.quant_view_ref) applied to the same kernel's own pooled
     output, and against the fully plain version codes within 1 and scales
     within 1e-5 (float32) / 1e-2 (bfloat16) relative; in bf16 the share of
     pooled outputs that differ from the plain version is printed, and each
     kernel timed against its plain version and against the kernel without
     the epilogue followed by the plain epilogue.
  9. int8 serving: Detector on `multipath_vgg16_int8` at 8 x 1000
     proposals, 640^2: float32 weights normal * 0.02 drawn on the card
     from a seeded generator, quantized by Detector's load-time transform
     (bench.py's flow); first-call time, steady img/s over 10 batches, peak
     device memory, a profiler breakdown of one batch. The quant K1/K2 must
     have launched and K1/K2 without the epilogue not; outputs finite with
     shapes (8, 100, 4) / (8, 100).
 10. int8 + truncated-SVD serving: the same on `multipath_vgg16_int8_svd`,
     the factored layout (fc6 rank 1024, fc7 rank 256) drawn directly in
     float32, as bench.py does (the load-time SVD is tested on the CPU).
     Then phase 4's bf16 img/s is printed beside both.
 11. single-level pools: K5 (window_pool) on the main path's 8000 1x views
     (bench.py's 8 x 1000 proposals, 640^2) over the stacked 8-image c3
     pyramid of a random C = 512 map, against its plain version in float32
     (atol 1e-4) and bfloat16 (rtol/atol 1e-2), timed against it in bf16.
     Then the entry points as a path of their own (`pool_api`, launches
     counted from 0): batched_pyramid_pool on those views in bf16, and the
     three differentiable forms in float32 with their backward, each
     through K4 (accumulate_windows): batched_pyramid_pool(trainable) on
     the same views, batched_pyramid_pool_resident(trainable) on the main
     path's 8 x 3000 context views over c5, and WindowPoolMulti without
     rows_list on the train geometry (512 1x views over c3+c4+c5). Each
     gradient is held against autograd through the plain forward, float32,
     atol 1e-4 x max(1, max |g|) (GRAD_ATOL says why).
 12. window-read probe P (tools/probe_int8_window_dma.py of the port) at
     its tool's shapes (32000 views over a (4096, 160, 512) buffer), bf16
     and int8 windows: the kernel against its plain version (rtol/atol
     1e-2, a bf16 output), each timed against it; then the tool's `bench`
     for each dtype as the path `probe` (launches counted from 0).
The line before the last is a JSON object with each kernel's launches (the
runs of phases 4, 7, 9, 10, 11 and 12, each counted from 0, and their sum),
error, times and bound: for the pool kernels the larger of the bytes they
must move (each pyramid cell under a window, the geometry and the output
once) over 3.35 TB/s and their operations (float32 ones over 67 TF/s; the
bf16 body's W2 GEMM, 2 x 49 x 160 per view, level and channel, over the
989 TF/s of the bf16 tensor cores); for P the
distinct cells under its windows and its output over 3.35 TB/s, with the
int8 numbers beside the bf16 ones. The last line is {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

from multipathnet_tpu_torch.core.config import preset
from multipathnet_tpu_torch.eval.detect import Detector, detect_batch
from multipathnet_tpu_torch.models import convert
from multipathnet_tpu_torch.models.multipath import build_model
from multipathnet_tpu_torch.ops import _build, roi_pool, roi_pyramid
from multipathnet_tpu_torch.ops.boxes import expand
from multipathnet_tpu_torch.tools import probe_int8_window_dma as probe
from multipathnet_tpu_torch.train.loop import Batch, Trainer

# every model path pools in bf16, which runs the tensor-core body; the
# float32 body (csrc/roi_window_pool.cu) is checked in phases 3, 6, 8, 11
POOL_SOURCE = "multipathnet_tpu_torch/csrc/roi_window_pool_wgmma.cu"
GRAD_SOURCE = "multipathnet_tpu_torch/csrc/roi_window_grad.cu"
PROBE_SOURCE = "multipathnet_tpu_torch/csrc/window_read_probe.cu"
PALLAS = "multipathnet_tpu/ops/roi_pallas.py"
# name -> (source, the TPU kernel it replaces, wrapper, its launch counter)
KERNELS = {
    "window_pool_multi": (POOL_SOURCE, f"{PALLAS}:472",
                          roi_pool.window_pool_multi, "launches"),
    "resident_pool": (POOL_SOURCE, f"{PALLAS}:940", roi_pool.resident_pool,
                      "launches"),
    "window_pool_multi_quant": (POOL_SOURCE, f"{PALLAS}:536",
                                roi_pool.window_pool_multi,
                                "quant_launches"),
    "resident_pool_quant": (POOL_SOURCE, f"{PALLAS}:977",
                            roi_pool.resident_pool, "quant_launches"),
    "window_grad": (GRAD_SOURCE, f"{PALLAS}:659", roi_pool.window_grad,
                    "launches"),
    "window_rmw_grad": (GRAD_SOURCE, f"{PALLAS}:745",
                        roi_pool.window_rmw_grad, "launches"),
    "window_pool": (POOL_SOURCE, f"{PALLAS}:113", roi_pool.window_pool,
                    "launches"),
    "window_read_probe": (PROBE_SOURCE, "tools/probe_int8_window_dma.py:30",
                          probe.window_read_probe, "launches"),
}


def reset_launches() -> None:
    for _, _, fn, counter in KERNELS.values():
        setattr(fn, counter, 0)


def read_launches() -> dict:
    return {name: getattr(fn, counter)
            for name, (_, _, fn, counter) in KERNELS.items()}


LEVELS = (("c3", 4), ("c4", 8), ("c5", 16))
CONTEXT = (1.5, 2.0, 4.0)


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {msg}")


def make_inputs(batch: int, proposals: int, canvas: int, seed: int = 0):
    """bench.py's generator (make_inputs): uint8 images, full-canvas valid
    extents, proposals of 16 px to 0.3 x canvas."""
    rng = np.random.default_rng(seed)
    b, p_, s = batch, proposals, canvas
    images = rng.integers(0, 255, (b, s, s, 3), dtype=np.uint8)
    src_hws = np.full((b, 2), float(s), np.float32)
    x1 = rng.uniform(0, s * 0.7, (b, p_)).astype(np.float32)
    y1 = rng.uniform(0, s * 0.7, (b, p_)).astype(np.float32)
    w = rng.uniform(16, s * 0.3, (b, p_)).astype(np.float32)
    h = rng.uniform(16, s * 0.3, (b, p_)).astype(np.float32)
    boxes = np.stack([x1, y1, x1 + w, y1 + h], -1)
    return images, src_hws, boxes, np.ones((b, p_), bool)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn over `iters` runs, CUDA events, warmed up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def alternate_ms(plain, kernel, iters_plain: int, iters_kernel: int):
    """Time plain and kernel in turns (plain, kernel, kernel, plain) and
    average each one's two readings."""
    p1 = cuda_ms(plain, iters_plain)
    k1 = cuda_ms(kernel, iters_kernel)
    k2 = cuda_ms(kernel, iters_kernel)
    p2 = cuda_ms(plain, iters_plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


# ---------------------------------------------------------------- bounds ---

HBM_BYTES_PER_MS = 3.35e9     # H100 SXM, 3.35 TB/s
F32_OPS_PER_MS = 67e9         # H100 SXM float32 on the CUDA cores, 67 TF/s
BF16_OPS_PER_MS = 989e9       # H100 SXM bf16 dense tensor cores, 989 TF/s
# per view and level: row0, x0 (int32), wy (7 x 10), wx (7 x 16) float32
GEOMETRY_BYTES = 4 + 4 + 4 * 7 * 10 + 4 * 7 * 16
POOL_OPS = 2 * 1610           # per view, level and channel: the separable
#                               contraction's FMAs (csrc/roi_window_pool.cu)
W2_OPS = 2 * 49 * 160         # the same for the bf16 body's W2 GEMM
#                               (csrc/roi_window_pool_wgmma.cu)
EPILOGUE_OPS = 5              # per output element: bias add, ReLU, max,
#                               divide, round


def bound(n_bytes, n_ops, n_bf16_ops=0):
    """The least time the card could take, in ms, and what sets it: the
    larger of the bytes over the HBM rate and the operations, float32 ones
    over the CUDA cores' peak and bf16 tensor-core ones over theirs (two
    units that can run at once, so the larger of their two times)."""
    t_bytes = n_bytes / HBM_BYTES_PER_MS
    t_ops = max(n_ops / F32_OPS_PER_MS, n_bf16_ops / BF16_OPS_PER_MS)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def window_cells(row0, x0, n_rows, wmax) -> int:
    """The distinct cells of an (n_rows, wmax) buffer under the 10 x 16
    windows at (row0, x0): what these views need read."""
    dev = row0.device
    mask = torch.zeros((n_rows, wmax), dtype=torch.bool, device=dev)
    ys = row0.long()[:, None] + torch.arange(10, device=dev)
    xs = x0.long()[:, None] + torch.arange(16, device=dev)
    mask[ys[:, :, None], xs[:, None, :]] = True
    return int(mask.sum())


def pool_bound(flats, row0s, x0s, quant: bool):
    """bound() of one K1 or K2 call on these inputs: each pyramid cell
    under a window read once, the geometry read once, the (N, 7, 7, C)
    output written once (int8 codes, one float32 scale per view and the
    bias read with the epilogue); per view, level and channel POOL_OPS
    float32 operations (the float32 body) or W2_OPS bf16 tensor-core ones
    (the bf16 body), plus EPILOGUE_OPS float32 operations per output
    element with the epilogue. K2's per-image pyramids (B, rows, Wmax, C)
    take image-relative rows."""
    c, size = flats[0].shape[-1], flats[0].element_size()
    n = row0s[0].numel()
    cells = 0
    for flat, row0, x0 in zip(flats, row0s, x0s):
        if flat.dim() == 4:
            b, rows = flat.shape[:2]
            row0 = row0 + torch.arange(b, device=row0.device)[:, None] * rows
        wmax = flat.shape[-2]
        cells += window_cells(row0.reshape(-1), x0.reshape(-1),
                              flat.numel() // (wmax * c), wmax)
    out = n * 49 * c + n * 4 + c * size if quant else n * 49 * c * size
    views = n * len(flats) * c
    bf16 = flats[0].dtype == torch.bfloat16
    return bound(cells * c * size + n * len(flats) * GEOMETRY_BYTES + out,
                 (0 if bf16 else views * POOL_OPS)
                 + (n * 49 * c * EPILOGUE_OPS if quant else 0),
                 views * W2_OPS if bf16 else 0)


def window_read_gb_s(flats, row0s, ms: float) -> float:
    """The rate at which one K1/K2/K5 call of `ms` reads its windows:
    every view's L (10, 16, C) windows, counted each time a view reads one
    (neighbouring views read cells again), in GB/s."""
    c, size = flats[0].shape[-1], flats[0].element_size()
    return row0s[0].numel() * len(flats) * 160 * c * size / ms / 1e6


def grad_bound(gout, out_numel: int, out_size: int):
    """bound() of one K3 or K4 call: the float32 cotangent and the geometry
    read once, the whole gradient buffer written once; POOL_OPS per view
    and channel (the transposed contraction)."""
    n, c = gout.shape[0], gout.shape[-1]
    return bound(gout.numel() * 4 + n * GEOMETRY_BYTES + out_numel * out_size,
                 n * c * POOL_OPS)


def log_pool_instances() -> None:
    """Phase 2: each pool instance's registers, local memory (spills) and
    shared memory, from cudaFuncGetAttributes (mpn_pool_kernel_attrs)."""
    attrs = (ctypes.c_int * 5)()
    for is_bf16, body in ((1, "bf16 tensor-core"), (0, "float32 CUDA-core")):
        for levels in (1, 2, 3):
            for quant in (0, 1):
                rc = _build.kernels().mpn_pool_kernel_attrs(
                    is_bf16, levels, quant, ctypes.addressof(attrs))
                require(rc == 0, f"mpn_pool_kernel_attrs: cudaError {rc}")
                regs, local, static, dynamic, threads = attrs
                log(f"[build] pool {body} body, L = {levels}"
                    f"{', int8 epilogue' if quant else ''}: {regs} registers,"
                    f" {local} B local memory (spills), {static} B static + "
                    f"{dynamic} B dynamic shared memory, at most {threads} "
                    f"threads per block")


# ------------------------------------------------------------- phase 3 ---

def random_levels(batch, canvas, channels, gen, dtype):
    return {name: (torch.randn((batch, canvas // s, canvas // s, channels),
                               generator=gen, device="cuda").to(dtype), s)
            for name, s in LEVELS}


def border_and_scale_rois(n_per_image, batch, canvas, rng):
    """ROIs log-uniform from 4 px to the whole canvas (every pyramid scale
    of every level), a third of them pushed over the image border and
    clipped."""
    out = []
    for _ in range(batch):
        wh = np.exp(rng.uniform(np.log(4.0), np.log(canvas), (n_per_image, 2)))
        xy = rng.uniform(0, canvas, (n_per_image, 2)) - 0.5 * wh
        xy[: n_per_image // 3] -= 0.4 * wh[: n_per_image // 3]
        boxes = np.concatenate([xy, xy + wh], -1)
        out.append(np.clip(boxes, 0, canvas))
    return torch.tensor(np.stack(out), dtype=torch.float32, device="cuda")


def k1_args(pyr, names, views, img_idx, dtype=None):
    """window_pool_multi's arguments for `views` (image-major, img_idx their
    images) over the pyramids `names`, as batched_pyramid_pool_multi builds
    them; the flats cast to `dtype` if given."""
    args = [[], [], [], [], []]
    for name in names:
        flat, meta = pyr[name]
        row0, x0, wy, wx = roi_pool.view_geometry(meta, views)
        row0 = (row0 + img_idx * meta.flat.shape[0]).contiguous()
        flat = flat if dtype is None else flat.to(dtype)
        for dst, v in zip(args, (flat, row0, x0, wy, wx)):
            dst.append(v)
    return args


def pool_inputs(levels, rois, canvas):
    """-> (K1 args, K2 args, pyramid levels used per view at c3): K1 pools
    the 1x views over c3+c4+c5, K2 the context views over c5, exactly as
    MultiPathNet.pool_rois routes them."""
    b, r = rois.shape[:2]
    pyr = {name: roi_pyramid.build_pyramid_batch(f, 1.0 / s)
           for name, (f, s) in levels.items()}
    img_idx = torch.arange(b, dtype=torch.int32,
                           device="cuda").repeat_interleave(r)
    k1 = k1_args(pyr, [name for name, _ in LEVELS], rois.reshape(-1, 4),
                 img_idx)
    flat, meta = pyr["c5"]
    ctx = torch.stack([expand(rois, f, canvas, canvas) for f in CONTEXT],
                      dim=1).reshape(-1, 4)
    row0, x0, wy, wx = roi_pool.view_geometry(meta, ctx)
    v = ctx.shape[0] // b
    rows, wmax, c = meta.flat.shape
    k2 = (flat.reshape(b, rows, wmax, c), row0.reshape(b, v),
          x0.reshape(b, v), wy.reshape(b, v, 7, 10), wx.reshape(b, v, 7, 16))
    c3_meta = pyr["c3"][1]
    c3_levels = torch.searchsorted(c3_meta.row_offsets.long(),
                                   (k1[1][0] % c3_meta.flat.shape[0]).long(),
                                   right=True) - 1
    return k1, k2, c3_levels, c3_meta.num_scales


def differ_share(got, want) -> float:
    """The share of outputs that are not equal to the plain version's."""
    return float((got != want).float().mean())


def compare(name, dtype, got, want):
    """Max abs error of a kernel's output against its plain version, held
    to atol 1e-4 in float32 and to rtol/atol 1e-2 in bfloat16 (one bf16
    rounding of a float32 sum); in bfloat16 the tolerance string also
    gives the share of outputs that differ at all."""
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{name}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    err = (got.float() - want.float()).abs().max().item()
    if dtype == torch.float32:
        ok, tol = err <= 1e-4, "atol 1e-4"
    else:
        ok = torch.allclose(got.float(), want.float(), rtol=1e-2, atol=1e-2)
        tol = (f"rtol 1e-2, atol 1e-2; {100 * differ_share(got, want):.4f}% "
               f"of the outputs differ")
    require(ok and np.isfinite(err), f"{name} {dtype} disagrees with its "
            f"plain version: max abs err {err}")
    return err, tol


def check_and_time_kernels(gen):
    """K1 and K2 against their plain versions on the same inputs, in float32
    (a float32 copy of the bf16 maps) and bfloat16, in two cases:
      main path: bench.py's proposals for 8 images x 1000, so K1 pools 8000
          views over c3+c4+c5 and K2 8 x 3000 context views over c5;
      coverage: 2 images, 2048 ROIs at every c3 pyramid scale, a third of
          them over the image border.
    Then each kernel is timed against its plain version on the main path's
    bf16 inputs. Returns {name: {"float32": err, "bfloat16": err, "ms": t,
    "plain_ms": t, "bound_ms": t, "bound_by": ...}} of the main-path
    case."""
    _, _, boxes, _ = make_inputs(8, 1000, 640)
    cases = (("main path", torch.from_numpy(boxes).cuda()),
             ("coverage", border_and_scale_rois(
                 1024, 2, 640, np.random.default_rng(1))))
    out = {"window_pool_multi": {}, "resident_pool": {}}
    for case, rois in cases:
        levels = random_levels(rois.shape[0], 640, 512, gen, torch.bfloat16)
        for dtype in (torch.float32, torch.bfloat16):
            k1, k2, c3_levels, n_scales = pool_inputs(
                {n: (f.to(dtype), s) for n, (f, s) in levels.items()}, rois,
                640)
            if case == "coverage":
                require(set(c3_levels.tolist()) == set(range(n_scales)),
                        f"coverage views miss c3 pyramid scales: "
                        f"{c3_levels.unique()}")
            for name, kern, ref, args in (
                    ("window_pool_multi", roi_pool.window_pool_multi,
                     roi_pool.window_pool_multi_ref, k1),
                    ("resident_pool", roi_pool.resident_pool,
                     roi_pool.resident_pool_ref, k2)):
                got = kern(*args)
                torch.cuda.synchronize()
                err, tol = compare(name, dtype, got, ref(*args))
                shape = "x".join(map(str, got.shape[:got.dim() - 3]))
                log(f"[kernels] {case}: {name} {str(dtype)[6:]}, {shape} "
                    f"views, max abs err {err:.3e} ({tol}) ok")
                if case != "main path":
                    continue
                out[name][str(dtype)[6:]] = err
                if dtype == torch.bfloat16:
                    ms, plain_ms = alternate_ms(lambda: ref(*args),
                                                lambda: kern(*args), 2, 10)
                    flats, row0s, x0s = ((args[0], args[1], args[2])
                                         if name == "window_pool_multi" else
                                         ([args[0]], [args[1]], [args[2]]))
                    b_ms, b_by = pool_bound(flats, row0s, x0s, quant=False)
                    log(f"[kernels] main path: {name} bf16 kernel {ms:.3f} "
                        f"ms ({window_read_gb_s(flats, row0s, ms):.0f} GB/s "
                        f"of window reads), plain {plain_ms:.3f} ms, bound "
                        f"{b_ms:.3f} ms ({b_by})")
                    out[name].update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                     bound_by=b_by)
            del k1, k2
        del levels
    return out


# ------------------------------------------------------------- phase 4 ---

@torch.no_grad()
def seeded_normal_(model, seed: int, std: float = 0.02):
    """bench.py's weights: every parameter normal * std, drawn on the
    model's device from one seeded generator."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for p in model.parameters():
        p.copy_(torch.randn(p.shape, generator=gen, device=dev) * std)
    return sum(p.numel() for p in model.parameters())


def profile_once(tag: str, what: str, fn, top: int = 12):
    """fn() once under torch.profiler: device time by kernel (the top ones
    and every pool kernel) and by op, and the device's busy share of the
    wall time. User annotations (Optimizer.step's range) are not
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    stats = prof.key_averages()
    kernels = sorted((e for e in stats
                      if str(e.device_type).endswith("CUDA")
                      and e.device_time_total > 0
                      and not getattr(e, "is_user_annotation", False)),
                     key=lambda e: -e.device_time_total)
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    log(f"[{tag}] {what}: wall {wall_ms:.2f} ms, device kernels "
        f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}% busy)")
    for i, e in enumerate(kernels):
        if i < top or "window_" in e.key:
            log(f"[{tag}]   kernel {e.device_time_total / 1e3:8.3f} ms "
                f"x{e.count:<4d} {e.key[:80]}")
    ops = [e for e in stats if not str(e.device_type).endswith("CUDA")
           and e.self_device_time_total > 0]
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"[{tag}]   op {e.self_device_time_total / 1e3:8.3f} ms "
            f"x{e.count:<4d} {e.key[:80]}")


def main_path():
    cfg = preset("multipath_vgg16_batched")
    b, p = 8, cfg.data.max_proposals
    canvas = cfg.data.image_size[0]
    require((b, p, canvas) == (8, 1000, 640),
            f"unexpected main-path shape {(b, p, canvas)}")
    t0 = time.perf_counter()
    model = build_model(cfg.model, device="cuda")
    n_params = seeded_normal_(model, 0)
    torch.cuda.synchronize()
    log(f"[main] multipath_vgg16_batched: {n_params / 1e6:.1f}M params "
        f"({cfg.model.dtype}) on the card in {time.perf_counter() - t0:.1f}s")
    det = Detector(model, cfg, "cuda")
    inputs = make_inputs(b, p, canvas)

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = det(*inputs)
    first_s = time.perf_counter() - t0
    log(f"[main] first call {first_s:.2f} s; detections img0: "
        f"{int(out['valid'][0].sum())}")

    dev_inputs = [torch.as_tensor(x).cuda() for x in inputs]
    iters = 10
    detect_batch(model, cfg, *dev_inputs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        res = detect_batch(model, cfg, *dev_inputs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    ips = b * iters / dt
    log(f"[main] steady: {iters} batches x {b} images in {dt:.3f} s = "
        f"{b * iters / dt:.2f} img/s ({1e3 * dt / iters:.2f} ms/batch); "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[main] kernel launches in the main-path run: {launches}")
    require(launches["window_pool_multi"] > 0 and launches["resident_pool"]
            > 0 and launches["window_pool_multi_quant"] == 0
            and launches["resident_pool_quant"] == 0,
            f"a kernel of the path never launched, or a quant one did: "
            f"{launches}")
    for key, shape in (("boxes", (8, 100, 4)), ("scores", (8, 100)),
                       ("classes", (8, 100)), ("valid", (8, 100))):
        require(out[key].shape == shape and tuple(res[key].shape) == shape,
                f"{key} shape {out[key].shape}")
    require(np.isfinite(out["boxes"]).all() and np.isfinite(
        out["scores"]).all(), "non-finite detections")

    # NMS under load: threshold 0 lets every class through to NMS
    cfg0 = cfg.replace(eval=dataclasses.replace(cfg.eval,
                                                score_threshold=0.0))
    out0 = Detector(model, cfg0, "cuda")(*inputs)
    n_det = int(out0["valid"].sum())
    detect_batch(model, cfg0, *dev_inputs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        detect_batch(model, cfg0, *dev_inputs)
    torch.cuda.synchronize()
    dt0 = time.perf_counter() - t0
    log(f"[nms] score_threshold=0: {n_det} detections over {b} images; "
        f"{b * iters / dt0:.2f} img/s ({1e3 * dt0 / iters:.2f} ms/batch)")
    require(n_det > 0 and np.isfinite(out0["boxes"]).all(),
            "no detections with score_threshold=0")
    profile_once("profile", "one batch",
                 lambda: detect_batch(model, cfg0, *dev_inputs))
    return launches, ips


# ------------------------------------------------------------- phase 6 ---

FOVEAL = (1.0, 1.5, 2.0, 4.0)
# the train path's two K1 groups (MultiPathNet.pool_rois with train=True)
TRAIN_GROUPS = (("1x views over c3+c4+c5", FOVEAL[:1], ("c3", "c4", "c5")),
                ("context views over c5", FOVEAL[1:], ("c5",)))


def group_views(rois, factors, canvas=640):
    """A K1 group's views of rois (B, R, 4), image-major, and their
    images."""
    b, r = rois.shape[:2]
    views = torch.stack([expand(rois, f, canvas, canvas) for f in factors],
                        dim=1).reshape(-1, 4)
    img_idx = torch.arange(b, dtype=torch.int32,
                           device="cuda").repeat_interleave(len(factors) * r)
    return views, img_idx


def train_geometry(gen, batch=8, rois_per_image=64, canvas=640, c=512):
    """The pool's inputs at multipath_vgg16_train: random float32 c3/c4/c5
    maps, 64 ROIs per image from bench.py's generator, and
      k3: all 4 foveal views of every ROI over c5 (8 x 256 = 2048 views,
          image-major, rows image-relative) -> window_grad args;
      k4: the 1x views over c3 (512 views, rows absolute) ->
          window_rmw_grad args (without the dtype);
    plus the pyramids and the ROIs (B, R, 4) for K1 and WindowPoolMulti."""
    _, _, boxes, _ = make_inputs(batch, rois_per_image, canvas)
    rois = torch.from_numpy(boxes).cuda()
    levels = random_levels(batch, canvas, c, gen, torch.float32)
    pyr = {name: roi_pyramid.build_pyramid_batch(f, 1.0 / s)
           for name, (f, s) in levels.items()}
    views, _ = group_views(rois, FOVEAL, canvas)
    meta = pyr["c5"][1]
    rows, wmax = meta.flat.shape[:2]
    row0, x0, wy, wx = roi_pool.view_geometry(meta, views)
    gout = torch.randn((views.shape[0], 7, 7, c), generator=gen,
                       device="cuda")
    k3 = (gout, row0, x0, wy, wx, batch, rows, wmax)
    ones, img_idx = group_views(rois, FOVEAL[:1], canvas)
    (flat,), (row0,), (x0,), (wy,), (wx,) = k1_args(pyr, ("c3",), ones,
                                                    img_idx)
    gout = torch.randn((ones.shape[0], 7, 7, c), generator=gen,
                       device="cuda")
    k4 = (gout, row0, x0, wy, wx, tuple(flat.shape))
    return k3, k4, pyr, rois


def check_train_forward(pyr, rois):
    """K1 against its plain version on the train path's two groups (512 1x
    views over c3+c4+c5, and 1536 context views over c5 alone, the
    single-level instance that eval never launches), float32 (atol 1e-4)
    and bfloat16 (rtol/atol 1e-2, the pyramids cast), each group timed
    against its plain version in bf16. Returns {"float32": err,
    "bfloat16": err}, the larger of the two groups' errors."""
    out = {"float32": 0.0, "bfloat16": 0.0}
    for group, factors, names in TRAIN_GROUPS:
        views, img_idx = group_views(rois, factors)
        for dtype in (torch.float32, torch.bfloat16):
            args = k1_args(pyr, names, views, img_idx, dtype)
            got = roi_pool.window_pool_multi(*args)
            torch.cuda.synchronize()
            err, tol = compare(f"window_pool_multi ({group})", dtype, got,
                               roi_pool.window_pool_multi_ref(*args))
            key = str(dtype)[6:]
            out[key] = max(out[key], err)
            log(f"[grad] train forward: window_pool_multi {key}, "
                f"{views.shape[0]} {group}, max abs err {err:.3e} ({tol}) "
                f"ok")
        ms, plain_ms = alternate_ms(
            lambda: roi_pool.window_pool_multi_ref(*args),
            lambda: roi_pool.window_pool_multi(*args), 2, 10)
        log(f"[grad] train forward: window_pool_multi bf16, {group}: kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms")
        del got, args
    return out


def check_and_time_grad_kernels(gen):
    """K1's forward at the train path's two groups (check_train_forward);
    K3 and K4 against their plain versions on the train path's geometry
    (float32 atol 1e-4; the bf16 cast rtol/atol 1e-2), timed against them
    (K3's float32 result, K4's bf16 buffer as the path uses them); then
    WindowPoolMulti's backward on the card against autograd through the
    plain forward, float32, atol 1e-4. Returns ({name: {"float32": err,
    "bfloat16": err, "ms": t, "plain_ms": t, "bound_ms": t, "bound_by":
    ...}} for K3 and K4, K1's train errors)."""
    k3, k4, pyr, rois = train_geometry(gen)
    k1_train = check_train_forward(pyr, rois)
    out = {}
    for name, kern, ref, args in (
            ("window_grad", roi_pool.window_grad, roi_pool.window_grad_ref,
             k3),
            ("window_rmw_grad", roi_pool.window_rmw_grad,
             roi_pool.window_rmw_grad_ref, k4 + (torch.float32,))):
        got = kern(*args)
        torch.cuda.synchronize()
        want = ref(*args)
        out[name] = {}
        for dtype in (torch.float32, torch.bfloat16):
            err, tol = compare(name, dtype, got.to(dtype), want.to(dtype))
            out[name][str(dtype)[6:]] = err
            log(f"[grad] {name} {str(dtype)[6:]}, {args[0].shape[0]} views "
                f"into {tuple(got.shape)}, max abs err {err:.3e} ({tol}) ok")
        del got, want
        if name == "window_rmw_grad":
            args = k4 + (torch.bfloat16,)
        ms, plain_ms = alternate_ms(lambda: ref(*args), lambda: kern(*args),
                                    2, 10)
        if name == "window_grad":    # (batch * rows, wmax, C) float32
            b_ms, b_by = grad_bound(args[0], args[5] * args[6] * args[7]
                                    * args[0].shape[-1], 4)
        else:                        # the buffer's shape, in bf16
            b_ms, b_by = grad_bound(args[0], int(np.prod(args[5])), 2)
        log(f"[grad] {name} kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"bound {b_ms:.3f} ms ({b_by})")
        out[name].update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by)
        # the wrapper's own passes (zeroing, the cast) beside the kernel's
        profile_once("grad", f"{name} wrapper, one call",
                     lambda: kern(*args), top=4)

    names = [n for n, _ in LEVELS]
    flats = [pyr[n][0].detach().requires_grad_() for n in names]
    metas = [pyr[n][1] for n in names]
    ones, img_idx = group_views(rois, FOVEAL[:1])
    gout = torch.randn((ones.shape[0], 7, 7, flats[0].shape[-1]),
                       generator=gen, device="cuda")
    got = torch.autograd.grad(
        (roi_pool.batched_pyramid_pool_multi(flats, metas, ones, img_idx,
                                             trainable=True) * gout).sum(),
        flats)
    _, *geometry = k1_args(pyr, names, ones, img_idx)
    plain = roi_pool.window_pool_multi_ref(flats, *geometry)
    want = torch.autograd.grad((plain * gout).sum(), flats)
    for (lv, _), g_, w_ in zip(LEVELS, got, want):
        err, tol = compare(f"WindowPoolMulti backward {lv}", torch.float32,
                           g_, w_)
        log(f"[grad] WindowPoolMulti backward {lv}: max abs err {err:.3e} "
            f"({tol}) ok")
    return out, k1_train


# ------------------------------------------------------------- phase 7 ---

def train_batch(cfg, seed: int = 0) -> Batch:
    """A synthetic batch at the pipeline's shapes, numpy from `seed`: uint8
    images on the (H, W) canvas, valid extents in [480, 640], 5-20 GT boxes
    per image padded to max_gt_per_image, and max_proposals proposals per
    image, half of them jittered around GT so fg exists."""
    rng = np.random.default_rng(seed)
    b, (h, w) = cfg.train.batch_size, cfg.data.image_size
    p, g = cfg.data.max_proposals, cfg.data.max_gt_per_image
    images = rng.integers(0, 255, (b, h, w, 3), dtype=np.uint8)
    src_hws = rng.integers(480, 641, (b, 2)).astype(np.float32)
    n_gt = rng.integers(5, 21, b)
    gt = np.zeros((b, g, 4), np.float32)
    classes = np.zeros((b, g), np.int32)
    props = np.zeros((b, p, 4), np.float32)
    for i in range(b):
        ext = src_hws[i, ::-1]                              # (w, h)
        wh = rng.uniform(32, 0.5 * ext.min(), (n_gt[i], 2))
        xy = rng.uniform(0, 1, (n_gt[i], 2)) * (ext - wh)
        gt[i, :n_gt[i]] = np.concatenate([xy, xy + wh], -1)
        classes[i, :n_gt[i]] = rng.integers(1, cfg.model.num_classes,
                                            n_gt[i])
        near = gt[i, rng.integers(0, n_gt[i], p // 2)]
        size = np.tile(near[:, 2:] - near[:, :2], 2)        # (w, h, w, h)
        near = near + rng.normal(0, 0.1, near.shape) * size
        pwh = rng.uniform(16, 0.6 * ext.min(), (p - p // 2, 2))
        pxy = rng.uniform(0, 1, (p - p // 2, 2)) * (ext - pwh)
        far = np.concatenate([pxy, pxy + pwh], -1)
        props[i] = np.clip(np.concatenate([near, far]), 0,
                           np.tile(ext, 2))
    return Batch(images, src_hws, props, np.ones((b, p), bool), gt, classes,
                 np.arange(g)[None, :] < n_gt[:, None])


def train_path():
    """Phase 7: Trainer.step on multipath_vgg16_train at full width."""
    cfg = preset("multipath_vgg16_train")
    m, d, t = cfg.model, cfg.data, cfg.train
    shape = (m.backbone, t.batch_size, d.image_size, d.max_proposals,
             d.rois_per_image, m.fc_dim, m.num_classes,
             len(m.integral_thresholds), m.dtype, t.freeze_backbone_stages)
    require(shape == ("vgg16", 8, (640, 640), 1000, 64, 4096, 81, 6,
                      "bfloat16", 2), f"unexpected train shape {shape}")
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device="cuda")
    state = trainer.init_state(0)
    n_params = seeded_normal_(trainer.model, 0)
    require(all(p.dtype == torch.float32
                for p in trainer.model.parameters()),
            "training parameters must be float32")
    frozen = {n: p.detach().clone()
              for n, p in trainer.model.named_parameters()
              if n in trainer.frozen}
    require(frozen and all(n.startswith(("backbone.conv1_", "backbone.conv2_"))
                           for n in frozen), f"frozen set {sorted(frozen)}")
    batch = trainer.put_batch(train_batch(cfg))
    torch.cuda.synchronize()
    log(f"[train] multipath_vgg16_train: {n_params / 1e6:.1f}M float32 "
        f"params ({len(frozen)} frozen tensors), {m.dtype} compute, on the "
        f"card in {time.perf_counter() - t0:.1f}s")

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, metrics = trainer.step(state, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    history = [metrics]
    iters = 10
    t0 = time.perf_counter()
    for _ in range(iters):
        state, metrics = trainer.step(state, batch)
        history.append(metrics)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    b = t.batch_size
    log(f"[train] first step {first_s:.2f} s; steady: {iters} steps x {b} "
        f"images in {dt:.3f} s = {1e3 * dt / iters:.2f} ms/step, "
        f"{b * iters / dt:.2f} img/s ({b * d.rois_per_image} ROIs/step); "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[train] kernel launches in {iters + 1} steps: {launches}")
    log("[train] last step: " + ", ".join(
        f"{k} {float(v):.4g}" for k, v in metrics.items()))
    losses = [float(h["loss"]) for h in history]
    require(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    require(all(float(h["num_fg"]) > 0 for h in history),
            "a step sampled no foreground ROI")
    for name in ("window_pool_multi", "window_grad", "window_rmw_grad"):
        require(launches[name] > 0, f"{name} never launched in training")
    for name in ("resident_pool", "window_pool_multi_quant",
                 "resident_pool_quant"):
        require(launches[name] == 0, f"{name} launched in training: "
                f"{launches}")
    params = dict(trainer.model.named_parameters())
    for name, before in frozen.items():
        require(torch.equal(params[name], before), f"frozen {name} moved")
    g31 = params["backbone.conv3_1.weight"].grad
    require(g31 is not None and bool(g31.abs().sum() > 0),
            "no gradient reached conv3_1")
    profile_once("train", "one step",
                 lambda: trainer.step(state, batch), top=24)
    return launches


# ------------------------------------------------------------- phase 8 ---

def check_and_time_quant_kernels(gen):
    """K1 and K2 with the int8 epilogue at the main path's shapes (bench.py's
    8 x 1000 proposals on random 640^2 c3/c4/c5 maps, C = 512, a random skip
    bias), float32 and bfloat16: bit for bit against quant_view_ref of the
    same kernel's own pooled output; against the fully plain version codes
    within 1 and scales within 1e-5 (float32) / 1e-2 (bfloat16) relative.
    In bf16, each timed against its plain version and against the kernel
    without the epilogue followed by the plain epilogue ("unfused").
    Returns {name: {"float32": max code error, "bfloat16": ..., "ms": t,
    "plain_ms": t, "bound_ms": t, "bound_by": ..., "extra": {...}}}."""
    _, _, boxes, _ = make_inputs(8, 1000, 640)
    rois = torch.from_numpy(boxes).cuda()
    levels = random_levels(8, 640, 512, gen, torch.bfloat16)
    out = {"window_pool_multi_quant": {"extra": {}},
           "resident_pool_quant": {"extra": {}}}
    for dtype in (torch.float32, torch.bfloat16):
        key = str(dtype)[6:]
        k1, k2, _, _ = pool_inputs(
            {n: (f.to(dtype), s) for n, (f, s) in levels.items()}, rois, 640)
        bias = (torch.randn(512, generator=gen, device="cuda") * 0.5).to(
            dtype)
        for name, kern, ref, args in (
                ("window_pool_multi_quant", roi_pool.window_pool_multi,
                 roi_pool.window_pool_multi_ref, k1),
                ("resident_pool_quant", roi_pool.resident_pool,
                 roi_pool.resident_pool_ref, k2)):
            q, s = kern(*args, quant_bias=bias)
            torch.cuda.synchronize()
            n = s.numel()

            def unfused():
                pooled = kern(*args).reshape(n, 7, 7, 512)
                return roi_pool.quant_view_ref(pooled, bias)

            own_q, own_s = unfused()
            require(torch.equal(q.reshape(n, 7, 7, 512), own_q)
                    and torch.equal(s.reshape(n), own_s),
                    f"{name} {key}: not bit-equal to the plain epilogue on "
                    f"its own pooled output")
            plain_q, plain_s = ref(*args, quant_bias=bias)
            if dtype == torch.bfloat16:
                log(f"[quant] {name.removesuffix('_quant')} bf16 pooled "
                    f"output: {100 * differ_share(kern(*args), ref(*args)):.4f}"
                    f"% differs from its plain version")
            diff = (q.int() - plain_q.int()).abs()
            code_err = int(diff.max())
            share = float((diff > 0).float().mean())
            scale_err = float(((s - plain_s).abs() / plain_s).max())
            tol = 1e-5 if dtype == torch.float32 else 1e-2
            require(code_err <= 1 and scale_err <= tol,
                    f"{name} {key} disagrees with its plain version: codes "
                    f"{code_err}, scales rel {scale_err}")
            log(f"[quant] {name} {key}, {n} views: bit-equal to the plain "
                f"epilogue on its own pooled output; against the plain "
                f"version max code error {code_err} ({100 * share:.4f}% of "
                f"codes), scales max rel err {scale_err:.3e} (tol {tol}) ok")
            out[name][key] = code_err
            out[name]["extra"].update({f"code_share_{key}": share,
                                       f"scale_rel_err_{key}": scale_err})
            del q, s, own_q, own_s, plain_q, plain_s, diff
            if dtype != torch.bfloat16:
                continue
            ms, plain_ms = alternate_ms(
                lambda: ref(*args, quant_bias=bias),
                lambda: kern(*args, quant_bias=bias), 2, 10)
            unfused_ms = cuda_ms(unfused, 10)
            flats, row0s, x0s = ((args[0], args[1], args[2])
                                 if name == "window_pool_multi_quant" else
                                 ([args[0]], [args[1]], [args[2]]))
            b_ms, b_by = pool_bound(flats, row0s, x0s, quant=True)
            log(f"[quant] {name} bf16: kernel {ms:.3f} ms "
                f"({window_read_gb_s(flats, row0s, ms):.0f} GB/s of window "
                f"reads), plain "
                f"{plain_ms:.3f} ms, kernel without the epilogue + plain "
                f"epilogue {unfused_ms:.3f} ms, bound {b_ms:.3f} ms "
                f"({b_by})")
            out[name].update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by)
            out[name]["extra"]["unfused_ms"] = round(unfused_ms, 4)
        del k1, k2
    return out


# -------------------------------------------------------- phases 9, 10 ---

def serving_path(preset_name: str, tag: str):
    """Detector on an int8 serving preset at 8 x 1000 proposals, 640^2:
    bench.py's flow, the preset's own layout (factored at its ranks) drawn
    in float32 on the card, then Detector's load-time transform quantizes
    it. Returns (launches, steady img/s)."""
    cfg = preset(preset_name)
    m = cfg.model
    b, p = 8, cfg.data.max_proposals
    canvas = cfg.data.image_size[0]
    require((b, p, canvas, m.head_quant) == (8, 1000, 640, "int8"),
            f"unexpected {preset_name} shape {(b, p, canvas, m.head_quant)}")
    t0 = time.perf_counter()
    float_model = build_model(dataclasses.replace(m, head_quant="none"),
                              param_dtype=torch.float32, device="cuda")
    n_params = seeded_normal_(float_model, 0)
    tree = convert.flax_from_state_dict(float_model.state_dict(), host=False)
    del float_model
    model = build_model(m, device="cuda")
    det = Detector(model, cfg, params=tree)
    del tree
    torch.cuda.synchronize()
    require(bool(model.head.fc6_f0.weight_i8.any()),
            "the int8 head holds no weights")
    log(f"[{tag}] {preset_name}: {n_params / 1e6:.1f}M float32 params "
        f"(fc6_rank {m.fc6_rank}, fc7_rank {m.fc7_rank}) drawn on the card "
        f"and quantized at load in {time.perf_counter() - t0:.1f}s")
    torch.cuda.empty_cache()
    inputs = make_inputs(b, p, canvas)

    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = det(*inputs)
    first_s = time.perf_counter() - t0
    dev_inputs = [torch.as_tensor(x).cuda() for x in inputs]
    iters = 10
    detect_batch(model, cfg, *dev_inputs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        res = detect_batch(model, cfg, *dev_inputs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    ips = b * iters / dt
    log(f"[{tag}] first call {first_s:.2f} s; steady: {iters} batches x {b} "
        f"images in {dt:.3f} s = {ips:.2f} img/s ({1e3 * dt / iters:.2f} "
        f"ms/batch); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[{tag}] kernel launches in this run: {launches}")
    require(launches["window_pool_multi_quant"] > 0
            and launches["resident_pool_quant"] > 0,
            f"a quant kernel never launched: {launches}")
    require(launches["window_pool_multi"] == 0
            and launches["resident_pool"] == 0,
            f"a pool kernel without the epilogue launched: {launches}")
    for key, shape in (("boxes", (8, 100, 4)), ("scores", (8, 100)),
                       ("classes", (8, 100)), ("valid", (8, 100))):
        require(out[key].shape == shape and tuple(res[key].shape) == shape,
                f"{key} shape {out[key].shape}")
    require(np.isfinite(out["boxes"]).all() and np.isfinite(
        out["scores"]).all(), "non-finite detections")
    profile_once(tag, "one batch",
                 lambda: detect_batch(model, cfg, *dev_inputs))
    return launches, ips


# ------------------------------------------------------------ phase 11 ---

# The single-level backwards are held to atol 1e-4 x max(1, max |g|): on
# the c5 context group the gradient sums thousands of overlapping windows
# and reaches |g| near 100 (the run prints it), where one float32 ulp is
# 7.6e-6 and two float32 summation orders (K4's atomics, index_put_) differ
# by about 1e-4.
GRAD_ATOL = 1e-4

def check_and_time_window_pool(pyr, views, img_idx):
    """K5 against its plain version on `views` (rows absolute) over the
    stacked c3 pyramid, float32 (atol 1e-4) and bfloat16 (rtol/atol 1e-2),
    then timed against it in bf16. Returns {"float32": err, "bfloat16":
    err, "ms": t, "plain_ms": t, "bound_ms": t, "bound_by": ...}."""
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        (flat,), (row0,), (x0,), (wy,), (wx,) = k1_args(pyr, ("c3",), views,
                                                        img_idx, dtype)
        args = (flat, row0, x0, wy, wx)
        got = roi_pool.window_pool(*args)
        torch.cuda.synchronize()
        err, tol = compare("window_pool", dtype, got,
                           roi_pool.window_pool_ref(*args))
        out[str(dtype)[6:]] = err
        log(f"[pool_api] window_pool {str(dtype)[6:]}, {row0.numel()} views "
            f"over c3, max abs err {err:.3e} ({tol}) ok")
        del got
    ms, plain_ms = alternate_ms(lambda: roi_pool.window_pool_ref(*args),
                                lambda: roi_pool.window_pool(*args), 2, 10)
    b_ms, b_by = pool_bound([flat], [row0], [x0], quant=False)
    log(f"[pool_api] window_pool bf16 kernel {ms:.3f} ms "
        f"({window_read_gb_s([flat], [row0], ms):.0f} GB/s of window reads), "
        f"plain "
        f"{plain_ms:.3f} ms, bound {b_ms:.3f} ms ({b_by})")
    out.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    return out


def pool_api_path(gen):
    """Phase 11: K5 checked and timed (check_and_time_window_pool), then
    the single-level entry points as the path `pool_api`, launches counted
    from 0: batched_pyramid_pool on the main path's 8000 1x views over c3
    in bf16; in float32 with their backward, batched_pyramid_pool(trainable)
    on the same views, batched_pyramid_pool_resident(trainable) on the
    8 x 3000 context views over c5, and WindowPoolMulti without rows_list
    on the train geometry (512 1x views over c3+c4+c5). After the path,
    each gradient against autograd through the plain forward, float32,
    atol 1e-4 x max(1, max |g|). Returns (K5's stats, the path's
    launches)."""
    _, _, boxes, _ = make_inputs(8, 1000, 640)
    rois = torch.from_numpy(boxes).cuda()
    levels = random_levels(8, 640, 512, gen, torch.float32)
    pyr = {name: roi_pyramid.build_pyramid_batch(f, 1.0 / s)
           for name, (f, s) in levels.items()}
    del levels
    ones, ones_img = group_views(rois, FOVEAL[:1])
    ctx, _ = group_views(rois, CONTEXT)
    _, _, train_boxes, _ = make_inputs(8, 64, 640)
    train_ones, train_img = group_views(torch.from_numpy(train_boxes).cuda(),
                                        FOVEAL[:1])
    stats = check_and_time_window_pool(pyr, ones, ones_img)
    names = [n for n, _ in LEVELS]
    flat3, meta3 = pyr["c3"]
    flat5, meta5 = pyr["c5"]
    c = flat3.shape[-1]
    g1 = torch.randn((ones.shape[0], 7, 7, c), generator=gen, device="cuda")
    g2 = torch.randn((ctx.shape[0], 7, 7, c), generator=gen, device="cuda")
    g3 = torch.randn((train_ones.shape[0], 7, 7, c), generator=gen,
                     device="cuda")
    leaf = {n: pyr[n][0].detach().requires_grad_() for n in names}
    train_geo = k1_args(pyr, names, train_ones, train_img)[1:]

    reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        pooled = roi_pool.batched_pyramid_pool(flat3.bfloat16(), meta3, ones,
                                               ones_img)
    out = roi_pool.batched_pyramid_pool(leaf["c3"], meta3, ones, ones_img,
                                        trainable=True)
    (k5_grad,) = torch.autograd.grad((out * g1).sum(), leaf["c3"])
    out = roi_pool.batched_pyramid_pool_resident(leaf["c5"], meta5, ctx, 8,
                                                 trainable=True)
    (k2_grad,) = torch.autograd.grad((out * g2).sum(), leaf["c5"])
    flats = [leaf[n] for n in names]
    out = roi_pool.WindowPoolMulti.apply(train_geo, None, None, *flats)
    k1_grads = torch.autograd.grad((out * g3).sum(), flats)
    torch.cuda.synchronize()
    launches = read_launches()
    log(f"[pool_api] path: K5 forward, K5/K2/K1 forward + backward in "
        f"{time.perf_counter() - t0:.3f} s; launches {launches}")
    del out
    require(launches["window_pool"] == 2 and launches["resident_pool"] == 1
            and launches["window_pool_multi"] == 1
            and launches["window_rmw_grad"] == 5
            and launches["window_grad"] == 0
            and launches["window_pool_multi_quant"] == 0
            and launches["resident_pool_quant"] == 0,
            f"pool_api launched other kernels than K5 x 2, K2, K1 and K4 x 5:"
            f" {launches}")
    require(pooled.shape == (ones.shape[0], 7, 7, c)
            and pooled.dtype == torch.bfloat16
            and bool(torch.isfinite(pooled).all()), "K5's bf16 pool")

    def plain_grad(fn, flats, gout):
        flats = [f.detach().requires_grad_() for f in flats]
        return torch.autograd.grad((fn(*flats) * gout).sum(), flats)

    row0, x0, wy, wx = roi_pool.view_geometry(meta3, ones)
    row0 = row0 + ones_img * meta3.flat.shape[0]
    checks = [("window_pool_trainable backward, c3", k5_grad, plain_grad(
        lambda f: roi_pool.window_pool_ref(f, row0, x0, wy, wx), [flat3],
        g1)[0])]
    row0, x0, wy, wx = roi_pool.view_geometry(meta5, ctx)
    rows, wmax = meta5.flat.shape[:2]
    v = ctx.shape[0] // 8
    plain = plain_grad(lambda f: roi_pool.resident_pool_ref(
        f.reshape(8, rows, wmax, c), row0.reshape(8, v), x0.reshape(8, v),
        wy.reshape(8, v, 7, 10), wx.reshape(8, v, 7, 16)).reshape(-1, 7, 7, c),
        [flat5], g2)[0]
    checks.append(("resident_pool_trainable backward, c5", k2_grad, plain))
    plain = plain_grad(lambda *fs: roi_pool.window_pool_multi_ref(
        list(fs), *train_geo), [pyr[n][0] for n in names], g3)
    checks += [(f"WindowPoolMulti backward without rows_list, {n}", got,
                want) for n, got, want in zip(names, k1_grads, plain)]
    errs = []
    for what, got, want in checks:
        require(got.shape == want.shape and got.dtype == want.dtype,
                f"{what}: {got.shape}/{got.dtype} vs {want.shape}/"
                f"{want.dtype}")
        err = (got - want).abs().max().item()
        scale = max(1.0, want.abs().max().item())
        require(err <= GRAD_ATOL * scale, f"{what} disagrees with autograd "
                f"of the plain forward: max abs err {err} at max |g| {scale}")
        log(f"[pool_api] {what}: max abs err {err:.3e} (atol 1e-4 x max(1, "
            f"max |g| = {scale:.2f})) ok")
        errs.append(err)
    stats["extra"] = {"backward_max_abs_err": max(errs)}
    return stats, launches


# ------------------------------------------------------------ phase 12 ---

def probe_bound(flat, row0, x0):
    """bound() of one P call: the distinct cells under its windows read
    once, row0/x0 read once, the (N, 49, C) bf16 output written once; 160
    float32 adds per view and channel."""
    rows, wmax, c = flat.shape
    n = row0.numel()
    cells = window_cells(row0, x0, rows, wmax)
    return bound(cells * c * flat.element_size() + n * 8 + n * 49 * c * 2,
                 n * c * 160)


def probe_path():
    """Phase 12: P against its plain version at its tool's shapes, bf16 and
    int8 windows (rtol/atol 1e-2), each timed against it; then the tool's
    bench for each dtype as the path `probe`, launches counted from 0.
    Returns (stats with the bf16 numbers as the row's and the int8 ones in
    "extra", the path's launches)."""
    stats = {"extra": {}}
    for dtype in (torch.bfloat16, torch.int8):
        key = str(dtype)[6:]
        args = probe.probe_inputs(dtype)
        got = probe.window_read_probe(*args)
        torch.cuda.synchronize()
        err, tol = compare(f"window_read_probe {key}", torch.bfloat16, got,
                           probe.window_read_probe_ref(*args))
        del got
        ms, plain_ms = alternate_ms(lambda: probe.window_read_probe_ref(*args),
                                    lambda: probe.window_read_probe(*args),
                                    1, 10)
        b_ms, b_by = probe_bound(*args)
        n, c = args[1].numel(), args[0].shape[-1]
        read_gb_s = n * 160 * c * args[0].element_size() / ms / 1e6
        log(f"[probe] window_read_probe {key} windows, {n} views: max abs "
            f"err {err:.3e} ({tol}) ok; kernel {ms:.4f} ms ({read_gb_s:.1f} "
            f"GB/s of window reads), plain {plain_ms:.3f} ms, bound "
            f"{b_ms:.4f} ms ({b_by})")
        if dtype == torch.bfloat16:
            stats.update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by)
            stats["extra"]["read_gb_s"] = read_gb_s
        else:
            stats["extra"].update(
                max_abs_err_int8=err, int8_ms=round(ms, 4),
                int8_plain_ms=round(plain_ms, 4),
                int8_bound_ms=round(b_ms, 4), int8_bound_by=b_by,
                int8_read_gb_s=read_gb_s)
        del args
        torch.cuda.empty_cache()
    reset_launches()
    bf16 = probe.bench(torch.bfloat16)
    int8 = probe.bench(torch.int8)
    launches = read_launches()
    log(f"[probe] bench: bf16 / int8 time {bf16['ms'] / int8['ms']:.3f}x; "
        f"launches {launches}")
    require(launches["window_read_probe"] > 0
            and sum(launches.values()) == launches["window_read_probe"],
            f"the probe's bench launched {launches}")
    stats["extra"].update(bench_ms=round(bf16["ms"], 4),
                          int8_bench_ms=round(int8["ms"], 4),
                          bench_read_gb_s=bf16["gb_s"],
                          int8_bench_read_gb_s=int8["gb_s"])
    return stats, launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this check needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    lib_path, seconds, nvcc_out = _build.build(verbose=True)
    _build.kernels()
    log(f"[build] {lib_path.name} built in {seconds:.1f} s")
    for line in nvcc_out.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[build]   {line.strip()}")
    log_pool_instances()

    gen = torch.Generator(device="cuda").manual_seed(0)
    stats = check_and_time_kernels(gen)
    torch.cuda.empty_cache()
    eval_launches, bf16_ips = main_path()
    torch.cuda.empty_cache()
    grad_stats, k1_train = check_and_time_grad_kernels(gen)
    stats.update(grad_stats)
    torch.cuda.empty_cache()
    train_launches = train_path()
    torch.cuda.empty_cache()
    stats.update(check_and_time_quant_kernels(gen))
    torch.cuda.empty_cache()
    int8_launches, int8_ips = serving_path("multipath_vgg16_int8", "int8")
    torch.cuda.empty_cache()
    svd_launches, svd_ips = serving_path("multipath_vgg16_int8_svd",
                                         "int8_svd")
    log(f"[serving] steady img/s at 8 x 1000 proposals, 640^2, this process "
        f"and card: bf16 {bf16_ips:.2f} (phase 4), int8 {int8_ips:.2f}, "
        f"int8+SVD {svd_ips:.2f}")
    torch.cuda.empty_cache()
    stats["window_pool"], pool_api_launches = pool_api_path(gen)
    torch.cuda.empty_cache()
    stats["window_read_probe"], probe_launches = probe_path()

    # launches: each path's run, counted from 0, and their sum; K1's
    # train_max_abs_err*: its forward at the train path's groups; the quant
    # kernels' max_abs_err*: the largest code difference from the plain
    # version (their epilogue is bit-equal on their own pooled output);
    # P's max_abs_err: its bf16 windows' (its output is bf16 either way)
    paths = {"eval": eval_launches, "train": train_launches,
             "int8": int8_launches, "int8_svd": svd_launches,
             "pool_api": pool_api_launches, "probe": probe_launches}
    extra = {"window_pool_multi": {
        "train_max_abs_err": k1_train["float32"],
        "train_max_abs_err_bf16": k1_train["bfloat16"]}}
    kernels = [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces,
        "launches": sum(counts[name] for counts in paths.values()),
        **{f"{path}_launches": counts[name]
           for path, counts in paths.items()},
        **({"max_abs_err": stats[name]["float32"],
            "max_abs_err_bf16": stats[name]["bfloat16"]}
           if "float32" in stats[name]
           else {"max_abs_err": stats[name]["max_abs_err"]}),
        "ms": round(stats[name]["ms"], 4),
        "plain_ms": round(stats[name]["plain_ms"], 4),
        "bound_ms": round(stats[name]["bound_ms"], 4),
        "bound_by": stats[name]["bound_by"],
        "library_ms": None,   # no single PyTorch call computes the function
        **extra.get(name, {}), **stats[name].get("extra", {}),
    } for name, (source, replaces, _, _) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
