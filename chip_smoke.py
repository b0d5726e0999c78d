"""Chip smoke test of the PyTorch + CUDA port (multipathnet_tpu_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):
  1. device: a CUDA device must be present; prints nvidia-smi's name and
     power limit.
  2. build: compiles csrc/ with nvcc (ops/_build.py) and prints the time.
  3. kernels: K1 (window_pool_multi) and K2 (resident_pool) against their
     plain PyTorch versions on random 640^2 c3/c4/c5 maps in float32
     (atol 1e-4) and bfloat16 (rtol 1e-2, atol 1e-2: one bf16 rounding of a
     float32 sum), at the main path's shapes (8 images x 1000 proposals:
     K1 8000 views x 3 levels, K2 8 x 3000 views) and on 2 images with
     2048 ROIs at every pyramid scale, border ROIs included; then both
     timed against their plain versions on the main path's bf16 inputs.
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
The line before the last is a JSON object with each kernel's launches
(phase 4's and phase 7's runs, each counted from 0, and their sum), error
and times; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import time

import numpy as np
import torch

from multipathnet_tpu_torch.core.config import preset
from multipathnet_tpu_torch.eval.detect import Detector, detect_batch
from multipathnet_tpu_torch.models.multipath import build_model
from multipathnet_tpu_torch.ops import _build, roi_pool, roi_pyramid
from multipathnet_tpu_torch.ops.boxes import expand
from multipathnet_tpu_torch.train.loop import Batch, Trainer

POOL_SOURCE = "multipathnet_tpu_torch/csrc/roi_window_pool.cu"
GRAD_SOURCE = "multipathnet_tpu_torch/csrc/roi_window_grad.cu"
KERNELS = {  # name -> (source, the TPU kernel it replaces)
    "window_pool_multi": (POOL_SOURCE,
                          "multipathnet_tpu/ops/roi_pallas.py:472"),
    "resident_pool": (POOL_SOURCE, "multipathnet_tpu/ops/roi_pallas.py:940"),
    "window_grad": (GRAD_SOURCE, "multipathnet_tpu/ops/roi_pallas.py:659"),
    "window_rmw_grad": (GRAD_SOURCE,
                        "multipathnet_tpu/ops/roi_pallas.py:745"),
}


def reset_launches() -> None:
    for name in KERNELS:
        getattr(roi_pool, name).launches = 0


def read_launches() -> dict:
    return {name: getattr(roi_pool, name).launches for name in KERNELS}
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


def compare(name, dtype, got, want):
    """Max abs error of a kernel's output against its plain version, held
    to atol 1e-4 in float32 and to rtol/atol 1e-2 in bfloat16 (one bf16
    rounding of a float32 sum)."""
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{name}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    err = (got.float() - want.float()).abs().max().item()
    if dtype == torch.float32:
        ok, tol = err <= 1e-4, "atol 1e-4"
    else:
        ok = torch.allclose(got.float(), want.float(), rtol=1e-2, atol=1e-2)
        tol = "rtol 1e-2, atol 1e-2"
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
    bf16 inputs. Returns {name: {"f32": err, "bf16": err, "ms": t,
    "plain_ms": t}} of the main-path case."""
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
                    log(f"[kernels] main path: {name} bf16 kernel {ms:.3f} "
                        f"ms, plain {plain_ms:.3f} ms")
                    out[name].update(ms=ms, plain_ms=plain_ms)
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
    log(f"[main] steady: {iters} batches x {b} images in {dt:.3f} s = "
        f"{b * iters / dt:.2f} img/s ({1e3 * dt / iters:.2f} ms/batch); "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[main] kernel launches in the main-path run: {launches}")
    require(launches["window_pool_multi"] > 0 and launches["resident_pool"]
            > 0, f"a kernel of the path never launched: {launches}")
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
    return launches


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
    "bfloat16": err, "ms": t, "plain_ms": t}} for K3 and K4, K1's train
    errors)."""
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
        log(f"[grad] {name} kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        out[name].update(ms=ms, plain_ms=plain_ms)
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
    require(launches["resident_pool"] == 0,
            f"resident_pool launched in training: {launches}")
    params = dict(trainer.model.named_parameters())
    for name, before in frozen.items():
        require(torch.equal(params[name], before), f"frozen {name} moved")
    g31 = params["backbone.conv3_1.weight"].grad
    require(g31 is not None and bool(g31.abs().sum() > 0),
            "no gradient reached conv3_1")
    profile_once("train", "one step",
                 lambda: trainer.step(state, batch), top=24)
    return launches


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

    gen = torch.Generator(device="cuda").manual_seed(0)
    stats = check_and_time_kernels(gen)
    torch.cuda.empty_cache()
    eval_launches = main_path()
    torch.cuda.empty_cache()
    grad_stats, k1_train = check_and_time_grad_kernels(gen)
    stats.update(grad_stats)
    torch.cuda.empty_cache()
    train_launches = train_path()

    # launches: the eval and train paths' runs, each counted from 0;
    # K1's train_max_abs_err*: its forward at the train path's groups
    kernels = [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces,
        "launches": eval_launches[name] + train_launches[name],
        "eval_launches": eval_launches[name],
        "train_launches": train_launches[name],
        "max_abs_err": stats[name]["float32"],
        "max_abs_err_bf16": stats[name]["bfloat16"],
        **({"train_max_abs_err": k1_train["float32"],
            "train_max_abs_err_bf16": k1_train["bfloat16"]}
           if name == "window_pool_multi" else {}),
        "ms": round(stats[name]["ms"], 4),
        "plain_ms": round(stats[name]["plain_ms"], 4),
    } for name, (source, replaces) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
