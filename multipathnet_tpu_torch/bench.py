"""Benchmark harness — port of bench.py: prints ONE JSON line.

Headline metric: images/sec/card for MultiPath VGG-16 at 1000 proposals an
image, proposals to detections on the device (batched inference, config
3), on the full serving configuration `multipath_vgg16_int8_svd` (int8 FC
heads and the Fast R-CNN §3.1 truncated-SVD ranks fc6 1024 / fc7 256): one
float tree, factored layout included, drawn on the device and quantized at
load by `Detector` (eval/detect.serving_params). `vs_baseline` compares
with the Fast R-CNN paper's published test speed, about 0.3 s an image
(3.33 img/s) for VGG-16 on a K40, proposals excluded (BASELINE.md).

The same line carries the bf16 model and the plain int8 config measured in
the same process, so a config change and a kernel change stay apart:
  {"metric": ..., "value": <headline>, ...,
   "companions": {"bf16": x, "int8": y}}

    python -m multipathnet_tpu_torch.bench [--batch 8] [--proposals 1000]
        [--canvas 640] [--iters 20] [--preset NAME] [--backbone NAME]
        [--no-companions] [--device cuda|cpu]

It runs on the card unless --device cpu, and raises where there is none.
Diagnostics go to stderr: per preset the parameter count, the first call
split into the kernel build (ops/_build.py, cached under build/kernels/)
and the call itself, the detections of image 0, img/s, and the kernel
launches of the timed run as one JSON object
(`[PRESET] kernel launches: {...}`). stdout carries exactly one JSON line.
The reference's --compile-cache has no counterpart: it times XLA's
persistent compile cache, and the port compiles its kernels once, at
first use.

Weights are bench.py's: every leaf of the variable tree normal * 0.02 from
one seeded generator on the device. That includes a ResNet trunk's frozen
BN statistics, as jax.eval_shape of the whole init includes flax's
`batch_stats`, so about half of the variances are negative and the trunk's
features are NaN from its first BN on (--backbone resnet*): such a run
times a graph of NaN features whose NMS finds no candidate.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time

import numpy as np
import torch

BASELINE_IMG_PER_SEC = 1.0 / 0.3  # Fast R-CNN paper, VGG-16, K40
# the companions: same kernels, serving transforms off or partial
COMPANIONS = (("bf16", "multipath_vgg16_batched"),
              ("int8", "multipath_vgg16_int8"))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def eval_config(name: str = "multipath_vgg16_int8", backbone: str = "",
                proposals: int = 1000, canvas: int = 640):
    """The preset at a canvas^2 canvas and `proposals` an image, its trunk
    swapped for `backbone` if given."""
    from multipathnet_tpu_torch.core.config import preset

    cfg = preset(name)
    cfg = cfg.replace(data=dataclasses.replace(
        cfg.data, image_size=(canvas, canvas), max_proposals=proposals))
    if backbone:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    backbone=backbone))
    return cfg


def make_inputs(args, seed: int = 0):
    """bench.py's batch, bit for bit: uint8 images, full-canvas valid
    extents, proposals with x1, y1 in [0, 0.7 s) and sides in [16, 0.3 s)
    of a canvas of side s, all valid."""
    rng = np.random.default_rng(seed)
    b, p_, s = args.batch, args.proposals, args.canvas
    images = rng.integers(0, 255, (b, s, s, 3), dtype=np.uint8)
    src_hws = np.full((b, 2), float(s), np.float32)
    x1 = rng.uniform(0, s * 0.7, (b, p_)).astype(np.float32)
    y1 = rng.uniform(0, s * 0.7, (b, p_)).astype(np.float32)
    w = rng.uniform(16, s * 0.3, (b, p_)).astype(np.float32)
    h = rng.uniform(16, s * 0.3, (b, p_)).astype(np.float32)
    proposals = np.stack([x1, y1, x1 + w, y1 + h], -1)
    prop_mask = np.ones((b, p_), bool)
    return images, src_hws, proposals, prop_mask


@torch.no_grad()
def draw_normal_(model, seed: int) -> None:
    """bench.py's draw: every entry of the state dict (parameters and the
    frozen BN statistics, the leaves of the reference's whole variable
    tree) normal * 0.02, from one seeded generator on the model's device,
    in state-dict order. tools/mesh_runs.seeded_normal_ draws the
    parameters alone."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(seed)
    for t in model.state_dict(keep_vars=True).values():
        t.copy_(torch.randn(t.shape, generator=gen, device=dev) * 0.02)


def count_params(model) -> int:
    """The leaves of the model's variable tree, as bench.py counts them:
    every state-dict entry, int8 kernels, their scales and BN statistics
    included."""
    return sum(t.numel() for t in model.state_dict().values())


def build_preset(preset_name: str, args, device, **model):
    """bench.py's serving flow on `device`, for the preset at
    args.canvas^2, args.proposals an image and args.backbone's trunk if
    given, with the model fields `model` overrides (foveal_topology="dense"
    for one): the preset's float model in its own layout (factor layers
    included) in float32, drawn by draw_normal_ from seed 0, then
    `Detector`'s load-time transform into the preset's model (int8
    quantization where head_quant="int8"). -> (Detector, parameter count
    after the transform)."""
    from multipathnet_tpu_torch.eval.detect import Detector
    from multipathnet_tpu_torch.models import convert
    from multipathnet_tpu_torch.models.multipath import build_model

    cfg = eval_config(preset_name, args.backbone, args.proposals,
                      args.canvas)
    if model:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, **model))
    m = cfg.model
    float_model = build_model(dataclasses.replace(m, head_quant="none"),
                              param_dtype=torch.float32, device=device)
    draw_normal_(float_model, 0)
    tree = convert.flax_from_state_dict(float_model.state_dict(), host=False)
    del float_model
    det = Detector(build_model(m, device=device), cfg, device=device,
                   params=tree)
    return det, count_params(det.model)


def measure(preset_name: str, args, raw_inputs, device) -> float:
    """Build the preset's detector with random weights on the device, run
    detect_batch once (logged), once more to warm up, then time
    `args.iters` batches on device-resident inputs; -> img/s. The model is
    released on return so the presets run back to back in one process."""
    from multipathnet_tpu_torch.core.config import preset
    from multipathnet_tpu_torch.eval.detect import detect_batch
    from multipathnet_tpu_torch.ops import _build
    from multipathnet_tpu_torch.utils.profiling import (counters,
                                                        kernel_launches,
                                                        synchronize)

    log(f"[{preset_name}] init "
        f"{args.backbone or preset(preset_name).model.backbone} params...")
    t0 = time.perf_counter()
    det, n_params = build_preset(preset_name, args, device)
    model, cfg = det.model, det.cfg
    synchronize(next(model.parameters()))
    log(f"[{preset_name}] params: {n_params / 1e6:.1f}M on device "
        f"({time.perf_counter() - t0:.1f}s)")
    inputs = [torch.as_tensor(x, device=device) for x in raw_inputs]

    log(f"[{preset_name}] kernel build + first call...")
    t0 = time.perf_counter()
    if device.type == "cuda":
        _build.kernels()
    t1 = time.perf_counter()
    out = detect_batch(model, cfg, *inputs)
    synchronize(out)
    t2 = time.perf_counter()
    log(f"[{preset_name}] first call {t2 - t0:.1f}s (kernel build "
        f"{t1 - t0:.1f}s, first call {t2 - t1:.1f}s); detections img0: "
        f"{int(out['valid'][0].sum())}")
    synchronize(detect_batch(model, cfg, *inputs))

    before = counters()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        out = detect_batch(model, cfg, *inputs)
    synchronize(out)
    dt = time.perf_counter() - t0
    launches = kernel_launches(before)
    ips = args.batch * args.iters / dt
    log(f"[{preset_name}] {args.iters} iters x {args.batch} imgs in "
        f"{dt:.2f}s = {ips:.1f} img/s")
    log(f"[{preset_name}] kernel launches: {json.dumps(launches)}")
    del det, model, out, inputs
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return ips


def tag_for(cfg_model) -> str:
    parts = []
    if cfg_model.head_quant == "int8":
        parts.append("int8")
    if cfg_model.fc6_rank or cfg_model.fc7_rank:
        parts.append(f"SVD({cfg_model.fc6_rank}/{cfg_model.fc7_rank})")
    return ", " + "+".join(parts) + " FC heads" if parts else ""


def main(argv=None) -> None:
    from multipathnet_tpu_torch.core.device import resolve_device

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--proposals", type=int, default=1000)
    p.add_argument("--canvas", type=int, default=640)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--preset", default="multipath_vgg16_int8_svd")
    p.add_argument("--backbone", default="",
                   help="override cfg.model.backbone (e.g. resnet101)")
    p.add_argument("--no-companions", action="store_true",
                   help="headline preset only (skip the bf16/int8 companion "
                        "measurements)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="run on the CUDA card (default) or the CPU")
    args = p.parse_args(argv)
    device = resolve_device(None if args.device == "cuda" else args.device)
    # the GEMMs chip_smoke.py times: full float32, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"device={device} "
        + (f"{torch.cuda.get_device_name(device)} " if device.type == "cuda"
           else "")
        + f"torch {torch.__version__} CUDA {torch.version.cuda}")

    raw_inputs = make_inputs(args)
    # stdout carries the record alone
    with contextlib.redirect_stdout(sys.stderr):
        ips = measure(args.preset, args, raw_inputs, device)
        companions = {}
        if not args.no_companions:
            for key, name in COMPANIONS:
                if name == args.preset:
                    companions[key] = round(ips, 3)
                    continue
                companions[key] = round(
                    measure(name, args, raw_inputs, device), 3)

    cfg = eval_config(args.preset, args.backbone, args.proposals,
                      args.canvas)
    b, p_, s = args.batch, args.proposals, args.canvas
    record = {
        "metric": f"images/sec/chip (MultiPath {cfg.model.backbone}"
                  f"{tag_for(cfg.model)}, {p_} proposals/img, "
                  f"{s}x{s}, batch {b}, proposals->detections on device)",
        "value": round(ips, 3),
        "unit": "images/sec",
        "vs_baseline": round(ips / BASELINE_IMG_PER_SEC, 3),
    }
    if companions:
        record["companions"] = companions
    print(json.dumps(record))


if __name__ == "__main__":
    main()
