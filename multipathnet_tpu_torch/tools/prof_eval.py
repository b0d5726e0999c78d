"""Inference stage profiler — port of tools/prof_eval.py: the eval stage
table (resize / trunk / pool / heads / NMS / full graph) at the bench
shapes, each stage timed alone on inputs already on the device through
utils/profiling.timed (steady ms a call, synchronized on the card).

    python -m multipathnet_tpu_torch.tools.prof_eval \
        [--preset multipath_vgg16_int8] [--backbone resnet101] \
        [--batch 8] [--proposals 1000] [--canvas 640] [--device cuda]

Weights are bench.py's: every float parameter normal * 0.02 from a seeded
generator on the device, then Detector's load-time transforms (int8
quantization, SVD factorization) where the preset asks for them. The
prefix rows run resize -> ... -> stage as one call, so their differences
are each stage's cost inside the whole path. It runs on the card unless
--device cpu; the reference tool's compile-cache option has no
counterpart (the port compiles its kernels once, at first use).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def eval_config(name: str = "multipath_vgg16_int8", backbone: str = "",
                proposals: int = 1000, canvas: int = 640):
    """The reference tool's config: the preset at a canvas^2 canvas and
    `proposals` a image, its trunk swapped for `backbone` if given."""
    from multipathnet_tpu_torch.core.config import preset

    cfg = preset(name)
    cfg = cfg.replace(data=dataclasses.replace(
        cfg.data, image_size=(canvas, canvas), max_proposals=proposals))
    if backbone:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    backbone=backbone))
    return cfg


def bench_inputs(b: int, pn: int, s: int, device, seed: int = 0):
    """bench.py's generator: uint8 images, full valid extents, proposals
    with x1, y1 in [0, 0.7 s) and sides in [16, 0.3 s)."""
    rng = np.random.default_rng(seed)
    images = torch.as_tensor(rng.integers(0, 255, (b, s, s, 3)),
                             dtype=torch.uint8, device=device)
    hws = torch.full((b, 2), float(s), device=device)
    x1 = rng.uniform(0, s * 0.7, (b, pn)).astype(np.float32)
    y1 = rng.uniform(0, s * 0.7, (b, pn)).astype(np.float32)
    w = rng.uniform(16, s * 0.3, (b, pn)).astype(np.float32)
    h = rng.uniform(16, s * 0.3, (b, pn)).astype(np.float32)
    props = torch.as_tensor(np.stack([x1, y1, x1 + w, y1 + h], -1),
                            device=device)
    return images, hws, props, torch.ones((b, pn), dtype=torch.bool,
                                          device=device)


@torch.inference_mode()
def run(cfg, *, batch: int = 8, iters: int = 10, warmup: int = 2,
        device=None, seed: int = 0) -> dict:
    """-> {row name: steady ms a call} of the stage table, logged as the
    reference tool prints it, plus "img/s" of the full detect_batch."""
    from multipathnet_tpu_torch.core.device import resolve_device
    from multipathnet_tpu_torch.data import transforms
    from multipathnet_tpu_torch.eval.detect import (Detector, detect_batch,
                                                    score_batch)
    from multipathnet_tpu_torch.models import convert
    from multipathnet_tpu_torch.models.multipath import build_model
    from multipathnet_tpu_torch.ops import nms as nms_ops
    from multipathnet_tpu_torch.ops import quant as quant_ops
    from multipathnet_tpu_torch.tools.mesh_runs import seeded_normal_
    from multipathnet_tpu_torch.utils.profiling import timed

    dev = resolve_device(device)
    m = cfg.model
    s = cfg.data.image_size[0]
    pn = cfg.data.max_proposals
    float_model = build_model(dataclasses.replace(
        m, head_quant="none", fc6_rank=0, fc7_rank=0), device=dev)
    seeded_normal_(float_model, seed)
    model = build_model(m, device=dev)
    Detector(model, cfg, device=dev, params=convert.flax_from_state_dict(
        float_model.state_dict(), host=False))
    del float_model
    model.eval()
    log(f"device={dev} preset={cfg.name} backbone={m.backbone} "
        f"quant={m.head_quant}")
    images, hws, props, pmask = bench_inputs(batch, pn, s, dev, seed)
    ms = {}

    def row(name, label, fn, *args):
        sec, out = timed(fn, *args, iters=iters, warmup=warmup)
        ms[name] = 1e3 * sec
        log(f"{label:<20}{ms[name]:.1f} ms")
        return out

    canvases, scales = row("resize", "resize/normalize:",
                           lambda: transforms.batch_resize_to_canvas(
                               images, (s, s), hws,
                               preprocess=m.preprocess))
    feats = row("trunk", "trunk + reduce:", model.features, canvases)
    rois = props * scales[:, None, None]
    pooled = row("pool", "pool_rois:",
                 lambda: model.pool_rois(feats, rois, (s, s)))
    row("heads", "heads:", model.predict_rois, pooled)
    boxes, probs = row("score_batch", "score_batch:",
                       lambda: score_batch(model, cfg, images, hws, props))
    log("                  (resize+trunk+pool+heads+decode)")
    e = cfg.eval
    row("nms", "multiclass NMS:",
        lambda: nms_ops.multiclass_nms(
            boxes[:, :, 1:, :], probs[:, :, 1:], pmask,
            score_threshold=e.score_threshold,
            iou_threshold=e.nms_iou_threshold,
            pre_nms_per_class=e.pre_nms_per_class,
            max_detections=e.max_detections))
    sec, _ = timed(lambda: detect_batch(model, cfg, images, hws, props,
                                        pmask), iters=iters, warmup=warmup)
    ms["detect_batch"] = 1e3 * sec
    ms["img/s"] = batch / sec
    log(f"full detect_batch: {ms['detect_batch']:.1f} ms  "
        f"({ms['img/s']:.1f} img/s)")

    log("-- prefix rows (deltas are each stage's cost in the path) --")

    def upto_trunk():
        canv, sc = transforms.batch_resize_to_canvas(
            images, (s, s), hws, preprocess=m.preprocess)
        return model.features(canv), sc

    def upto_pool():
        fts, sc = upto_trunk()
        return model.pool_rois(fts, props * sc[:, None, None], (s, s))

    row("prefix_trunk", "resize+trunk:", upto_trunk)
    row("prefix_pool", "..+pool:", upto_pool)
    log(f"                  (pool delta "
        f"{ms['prefix_pool'] - ms['prefix_trunk']:.1f})")
    if m.head_quant == "int8":
        def upto_quant():
            p = upto_pool()
            b_, f_, r_, g_, _, c_ = p.shape
            dt = model.head.dtype
            x = torch.relu(p.to(dt) + model.head.skip_bias.to(dt))
            return quant_ops.quantize_rows(x.reshape(b_, f_, r_,
                                                     g_ * g_ * c_))

        row("prefix_quant", "..+bias/relu/quant:", upto_quant)
        log(f"                  (quant delta "
            f"{ms['prefix_quant'] - ms['prefix_pool']:.1f})")
    log("(score_batch = ..+heads+decode; detect_batch = ..+NMS)")
    return ms


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", default="multipath_vgg16_int8")
    p.add_argument("--backbone", default="")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--proposals", type=int, default=1000)
    p.add_argument("--canvas", type=int, default=640)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    run(eval_config(args.preset, args.backbone, args.proposals, args.canvas),
        batch=args.batch, device=args.device)


if __name__ == "__main__":
    main()
