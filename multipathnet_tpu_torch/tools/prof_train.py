"""Training-step profiler — port of tools/prof_train.py.

    python -m multipathnet_tpu_torch.tools.prof_train [--stages] \
        [--batch 8] [--size 640] [--rois 64] [--freeze 2] [--iters 10] \
        [--device cuda]

At the bench shapes (MultiPath VGG-16, batch 8, 640 x 640, 1000 proposals,
64 ROIs an image, conv1-2 frozen) it measures the first step, one step
alone and the steady chained step (the headline ms/step), each ended by a
synchronize on the card; with --stages also the forward and
forward+backward of each stage (trunk + reduce, pool, heads, the whole
model), through utils/profiling.timed. Weights are the Trainer's own
initialization. It runs on the card unless --device cpu.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch


def train_config(base: str = "multipath_vgg16_batched", batch: int = 8,
                 size: int = 640, rois: int = 64, freeze: int = 2):
    """The reference tool's config: `base` (multipath_vgg16_batched, whose
    fields equal multipath_vgg16_train's) at these shapes."""
    from multipathnet_tpu_torch.core.config import preset

    cfg = preset(base)
    return cfg.replace(
        data=dataclasses.replace(cfg.data, image_size=(size, size),
                                 max_proposals=1000, rois_per_image=rois),
        train=dataclasses.replace(cfg.train, batch_size=batch,
                                  freeze_backbone_stages=freeze))


def make_batch(rng, B=8, P=1000, G=16, size=640, num_classes=81):
    """The reference tool's synthetic batch (numpy); classes drawn from
    [1, num_classes - 1) as the reference draws [1, 80) for 81."""
    from multipathnet_tpu_torch.train.loop import Batch

    def bx(n):
        lim = max(size - 140, 8)
        x1 = rng.uniform(0, lim, n)
        y1 = rng.uniform(0, lim, n)
        w = rng.uniform(8, min(120, size // 2), n)
        h = rng.uniform(8, min(120, size // 2), n)
        return np.stack([x1, y1, np.minimum(x1 + w, size - 1),
                         np.minimum(y1 + h, size - 1)], -1).astype(np.float32)

    return Batch(
        images=rng.integers(0, 255, (B, size, size, 3)).astype(np.uint8),
        src_hws=np.full((B, 2), float(size), np.float32),
        proposals=bx(B * P).reshape(B, P, 4),
        prop_mask=np.ones((B, P), bool),
        gt_boxes=bx(B * G).reshape(B, G, 4),
        gt_classes=rng.integers(1, num_classes - 1, (B, G)).astype(
            np.int32),
        gt_mask=np.ones((B, G), bool),
    )


def run(cfg, *, iters: int = 10, stages: bool = False, device=None,
        seed: int = 0) -> dict:
    """-> {"first_s", "single_ms", "chained_ms", "img/s", and with stages
    each stage row's ms}, printed as the reference tool prints them."""
    from multipathnet_tpu_torch.train.loop import Trainer
    from multipathnet_tpu_torch.utils.profiling import synchronize, timed

    tr = Trainer(cfg, device=device)
    b, size = cfg.train.batch_size, cfg.data.image_size[0]
    rng = np.random.default_rng(seed)
    batch = make_batch(rng, B=b, P=cfg.data.max_proposals, size=size,
                       num_classes=cfg.model.num_classes)
    state = tr.init_state(seed)
    dev = tr.put_batch(batch)
    out = {}
    t0 = time.perf_counter()
    state, m = tr._step(state, dev)
    synchronize(m)
    out["first_s"] = time.perf_counter() - t0
    print(f"first step (kernel build + first run): {out['first_s']:.1f}s")

    t0 = time.perf_counter()
    state, m = tr._step(state, dev)
    synchronize(m)
    out["single_ms"] = 1e3 * (time.perf_counter() - t0)
    print(f"fenced single step: {out['single_ms']:.1f} ms")

    t0 = time.perf_counter()
    for _ in range(iters):
        state, m = tr._step(state, dev)
    synchronize(m)
    dt = (time.perf_counter() - t0) / iters
    out["chained_ms"], out["img/s"] = 1e3 * dt, b / dt
    print(f"chained: {dt * 1e3:.1f} ms/step = {b / dt:.1f} img/s")
    if not stages:
        return out

    model = tr.model
    params = [p for p in model.parameters() if p.requires_grad]
    gen = torch.Generator(tr.device).manual_seed(1)
    images = torch.randn((b, size, size, 3), generator=gen,
                         device=tr.device)
    rois = dev.proposals[:, :cfg.data.rois_per_image, :]
    hw = (size, size)

    def stage(name, f, *a):
        sec, _ = timed(f, *a, iters=iters)
        out[name] = 1e3 * sec
        print(f"{name:<34} {out[name]:7.1f} ms")

    def grad_of(loss):
        return torch.autograd.grad(loss, params, allow_unused=True)

    def sq(x):
        return torch.sum(x.float() ** 2) * 1e-6

    def feats_of(im):
        return model.features(im)

    with torch.no_grad():
        stage("trunk+reduce fwd", feats_of, images)
    stage("trunk fwd+bwd", lambda im: grad_of(
        sum(sq(v) for v in feats_of(im).values())), images)
    with torch.no_grad():
        feats = feats_of(images)
        stage("pool fwd", lambda f: model.pool_rois(f, rois, hw, train=True),
              feats)
    feats = {k: v.detach().requires_grad_(True) for k, v in feats.items()}
    stage("pool fwd+bwd (d/dfeats)", lambda f: torch.autograd.grad(
        sq(model.pool_rois(f, rois, hw, train=True)), list(f.values())),
        feats)
    with torch.no_grad():
        pooled = model.pool_rois(feats, rois, hw, train=True)

    def heads_loss(po):
        s, d = model.predict_rois(po, train=True, generator=gen)
        return sq(s) + sq(d)

    stage("heads fwd+bwd", lambda po: grad_of(heads_loss(po)), pooled)

    def full_loss(im, r):
        s, d = model(im, r, train=True, generator=gen)
        return sq(s) + sq(d)

    stage("full fwd+bwd", lambda im, r: grad_of(full_loss(im, r)), images,
          rois)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--stages", action="store_true",
                   help="also profile fwd / fwd+bwd per stage")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--size", type=int, default=640)
    p.add_argument("--rois", type=int, default=64)
    p.add_argument("--freeze", type=int, default=2)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    run(train_config("multipath_vgg16_batched", args.batch, args.size,
                     args.rois, args.freeze),
        iters=args.iters, stages=args.stages, device=args.device)


if __name__ == "__main__":
    main()
