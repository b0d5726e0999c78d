"""Proposal quality at bench scale (640^2, top-400) — port of
tools/prop_quality_scale.py.

It trains the SharpMask proposal network (`sharpmask_multipath_e2e`, batch
4, no warmup) at the production canvas on a multi-object, aspect-diverse
synthetic split and measures four quality numbers at the DeepMask
operating point (top-400), stage 1 against the cascade: the median best
IoU over the proposals, the share of proposals at IoU >= 0.5, the oracle
(the mean best proposal IoU per GT object) and GT recall at IoU 0.5.

    python -m multipathnet_tpu_torch.tools.prop_quality_scale \
        [--epochs 60] [--size 640] [--images 16] [--max-objects 8] \
        [--top-k 400] [--lr 5e-3] [--quality-every 20] [--device cuda]

The split goes under --workdir (a temporary directory by default). It
runs on the card unless --device cpu.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time

import numpy as np
import torch


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def quality_config(size: int = 640, lr: float = 5e-3):
    """The reference tool's config: sharpmask_multipath_e2e at a size^2
    canvas, lr as given, no warmup, batch 4."""
    from multipathnet_tpu_torch.core.config import preset

    cfg = preset("sharpmask_multipath_e2e")
    return cfg.replace(
        data=dataclasses.replace(cfg.data, image_size=(size, size)),
        train=dataclasses.replace(cfg.train, lr=lr, warmup_steps=0,
                                  batch_size=4))


@torch.no_grad()
def quality(model, images, boxes, top_k: int, refine: bool):
    """(median best IoU over the proposals, share at IoU >= 0.5, oracle,
    GT recall at 0.5) of generate_proposals on each image alone."""
    from multipathnet_tpu_torch.models.sharpmask import generate_proposals
    from multipathnet_tpu_torch.ops.boxes import iou_matrix

    ious, gt_best = [], []
    for x, gt in zip(images, boxes):
        out = generate_proposals(model, x, top_k=top_k, with_masks=False,
                                 refine=refine)
        iou = iou_matrix(out["boxes"][0], gt).cpu().numpy()
        ious.append(iou.max(1))
        gt_best.append(iou.max(0))
    ious, gt_best = np.concatenate(ious), np.concatenate(gt_best)
    return (float(np.median(ious)), float((ious >= 0.5).mean()),
            float(gt_best.mean()), float((gt_best >= 0.5).mean()))


def run(cfg, *, epochs: int, images: int = 16, max_objects: int = 8,
        top_k: int = 400, quality_every: int = 20, workdir: str,
        device=None, seed: int = 13) -> list[dict]:
    """Train for `epochs` and measure the quality every quality_every
    epochs and after the last. -> one row a measurement: {"epoch",
    "step", "loss", "s" (seconds since the first step), "stage1" and
    "cascade" (the four numbers)}."""
    from multipathnet_tpu_torch.data import synthetic
    from multipathnet_tpu_torch.data.coco import CocoLoader
    from multipathnet_tpu_torch.data.pipeline import DetectionPipeline
    from multipathnet_tpu_torch.data.proposals import ProposalStore
    from multipathnet_tpu_torch.data.transforms import normalize
    from multipathnet_tpu_torch.train.proposal import ProposalTrainer

    s = cfg.data.image_size[0]
    fx = synthetic.generate(os.path.join(workdir, "data"), num_images=images,
                            image_size=s, num_classes=8,
                            max_objects=max_objects, proposals_per_image=32,
                            seed=seed)
    loader = CocoLoader(fx["annotations"], fx["images"])
    props = ProposalStore.load(fx["proposals"])
    pipe = DetectionPipeline(loader, props, cfg.data,
                             batch_size=cfg.train.batch_size, seed=0,
                             with_masks=True, mask_size=28)
    trainer = ProposalTrainer(cfg, device=device)
    state = trainer.init_state()
    dev = trainer.device
    log(f"device={dev} size={s} top_k={top_k} epochs={epochs}")
    imgs = [normalize(torch.from_numpy(loader.load_image(i).astype(
        np.float32)).to(dev))[None] for i in range(len(loader))]
    gts = [torch.as_tensor(loader.annotations(i)["boxes"],
                           dtype=torch.float32, device=dev)
           for i in range(len(loader))]
    log(f"dataset: {len(loader)} images, "
        f"{sum(len(g) for g in gts)} GT objects")

    rows, step, t0 = [], 0, time.perf_counter()
    for ep in range(epochs):
        for batch in pipe.epoch_on_device(ep, trainer.stream_batch):
            state, m = trainer.step(state, batch)
            step += 1
        if (ep + 1) % quality_every == 0 or ep + 1 == epochs:
            row = {"epoch": ep + 1, "step": step, "loss": float(m["loss"]),
                   "s": time.perf_counter() - t0,
                   "stage1": quality(trainer.model, imgs, gts, top_k, False),
                   "cascade": quality(trainer.model, imgs, gts, top_k, True)}
            (med1, f1, o1, r1), (med2, f2, o2, r2) = (row["stage1"],
                                                      row["cascade"])
            log(f"[ep {ep + 1} step {step} loss {row['loss']:.3f} "
                f"{row['s']:.0f}s] stage1 med={med1:.3f} f50={f1:.3f} "
                f"oracle={o1:.3f} rec={r1:.3f} | cascade med={med2:.3f} "
                f"f50={f2:.3f} oracle={o2:.3f} rec={r2:.3f}")
            rows.append(row)
    log("done")
    return rows


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--size", type=int, default=640)
    p.add_argument("--images", type=int, default=16)
    p.add_argument("--max-objects", type=int, default=8)
    p.add_argument("--top-k", type=int, default=400)
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--quality-every", type=int, default=20)
    p.add_argument("--workdir", default="",
                   help="where the split goes (default: a new temporary "
                        "directory)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    run(quality_config(args.size, args.lr), epochs=args.epochs,
        images=args.images, max_objects=args.max_objects, top_k=args.top_k,
        quality_every=args.quality_every,
        workdir=args.workdir or tempfile.mkdtemp(prefix="mpnet_pq_"),
        device=args.device)


if __name__ == "__main__":
    main()
