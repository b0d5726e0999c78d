"""Training entry point — port of multipathnet_tpu/cli/train.py (train.lua
analog, SURVEY.md §2.1, §3.1).

    python -m multipathnet_tpu_torch.cli.train --preset multipath_vgg16_train \
        --dataset-root /data/coco --split trainval35k
    python -m multipathnet_tpu_torch.cli.train --preset tiny --synthetic \
        --steps 60 [--device cpu]

`--proposal-net` trains the SharpMask proposal network instead
(train/proposal.py); its checkpoints feed `cli.export_proposals
--proposal-checkpoint-dir` and `cli.demo --proposal-source sharpmask`, and
its final eval reports proposal recall@IoU0.5 instead of detection AP.

Checkpoints + config dump + JSONL metrics land in cfg.train.checkpoint_dir
(set it with `--set train.checkpoint_dir=...`). A fresh run refuses a
directory that already holds checkpoints; `--resume` restores the latest
one exactly (parameters, momentum, count, step, the generator's state) and
then, as the reference does, restarts the data order at the start of the
epoch that step falls in, so batches already seen in that epoch are seen
again. Batches reach the device through
DetectionPipeline.epoch_on_device (pinned memory, a side CUDA stream), so
batch N+1's copy overlaps step N. `--tensorboard` also writes every logged
scalar to <checkpoint_dir>/tb as a TensorBoard event file
(utils/tbevents.py; `tensorboard --logdir <checkpoint_dir>/tb`).

On several cards (or CPU processes with --device cpu), under torchrun:

    torchrun --nproc_per_node=N -m multipathnet_tpu_torch.cli.train \
        --preset multipath_vgg16_train --dataset-root /data/coco ...

the run trains over the reference's data mesh (the widest width up to N
that divides the batch; train/loop.py): each rank decodes and steps its
rows of every batch, the gradients are summed across ranks, and only the
first rank writes checkpoints, metrics and prints.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

from multipathnet_tpu_torch.cli import common


def _proposal_recall(trainer, loader, cfg, top_k: int = 64,
                     max_images: int = 64) -> dict:
    """The --proposal-net eval: recall@top_k at IoU 0.5 and the mean best
    IoU over non-crowd GT. Each image is resized onto the training canvas
    first (the anchors are calibrated to cfg.data.image_size) and its
    proposals mapped back to image coordinates."""
    import numpy as np
    import torch

    from multipathnet_tpu_torch.core.padding import pad_axis_to
    from multipathnet_tpu_torch.data.transforms import batch_resize_to_canvas
    from multipathnet_tpu_torch.models.sharpmask import generate_proposals
    from multipathnet_tpu_torch.ops.boxes import iou_matrix

    dev = trainer.device
    sizes = [loader.image_size(i) for i in range(len(loader))]
    hmax, wmax = (max(s[d] for s in sizes) for d in (0, 1))
    hits, total, best = 0, 0, []
    for i in range(min(len(loader), max_images)):
        img = loader.load_image(i)
        h, w = img.shape[:2]
        pad = pad_axis_to(pad_axis_to(img, hmax, 0), wmax, 1)
        canvas, scale = batch_resize_to_canvas(
            torch.as_tensor(np.array(pad), device=dev)[None],
            cfg.data.image_size,
            torch.tensor([[h, w]], dtype=torch.float32, device=dev))
        out = generate_proposals(trainer.model, canvas, top_k=top_k,
                                 with_masks=False)
        boxes = out["boxes"][0] / scale[0]
        ann = loader.annotations(i)
        gt = ann["boxes"][~ann["iscrowd"]]  # crowds are not recall targets
        if len(gt) == 0:
            continue
        iou = iou_matrix(boxes, torch.as_tensor(gt, dtype=torch.float32,
                                                device=dev))
        m = iou.amax(0).cpu().numpy()
        hits += int((m >= 0.5).sum())
        total += len(gt)
        best.extend(m.tolist())
    return {"proposal_recall@0.5": hits / max(total, 1),
            "mean_best_iou": float(np.mean(best)) if best else 0.0,
            "top_k": float(top_k)}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    common.add_config_args(p)
    p.add_argument("--steps", type=int, default=0,
                   help="override cfg.train.total_steps")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--eval-every", type=int, default=0,
                   help="run the tester every N steps (0 = only at end)")
    p.add_argument("--no-final-eval", action="store_true")
    p.add_argument("--tensorboard", action="store_true",
                   help="also export scalars to <checkpoint_dir>/tb")
    p.add_argument("--proposal-net", action="store_true",
                   help="train the SharpMask-style proposal network "
                        "(checkpoints feed export_proposals/demo)")
    args = p.parse_args(argv)

    cfg = common.build_config(args)
    if args.steps:
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, total_steps=args.steps))
    from multipathnet_tpu_torch.data.pipeline import DetectionPipeline
    from multipathnet_tpu_torch.eval.tester import Tester
    from multipathnet_tpu_torch.train.checkpoint import Checkpointer
    from multipathnet_tpu_torch.train.loop import Trainer
    from multipathnet_tpu_torch.utils.metrics import MetricsLogger

    launched, mesh = common.launched_mesh(args.device, cfg.train.batch_size)
    if launched and mesh is None:
        return  # a rank past the mesh's width
    first = common.is_first(mesh)
    say = print if first else (lambda *a, **k: None)
    if 0 < cfg.train.total_steps <= cfg.train.warmup_steps:
        # short runs inside the linear warmup train at LR ~0 and eval at
        # chance — loud note instead of a silent AP=0
        say(f"WARNING: total_steps={cfg.train.total_steps} <= "
            f"warmup_steps={cfg.train.warmup_steps}; the LR never leaves "
            f"warmup (peak {cfg.train.lr * cfg.train.total_steps / max(cfg.train.warmup_steps, 1):.2e} "
            f"of lr={cfg.train.lr}). For short runs pass "
            f"--set train.warmup_steps=0 (or a small value).")
    loader, props = common.resolve_data(args, cfg, mesh)
    if loader.num_classes != cfg.model.num_classes:
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, num_classes=loader.num_classes))
        say(f"config: num_classes -> {loader.num_classes} (from dataset)")

    ckpt = Checkpointer(os.path.join(cfg.train.checkpoint_dir, "ckpt"))
    if not args.resume and ckpt.all_steps():
        raise SystemExit(
            f"{ckpt.directory} already holds checkpoints (steps "
            f"{ckpt.all_steps()}): pass --resume to continue them, or set "
            f"another train.checkpoint_dir")
    if first:
        with open(os.path.join(cfg.train.checkpoint_dir, "config.json"),
                  "w") as f:
            f.write(cfg.to_json())

    if args.proposal_net:
        from multipathnet_tpu_torch.train.proposal import ProposalTrainer

        trainer = ProposalTrainer(cfg, device=args.device, mesh=mesh)
    else:
        trainer = Trainer(cfg, device=args.device, mesh=mesh)
    width = "" if mesh is None else f" x {mesh.n_data} data ranks"
    say(f"dataset: {len(loader)} images, {loader.num_classes} classes; "
        f"device: {trainer.device}{width}")
    pipe = DetectionPipeline(
        loader, props, cfg.data, batch_size=cfg.train.batch_size,
        seed=cfg.train.seed, with_masks=args.proposal_net,
        shard=(0, 1) if mesh is None else (mesh.data_rank, mesh.n_data))
    logger = MetricsLogger(
        os.path.join(cfg.train.checkpoint_dir, "metrics.jsonl"),
        tensorboard_dir=(os.path.join(cfg.train.checkpoint_dir, "tb")
                         if args.tensorboard else None)) if first \
        else MetricsLogger(echo=False)

    state = trainer.init_state()
    if args.resume:
        restored = ckpt.restore_latest(trainer, state)
        if restored is not None:
            state = restored
            say(f"resumed from step {state.step}")
        else:
            say("no checkpoint found; starting fresh")

    def run_eval(tag):
        if args.proposal_net:
            m = _proposal_recall(trainer, loader, cfg)
        else:
            m = Tester(trainer.model, cfg, loader, props,
                       device=trainer.device, mesh=mesh).test()
        logger.log(state.step, tag=tag, **m)
        return m

    step = state.step
    epoch = step // max(len(pipe), 1)
    t_last, s_last = time.time(), step
    t_start, first_step_logged = time.time(), False
    imgs_per_step = cfg.train.batch_size
    while step < cfg.train.total_steps:
        # device prefetch: batch N+1 is copied while step N computes
        for batch in pipe.epoch_on_device(epoch, trainer.stream_batch):
            state, metrics = trainer.step(state, batch)
            step += 1
            if not first_step_logged:
                dt0 = time.time() - t_start
                logger.log(step, time_to_first_step=dt0)
                say(f"time to first step: {dt0:.1f}s")
                first_step_logged = True
            if step % cfg.train.log_every == 0:
                dt = time.time() - t_last
                ips = (step - s_last) * imgs_per_step / max(dt, 1e-9)
                logger.log(step, lr=trainer.lr_schedule(step),
                           imgs_per_sec=ips, **metrics)
                t_last, s_last = time.time(), step
            if step % cfg.train.checkpoint_every == 0:
                ckpt.save(trainer, state)
            if args.eval_every and step % args.eval_every == 0:
                run_eval("interim")
            if step >= cfg.train.total_steps:
                break
        epoch += 1

    ckpt.save(trainer, state)
    ckpt.wait()
    if not args.no_final_eval:
        m = run_eval("final")
        say("final:", {k: round(v, 4) for k, v in m.items()})
    logger.close()


if __name__ == "__main__":
    main()
