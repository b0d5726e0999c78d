"""Training entry point — port of multipathnet_tpu/cli/train.py (train.lua
analog, SURVEY.md §2.1, §3.1).

    python -m multipathnet_tpu_torch.cli.train --preset multipath_vgg16_train \
        --dataset-root /data/coco --split trainval35k
    python -m multipathnet_tpu_torch.cli.train --preset tiny --synthetic \
        --steps 60 [--device cpu]

Checkpoints + config dump + JSONL metrics land in cfg.train.checkpoint_dir
(set it with `--set train.checkpoint_dir=...`). A fresh run refuses a
directory that already holds checkpoints; `--resume` restores the latest
one exactly (parameters, momentum, count, step, the generator's state) and
then, as the reference does, restarts the data order at the start of the
epoch that step falls in, so batches already seen in that epoch are seen
again. Batches reach the device through
DetectionPipeline.epoch_on_device (pinned memory, a side CUDA stream), so
batch N+1's copy overlaps step N. The proposal network (`--proposal-net`,
ROADMAP A15) and TensorBoard export (`--tensorboard`, ROADMAP A12d) are not
ported yet and raise.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

from multipathnet_tpu_torch.cli import common


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
                   help="also export scalars to <checkpoint_dir>/tb "
                        "(not ported yet: raises)")
    p.add_argument("--proposal-net", action="store_true",
                   help="train the SharpMask-style proposal network "
                        "(not ported yet: raises)")
    args = p.parse_args(argv)
    if args.proposal_net:
        raise NotImplementedError(
            "--proposal-net waits for the port of the SharpMask proposal "
            "network (ROADMAP A15)")

    cfg = common.build_config(args)
    if args.steps:
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, total_steps=args.steps))
    if 0 < cfg.train.total_steps <= cfg.train.warmup_steps:
        # short runs inside the linear warmup train at LR ~0 and eval at
        # chance — loud note instead of a silent AP=0
        print(f"WARNING: total_steps={cfg.train.total_steps} <= "
              f"warmup_steps={cfg.train.warmup_steps}; the LR never leaves "
              f"warmup (peak {cfg.train.lr * cfg.train.total_steps / max(cfg.train.warmup_steps, 1):.2e} "
              f"of lr={cfg.train.lr}). For short runs pass "
              f"--set train.warmup_steps=0 (or a small value).")

    from multipathnet_tpu_torch.data.pipeline import DetectionPipeline
    from multipathnet_tpu_torch.eval.tester import Tester
    from multipathnet_tpu_torch.train.checkpoint import Checkpointer
    from multipathnet_tpu_torch.train.loop import Trainer
    from multipathnet_tpu_torch.utils.metrics import MetricsLogger

    loader, props = common.resolve_data(args, cfg)
    if loader.num_classes != cfg.model.num_classes:
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, num_classes=loader.num_classes))
        print(f"config: num_classes -> {loader.num_classes} (from dataset)")

    ckpt = Checkpointer(os.path.join(cfg.train.checkpoint_dir, "ckpt"))
    if not args.resume and ckpt.all_steps():
        raise SystemExit(
            f"{ckpt.directory} already holds checkpoints (steps "
            f"{ckpt.all_steps()}): pass --resume to continue them, or set "
            f"another train.checkpoint_dir")
    with open(os.path.join(cfg.train.checkpoint_dir, "config.json"), "w") as f:
        f.write(cfg.to_json())

    trainer = Trainer(cfg, device=args.device)
    print(f"dataset: {len(loader)} images, {loader.num_classes} classes; "
          f"device: {trainer.device}")
    pipe = DetectionPipeline(loader, props, cfg.data,
                             batch_size=cfg.train.batch_size,
                             seed=cfg.train.seed)
    logger = MetricsLogger(
        os.path.join(cfg.train.checkpoint_dir, "metrics.jsonl"),
        tensorboard_dir=(os.path.join(cfg.train.checkpoint_dir, "tb")
                         if args.tensorboard else None))

    state = trainer.init_state()
    if args.resume:
        restored = ckpt.restore_latest(trainer, state)
        if restored is not None:
            state = restored
            print(f"resumed from step {state.step}")
        else:
            print("no checkpoint found; starting fresh")

    def run_eval(tag):
        m = Tester(trainer.model, cfg, loader, props,
                   device=trainer.device).test()
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
                print(f"time to first step: {dt0:.1f}s")
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
        print("final:", {k: round(v, 4) for k, v in m.items()})
    logger.close()


if __name__ == "__main__":
    main()
