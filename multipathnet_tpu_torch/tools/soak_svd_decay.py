"""Can real training produce a decayed-spectrum checkpoint where int8+SVD
serving tracks float accuracy? — port of tools/soak_svd_decay.py.

A run that barely trains leaves the fc kernels' random-init spectrum flat,
and truncated SVD at the headline ranks (fc6 1024, fc7 256) then loses
much of the AP. Trained VGG-16 spectra decay (Fast R-CNN §3.1 measured
-0.3 mAP at these ranks); weight decay is the mechanism that shrinks the
task-irrelevant random mass while gradients keep the task subspace, so a
soak with strong weight decay moves the checkpoint along the spectrum
axis.

    python -m multipathnet_tpu_torch.tools.soak_svd_decay \
        [--steps 2000] [--wd 0.1] [--lr 1e-3] [--snap-every 500] \
        [--size 256] [--images 16] [--eval-batch 8] [--device cuda]

It trains `multipath_vgg16_train` (canvas --size, no warmup) on a
synthetic COCO split written under --workdir (a temporary directory by
default), logs every step through MetricsLogger with TensorBoard export
(<workdir>/tb), and per snapshot reports the fc6/fc7 relative Frobenius
truncation error at the headline ranks and the float / int8 / SVD /
int8+SVD COCO evaluation of the same parameters, each through a Tester.
The factorization runs once per snapshot, on the parameters' device
(ops/lowrank.factorize_kernel_torch on the card), and feeds both SVD
configs; the int8 configs quantize at load, as Detector does. It runs on
the card unless --device cpu.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time
import warnings

RANKS = (1024, 256)          # the headline fc6 / fc7 ranks


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def soak_config(size: int = 256, lr: float = 1e-3, wd: float = 0.1,
                steps: int = 2000):
    """The reference tool's config: multipath_vgg16_train at a size^2
    canvas, lr and weight decay as given, no warmup."""
    from multipathnet_tpu_torch.core.config import preset

    cfg = preset("multipath_vgg16_train")
    return cfg.replace(
        data=dataclasses.replace(cfg.data, image_size=(size, size)),
        train=dataclasses.replace(cfg.train, lr=lr, weight_decay=wd,
                                  warmup_steps=0, total_steps=steps))


def serving_configs(cfg, ranks=RANKS) -> dict:
    """name -> the four serving configs of `cfg`'s model."""
    mk = lambda **kw: cfg.replace(model=dataclasses.replace(cfg.model, **kw))
    r6, r7 = ranks
    return {"float": mk(),
            "int8": mk(head_quant="int8"),
            "svd": mk(fc6_rank=r6, fc7_rank=r7),
            "int8+svd": mk(head_quant="int8", fc6_rank=r6, fc7_rank=r7)}


def snapshot_eval(step, trainer, configs, models, loader, props, ranks,
                  eval_batch: int) -> dict:
    """The four-way evaluation of the trainer's parameters: one
    factorization (on their device) whose report gives the truncation
    errors and whose tree feeds both SVD configs."""
    from multipathnet_tpu_torch.eval.tester import Tester
    from multipathnet_tpu_torch.models import convert
    from multipathnet_tpu_torch.ops import lowrank

    tree = convert.flax_from_state_dict(trainer.model.state_dict(),
                                        host=False)
    report: dict = {}
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # a flat spectrum warns
        factored = lowrank.factorize_head_params(tree, *ranks, report=report)
    f6 = [v for k, v in report.items() if "fc6" in k]
    f7 = [v for k, v in report.items() if "fc7" in k]
    row = {"step": step, "factorize_s": time.perf_counter() - t0,
           "trunc_fc6": (min(f6), max(f6)), "trunc_fc7": (min(f7), max(f7))}
    log(f"[step {step}] rel trunc err: fc6 {min(f6):.3f}-{max(f6):.3f}  "
        f"fc7 {min(f7):.3f}-{max(f7):.3f} (factorize "
        f"{row['factorize_s']:.1f}s)")
    trees = {"float": tree, "int8": tree, "svd": factored,
             "int8+svd": factored}
    for name, ccfg in configs.items():
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            ap = Tester(models[name], ccfg, loader, props, params=trees[name],
                        device=trainer.device, batch_size=eval_batch).test()
        row[name] = ap
        log(f"[step {step}] {name:9s} AP {ap['AP']:.4f} "
            f"AP50 {ap['AP50']:.4f} AP75 {ap['AP75']:.4f} "
            f"({time.perf_counter() - t0:.1f}s)")
    row["gap"] = row["float"]["AP"] - row["int8+svd"]["AP"]
    log(f"[step {step}] float-vs-int8+svd AP gap: {row['gap']:+.4f}")
    return row


def soak(cfg, *, steps: int, snap_every: int, images: int = 16,
         eval_batch: int = 8, workdir: str, device=None, ranks=RANKS,
         seed: int = 7) -> dict:
    """Train cfg for `steps` on a synthetic split of `images` images under
    workdir, evaluating every snap_every steps and at the end.
    -> {"snapshots": [snapshot_eval rows], "ms_per_step": steady ms a
    step (steps after the first, evaluations excluded), "losses": [...],
    "tensorboard": the event file, "metrics": the JSONL file, "split":
    synthetic.generate's paths, "trainer": the Trainer, holding the last
    parameters, "state": its last TrainState}."""
    from multipathnet_tpu_torch.data import synthetic
    from multipathnet_tpu_torch.data.coco import CocoLoader
    from multipathnet_tpu_torch.data.pipeline import DetectionPipeline
    from multipathnet_tpu_torch.data.proposals import ProposalStore
    from multipathnet_tpu_torch.models.multipath import build_model
    from multipathnet_tpu_torch.train.loop import Trainer
    from multipathnet_tpu_torch.utils.metrics import MetricsLogger
    from multipathnet_tpu_torch.utils.profiling import synchronize

    s = cfg.data.image_size[0]
    fx = synthetic.generate(os.path.join(workdir, "data"), num_images=images,
                            image_size=s,
                            num_classes=cfg.model.num_classes - 1,
                            proposals_per_image=64, seed=seed)
    loader = CocoLoader(fx["annotations"], fx["images"])
    props = ProposalStore.load(fx["proposals"])
    pipe = DetectionPipeline(loader, props, cfg.data,
                             batch_size=cfg.train.batch_size,
                             seed=cfg.train.seed)
    trainer = Trainer(cfg, device=device)
    state = trainer.init_state()
    log(f"device={trainer.device} wd={cfg.train.weight_decay} "
        f"lr={cfg.train.lr} steps={steps} size={s}")
    configs = serving_configs(cfg, ranks)
    models = {name: build_model(c.model, device=trainer.device)
              for name, c in configs.items()}
    tb = os.path.join(workdir, "tb")
    logger = MetricsLogger(os.path.join(workdir, "metrics.jsonl"),
                           echo=False, tensorboard_dir=tb)

    rows, losses, train_s, timed_steps = [], [], 0.0, 0
    step, ep, t0 = 0, 0, time.perf_counter()
    while step < steps:
        for batch in pipe.epoch_on_device(ep, trainer.stream_batch):
            t_step = time.perf_counter()
            state, m = trainer.step(state, batch)
            step += 1
            logger.log(step, lr=trainer.lr_schedule(step - 1), **m)
            synchronize(m)
            if step > 1:
                train_s += time.perf_counter() - t_step
                timed_steps += 1
            losses.append(float(m["loss"]))
            if step == 1:
                log(f"step 1 done ({time.perf_counter() - t0:.1f}s)")
            if step % 100 == 0:
                log(f"step {step}: loss {losses[-1]:.4f} "
                    f"({1e3 * train_s / max(timed_steps, 1):.0f} ms/step)")
            if step % snap_every == 0 or step == steps:
                rows.append(snapshot_eval(step, trainer, configs, models,
                                          loader, props, ranks, eval_batch))
            if step >= steps:
                break
        ep += 1
    logger.close()
    log("done")
    return {"snapshots": rows, "losses": losses,
            "ms_per_step": 1e3 * train_s / max(timed_steps, 1),
            "tensorboard": os.path.join(tb, os.listdir(tb)[0]),
            "metrics": os.path.join(workdir, "metrics.jsonl"),
            "split": fx, "trainer": trainer, "state": state}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--wd", type=float, default=0.1)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--snap-every", type=int, default=500)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--images", type=int, default=16)
    p.add_argument("--eval-batch", type=int, default=8)
    p.add_argument("--workdir", default="",
                   help="where the split, metrics and events go (default: "
                        "a new temporary directory)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    cfg = soak_config(args.size, args.lr, args.wd, args.steps)
    soak(cfg, steps=args.steps, snap_every=args.snap_every,
         images=args.images, eval_batch=args.eval_batch,
         workdir=args.workdir or tempfile.mkdtemp(prefix="mpnet_soak_"),
         device=args.device)


if __name__ == "__main__":
    main()
