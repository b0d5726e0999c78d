"""Training cells on a ResNet trunk: `train.loop.Trainer.step` on host
batches, timed and checked as benchmark/entries/train.py does, with what
a ResNet trunk needs in place of VGG-16's:

- the weights: benchmark/weights_resnet.py's draw (He-normal
  convolutions, BatchNorm statistics with positive variances; train.py's
  normal draw makes a ResNet's features NaN), loaded over the Trainer's
  own, which resumes at the configuration's start_step;
- the reference: benchmark/reference/train_resnet.py (train.py's step on
  the ResNet trunk, the stem and conv2_x frozen);
- the work: benchmark/counts/resnet_train.py, with the trunk's own count
  for its roofline, and the profiled slice's device time by span.

Set-up also logs the standard deviation of each tap (c3, c4, c5) of the
first followed step and fails unless every tap is finite with its
deviation inside the configuration's `tap_std`, as the ResNet serving
entry does: under a draw that made the trunk vanish or blow up, the
comparison with the reference would say nothing.

The check is train.py's (loss_gap, grad_gap, update_gap over the first
three steps) and one more number, which holds the trunk on its own:
  trunk_gap  over the training trunk's leaves (conv3_x's and conv4_x's
             convolutions and BatchNorm scales and biases) taken as one
             vector, |g - g_ref| / |g_ref| of the first gradient (as
             grad_gap takes it): a gap of direction as well as of size,
             where grad_gap compares each leaf's norm alone against the
             larger of its own and the median leaf's.
A control that lowers the trunk's convolutions alone to fp8 passes
loss_gap on most seeds and update_gap on some; trunk_gap fails it on
every seed (PERF.md section 2), as tap_err does in serving.
"""

from __future__ import annotations

import time

import torch

from benchmark import harness, traffic, weights, weights_resnet
from benchmark.counts import resnet_train as counts
from benchmark.entries import train
from benchmark.entries.train import (first_steps, leaf_gap, moving,
                                     program_config)
from benchmark.reference.train_resnet import Reference
from benchmark.trace import profile, reduce_trace


def trunk_gap(got: dict, want: dict) -> float:
    """|got - want| / |want| over the trunk's leaves of `want` as one
    vector."""
    keys = [k for k in want if k.startswith("backbone.")]
    diff = sum(float(torch.linalg.vector_norm(got[k].float() - want[k]))
               ** 2 for k in keys)
    norm = sum(float(torch.linalg.vector_norm(want[k])) ** 2 for k in keys)
    return (diff / norm) ** 0.5


def readings(first: dict, sd: dict, config, mix, pool, seed,
             device) -> dict:
    """The float32 reference's three steps against `first` ({"loss",
    "grad", "change"} of the program, or of a substitute)."""
    r = Reference(sd, config, mix["canvas"], weights.seed64(seed) + 1,
                  device)
    losses = [r.step(pool[0])]
    g_ref = r.first_grads()
    losses += [r.step(pool[i]) for i in range(1, train.FOLLOWED)]
    change = {k: r.params[k].detach() - sd[k] for k in r.trainable}
    keep = moving(g_ref)
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(first["loss"], losses)),
        "grad_gap": leaf_gap({k: first["grad"][k] for k in keep},
                             {k: g_ref[k] for k in keep}, "grad_gap"),
        "update_gap": leaf_gap({k: first["change"][k] for k in keep},
                               {k: change[k] for k in keep}, "update_gap"),
        "trunk_gap": trunk_gap(first["grad"], g_ref)}


def build(cfg, config, seed, device):
    """train.build with the ResNet draw: the Trainer, its state resumed at
    start_step, and the checkpoint's {name: shape}."""
    from multipathnet_tpu_torch.train.loop import Trainer

    trainer = Trainer(cfg, device=device)
    state = trainer.init_state(weights.seed64(seed))
    shapes = {k: tuple(v.shape)
              for k, v in trainer.model.state_dict().items()}
    trainer.load_full_state_dict(weights_resnet.draw(
        shapes, config["weights"], seed, device))
    state.optimizer.count = config["start_step"]
    return trainer, state._replace(step=config["start_step"]), shapes


def guarded_first_steps(trainer, state, pool, band) -> tuple:
    """first_steps, the taps of the first step's forward read by a hook
    and held to `band` (module docstring)."""
    got = {}

    def hook(module, args, out):
        if got:
            return
        for lv, x in out.items():
            x = x.detach().float()
            got[lv] = (float(x.std()), bool(torch.isfinite(x).all()))

    handle = trainer.model.backbone.register_forward_hook(hook)
    try:
        state, first = first_steps(trainer, state, pool)
    finally:
        handle.remove()
    lo, hi = band
    for lv, (std, finite) in sorted(got.items()):
        harness.log(f"tap {lv}: std {std:.6g}, finite {finite}")
        if not (finite and lo <= std <= hi):
            raise RuntimeError(f"tap {lv} of the drawn trunk is not finite "
                               f"with std in [{lo}, {hi}]: std {std!r}")
    return state, first


def run(run: harness.Run) -> harness.Outcome:
    dev = run.device

    def stage(what):
        harness.log(f"set-up: {what} at "
                    f"{time.perf_counter() - run.start:.3f} s")

    stage("imports done")
    cfg = program_config(run.config, run.mix)
    trainer, state, shapes = build(cfg, run.config, run.seed, dev)
    stage("trainer built")
    pool = traffic.batches(run.mix, weights.seed64(run.seed))
    stage("traffic drawn")
    state, first = guarded_first_steps(trainer, state, pool,
                                       run.config["tap_std"])
    stage("followed steps done")
    for i in range(train.FOLLOWED, train.WARMUP):
        state, _ = trainer.step(state, pool[i % len(pool)])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - run.start
    harness.log(f"set-up {setup_s:.3f} s")
    losses = []
    i = train.WARMUP
    t_start = time.perf_counter()
    deadline = t_start + run.seconds
    while time.perf_counter() < deadline:
        state, m = trainer.step(state, pool[i % len(pool)])
        losses.append(m["loss"])
        i += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    win_s = time.perf_counter() - t_start
    steps = i - train.WARMUP
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    harness.log(f"window {win_s:.3f} s, {steps} steps, "
                f"{1e3 * win_s / steps:.4f} ms a step")
    traced = None
    if run.trace:
        def step():
            nonlocal state, i
            state, _ = trainer.step(state, pool[i % len(pool)])
            i += 1
        traced = reduce_trace(profile(step, train.SLICE, dev))
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    harness.log(f"peak memory {peak} bytes")
    del trainer, state, losses
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    layer = None
    if traced is not None:
        work = counts.train(run.config["model"], run.mix["canvas"],
                            run.mix["batch"],
                            run.mix["batch"] * cfg.data.rois_per_image,
                            cfg.train.freeze_backbone_stages)
        harness.log(f"train step: {work['ops']:.6g} ops counted, the "
                    f"trunk {work['trunk']['ops']:.6g} ops, "
                    f"{work['trunk']['bytes']:.6g} bytes")
        harness.log("device ms a step by span: " + ", ".join(
            f"{k} {1e3 * v / train.SLICE:.4f}" for k, v in sorted(
                traced["span_device_s"].items(), key=lambda kv: -kv[1])))
        layer = {"kind": "train", "steps": train.SLICE,
                 "busy_s": traced["busy_s"],
                 "window_s": traced["window_s"], "step_s": win_s / steps,
                 "work": work,
                 "span_device_s": {k: v / train.SLICE for k, v in
                                   traced["span_device_s"].items()}}
    sd = weights_resnet.draw(shapes, run.config["weights"], run.seed, dev)
    t = time.perf_counter()
    got = readings(first, sd, run.config, run.mix, pool, run.seed, dev)
    harness.log(f"check {time.perf_counter() - t:.3f} s")
    limits = run.config["limits"]
    return harness.Outcome(
        attempted=steps, failed=failed,
        end_to_end={"train_step_ms": 1e3 * win_s / steps,
                    "setup_s": setup_s},
        checks=[harness.Check(k, got[k], limits[k]) for k in
                ("loss_gap", "grad_gap", "update_gap", "trunk_gap")],
        memory_peak_bytes=peak, layer=layer,
        busy_s=None if traced is None else traced["busy_s"],
        window_s=None if traced is None else traced["window_s"],
        breakdown=None if traced is None else traced["breakdown"])
