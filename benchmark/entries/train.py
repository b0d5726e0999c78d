"""Training cells: `train.loop.Trainer.step` on host batches, one by one.

Set-up builds the one Trainer of the run, calls `init_state(seed)` (the
optimizer and the step's generator, seeded with seed + 1), loads the
checkpoint the benchmark drew from the seed over its parameters, resumes
at the configuration's `start_step` (the end of the warm-up, as a job
restarted from a checkpoint does, so that every step the reference
follows and every timed step runs at the full learning rate), draws the
mix's pool of host batches, and drives the first steps through the
window's own call and feed (`Trainer.step` on host arrays): the first
three on distinct batches are the ones the reference follows, the rest
warm up. The window then steps on, cycling the pool, and ends with a
synchronize: train_step_ms is its seconds over its steps. A traced run
adds a profiled slice after the window.

Correctness: the reference (benchmark/reference/train.py) repeats the
first three steps in float32 from the same checkpoint, batches and random
draws. Three numbers are compared with the configuration's `limits`:
  loss_gap    the widest relative gap of the three steps' losses;
  grad_gap    over the leaves, the widest gap between the norm of the
              program's first gradient (the optimizer's momentum after one
              step, less the weight decay of the starting parameters) and
              the reference's, over the
              reference's norm of that leaf or of the median leaf,
              whichever is larger;
  update_gap  the same of each leaf's change over the three steps.
Leaves whose reference gradient is under a thousandth of the median
leaf's (nought to rounding) are left out of the last two.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchmark import harness, traffic, weights
from benchmark.counts import multipath as counts
from benchmark.entries import replace_fields
from benchmark.reference.train import Reference
from benchmark.trace import profile, reduce_trace

FOLLOWED = 3        # steps the reference follows
WARMUP = 5          # steps before the window, the followed ones included
SLICE = 8           # steps in the profiled slice
NEGLIGIBLE = 1e-3   # of the median leaf's gradient norm


def program_config(config: dict, mix: dict):
    from multipathnet_tpu_torch.core.config import preset

    cfg = preset(config["preset"])

    cfg = cfg.replace(model=replace_fields(cfg.model, config["model"]),
                      data=replace_fields(cfg.data, config["data"]),
                      train=replace_fields(cfg.train, config["train"]))
    return cfg.replace(data=dataclasses.replace(
        cfg.data, image_size=(mix["canvas"], mix["canvas"]),
        max_proposals=mix["proposals"], max_gt_per_image=mix["max_gt"]),
        train=dataclasses.replace(cfg.train, batch_size=mix["batch"]))


def leaf_gap(got: dict, want: dict, what: str) -> float:
    """The worst leaf's | |got| - |want| | over max(|want|, median |want|),
    leaves with a negligible reference gradient left out by the caller;
    the worst two are logged."""
    norms = {k: float(torch.linalg.vector_norm(v.float()))
             for k, v in want.items()}
    med = float(np.median(list(norms.values())))
    gaps = {k: abs(float(torch.linalg.vector_norm(got[k].float())) - n)
            / max(n, med) for k, n in norms.items()}
    worst = sorted(gaps, key=gaps.get, reverse=True)[:2]
    harness.log(f"{what}: worst leaves " + ", ".join(
        f"{k} {gaps[k]:.6g} (norm {norms[k]:.6g}, median {med:.6g})"
        for k in worst))
    return gaps[worst[0]]


def moving(grads: dict) -> set:
    """Leaves whose reference gradient is not negligible."""
    norms = {k: float(torch.linalg.vector_norm(v)) for k, v in grads.items()}
    med = float(np.median(list(norms.values())))
    return {k for k, n in norms.items() if n >= NEGLIGIBLE * med}


def readings(first: dict, sd: dict, config, mix, pool, seed, device) -> dict:
    """The reference's three steps against the program's `first`
    ({"loss": [3 floats], "grad": {leaf}, "change": {leaf}})."""
    r = Reference(sd, config, mix["canvas"], weights.seed64(seed) + 1,
                  device)
    losses = [r.step(pool[0])]
    g_ref = r.first_grads()
    losses += [r.step(pool[i]) for i in range(1, FOLLOWED)]
    change = {k: r.params[k].detach() - sd[k] for k in r.trainable}
    keep = moving(g_ref)
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(first["loss"], losses)),
        "grad_gap": leaf_gap({k: first["grad"][k] for k in keep},
                             {k: g_ref[k] for k in keep}, "grad_gap"),
        "update_gap": leaf_gap({k: first["change"][k] for k in keep},
                               {k: change[k] for k in keep}, "update_gap")}


def build(cfg, config, seed, device):
    """The Trainer with the drawn checkpoint loaded, its state resumed at
    the configuration's start_step, and the checkpoint's {name: shape}."""
    from multipathnet_tpu_torch.train.loop import Trainer

    trainer = Trainer(cfg, device=device)
    state = trainer.init_state(weights.seed64(seed))
    shapes = {k: tuple(v.shape)
              for k, v in trainer.model.state_dict().items()}
    trainer.load_full_state_dict(weights.draw(shapes, config["weights"],
                                              seed, device))
    state.optimizer.count = config["start_step"]
    return trainer, state._replace(step=config["start_step"]), shapes


def first_steps(trainer, state, pool) -> tuple:
    """The followed steps through Trainer.step -> (state, {"loss",
    "grad", "change"}) of the trainable leaves."""
    named = {n: p for n, p in trainer.model.named_parameters()
             if p.requires_grad}
    start = {n: p.detach().clone() for n, p in named.items()}
    opt = state.optimizer
    wd = trainer.cfg.train.weight_decay
    losses = []
    for i in range(FOLLOWED):
        state, m = trainer.step(state, pool[i])
        losses.append(float(m["loss"]))
        if i == 0:   # a step that left no momentum gave no gradient
            grad = {n: opt.sgd.state.get(p, {}).get(
                "momentum_buffer", torch.zeros_like(p)).clone()
                - wd * start[n] for n, p in named.items()}
    change = {n: p.detach() - start[n] for n, p in named.items()}
    return state, {"loss": losses, "grad": grad, "change": change}


def run(run: harness.Run) -> harness.Outcome:
    dev = run.device
    harness.log(f"set-up: imports done at "
                f"{time.perf_counter() - run.start:.3f} s")
    cfg = program_config(run.config, run.mix)
    trainer, state, shapes = build(cfg, run.config, run.seed, dev)
    harness.log(f"set-up: trainer built at "
                f"{time.perf_counter() - run.start:.3f} s")
    pool = traffic.batches(run.mix, weights.seed64(run.seed))
    harness.log(f"set-up: traffic drawn at "
                f"{time.perf_counter() - run.start:.3f} s")
    state, first = first_steps(trainer, state, pool)
    harness.log(f"set-up: followed steps done at "
                f"{time.perf_counter() - run.start:.3f} s")
    for i in range(FOLLOWED, WARMUP):
        state, _ = trainer.step(state, pool[i % len(pool)])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - run.start
    harness.log(f"set-up {setup_s:.3f} s")
    losses = []
    i = WARMUP
    t_start = time.perf_counter()
    deadline = t_start + run.seconds
    while time.perf_counter() < deadline:
        state, m = trainer.step(state, pool[i % len(pool)])
        losses.append(m["loss"])
        i += 1
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    win_s = time.perf_counter() - t_start
    steps = i - WARMUP
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    harness.log(f"window {win_s:.3f} s, {steps} steps, "
                f"{1e3 * win_s / steps:.4f} ms a step")
    traced = None
    if run.trace:
        def step():
            nonlocal state, i
            state, _ = trainer.step(state, pool[i % len(pool)])
            i += 1
        traced = reduce_trace(profile(step, SLICE, dev))
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    del trainer, state, losses
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    layer = None
    if traced is not None:
        m = run.config["model"]
        work = counts.train(m, run.mix["canvas"], run.mix["batch"],
                            run.mix["batch"] * cfg.data.rois_per_image,
                            cfg.train.freeze_backbone_stages)
        harness.log(f"train step: {work['ops']:.6g} ops counted")
        layer = {"kind": "train", "steps": SLICE,
                 "busy_s": traced["busy_s"],
                 "window_s": traced["window_s"], "step_s": win_s / steps,
                 "work": work}
    sd = weights.draw(shapes, run.config["weights"], run.seed, dev)
    t = time.perf_counter()
    got = readings(first, sd, run.config, run.mix, pool, run.seed, dev)
    harness.log(f"check {time.perf_counter() - t:.3f} s")
    limits = run.config["limits"]
    return harness.Outcome(
        attempted=steps, failed=failed,
        end_to_end={"train_step_ms": 1e3 * win_s / steps,
                    "setup_s": setup_s},
        checks=[harness.Check(k, got[k], limits[k])
                for k in ("loss_gap", "grad_gap", "update_gap")],
        memory_peak_bytes=peak, layer=layer,
        busy_s=None if traced is None else traced["busy_s"],
        window_s=None if traced is None else traced["window_s"],
        breakdown=None if traced is None else traced["breakdown"])
