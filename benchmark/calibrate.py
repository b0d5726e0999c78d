"""Readings that the correctness limits of a cell are set from.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds 7 8 9] [--faults no_momentum ...]

In one process: for each of --seeds, a short run of the cell through the
harness (harness.run_cell, SECONDS of window, a whole pass over the mix's
pool), printing the numbers it compares (one JSON line a seed,
"program"). For each of --control-seeds the same numbers for the control:
the reference computed in the precision below the configuration's (fp8
trunk and pooled maps, int4 head; benchmark/reference/multipath.Precision;
in training fp8 forward operands) put in the program's place on the same
kept batches or steps ("control"); and for a training cell the reference
with half of each batch left out of the loss ("half_batch"), then, for
each of --faults, a short run with that fault planted in the program's
optimizer (FAULTS). The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness, traffic, weights  # noqa: E402
from benchmark.entries import serve, train  # noqa: E402
from benchmark.reference import multipath as ref  # noqa: E402
from benchmark.reference.train import Reference  # noqa: E402

SECONDS = {"serve": 3.0, "train": 1.0}


def _set(opt, **values):
    for group in opt.sgd.param_groups:
        group.update(values)


# faults planted in the program's optimizer once the run has built it
FAULTS = {
    "no_weight_decay": lambda opt: _set(opt, weight_decay=0.0),
    "no_momentum": lambda opt: _set(opt, momentum=0.0),
    "schedule_one_step_late": lambda opt: setattr(opt, "count",
                                                  opt.count + 1),
    "schedule_restarted": lambda opt: setattr(opt, "count", 0),
}


def program_readings(cell: str, seed: int, device, fault=None,
                     root: str = ROOT) -> dict:
    """The numbers a short run of `cell` (in the checkout at `root`)
    compares, with `fault` (a key of FAULTS) planted in a training cell's
    optimizer."""
    real = train.build

    def build(*args, **kwargs):
        trainer, state, shapes = real(*args, **kwargs)
        FAULTS[fault](state.optimizer)
        return trainer, state, shapes

    _, _, config, _ = harness.load_cell(root, cell)
    if fault is not None:
        train.build = build
    try:
        _, out = harness.run_cell(root, cell, seed,
                                  SECONDS[config["entry"]], False, device,
                                  time.perf_counter())
    finally:
        train.build = real
    return {c.name: c.value for c in out.checks}


def control_readings(cfg, config, mix, seed, device) -> dict:
    sd = weights.draw(serve.checkpoint_shapes(cfg), config["weights"], seed,
                      device)
    pool = traffic.batches(mix, weights.seed64(seed))
    low = ref.Precision(fp8=True, head_bits=4)
    prob_err = box_err = 0.0
    for i in sorted(serve.kept_batches(mix, seed)):
        pr, br = serve.reference_readings(sd, config, mix, pool[i], device)
        pc, bc = serve.reference_readings(sd, config, mix, pool[i], device,
                                          low)
        pe, be = serve.gaps(pc, bc, pr, br)
        prob_err, box_err = max(prob_err, pe), max(box_err, be)
    return {"prob_err": prob_err, "box_err": box_err}


def train_substitute(cfg, config, mix, seed, device, prec=None,
                     keep_images=None) -> dict:
    """The reference put in the program's place: in lower precision
    (`prec`), or with a fault (`keep_images`: the loss over those images
    alone)."""
    shapes = serve.checkpoint_shapes(cfg)
    sd = weights.draw(shapes, config["weights"], seed, device)
    pool = traffic.batches(mix, weights.seed64(seed))
    kw = {} if prec is None else {"prec": prec}
    r = Reference(sd, config, mix["canvas"], weights.seed64(seed) + 1,
                  device, **kw)
    losses = [r.step(pool[0], keep_images)]
    grads = r.first_grads()
    losses += [r.step(pool[i], keep_images)
               for i in range(1, train.FOLLOWED)]
    first = {"loss": losses, "grad": grads,
             "change": {k: r.params[k].detach() - sd[k] for k in r.trainable}}
    del r
    return train.readings(first, sd, config, mix, pool, seed, device)


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--faults", nargs="*", default=[], choices=sorted(FAULTS))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        harness.log("error: no CUDA device")
        return 2
    dev = torch.device("cuda", 0)
    harness.log(f"card: {harness.power_limit()}")
    _, cell, config, mix = harness.load_cell(ROOT, args.workload)
    is_train = config["entry"] == "train"
    cfg = (train if is_train else serve).program_config(config, mix)

    def out(seed, side, got):
        print(json.dumps({"cell": cell["name"], "seed": seed, "side": side,
                          **got}), flush=True)

    for seed in args.seeds:
        out(seed, "program", program_readings(cell["name"], seed, dev))
    for seed in args.control_seeds:
        if is_train:
            out(seed, "control", train_substitute(
                cfg, config, mix, seed, dev, ref.Precision(True, 0)))
            out(seed, "half_batch", train_substitute(
                cfg, config, mix, seed, dev,
                keep_images=slice(0, mix["batch"] // 2)))
            for fault in args.faults:
                out(seed, fault, program_readings(cell["name"], seed, dev,
                                                  fault))
        else:
            out(seed, "control", control_readings(cfg, config, mix, seed,
                                                  dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
