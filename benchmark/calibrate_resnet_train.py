"""Readings that the correctness limits of a ResNet training cell are set
from (benchmark/calibrate.py for a cell whose entry is train_resnet).

    python3 benchmark/calibrate_resnet_train.py --workload <cell> \
        --seeds 1 2 ... [--control-seeds 7 8 9] [--controls fp8 ...] \
        [--faults no_momentum ...]

In one process: for each of --seeds, a short run of the cell through the
harness (calibrate.SECONDS of window), printing the numbers it compares
(one JSON line a seed, "program"). For each of --control-seeds: each of
--controls, the reference (benchmark/reference/train_resnet.py) in a
lower precision put in the program's place on the same steps (side
"control:<name>"):
  fp8        every convolution's and the head's GEMMs' forward operands in
             fp8 (e4m3, one scale a tensor);
  fp8_trunk  the trunk's convolutions alone in fp8;
then the reference with half of each batch left out of the loss
("half_batch"), and each of --faults, a short run with that fault
planted in the program's optimizer (calibrate.FAULTS). The benchmark's
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness, traffic, weights, weights_resnet  # noqa: E402
from benchmark.calibrate import FAULTS, SECONDS  # noqa: E402
from benchmark.entries import serve, train_resnet  # noqa: E402
from benchmark.reference.multipath import Precision  # noqa: E402

CONTROLS = {"fp8": {"prec": Precision(fp8=True, head_bits=0)},
            "fp8_trunk": {"trunk_fp8": True}}


def program_readings(cell: str, seed: int, device, fault=None,
                     root: str = ROOT) -> dict:
    """The numbers a short run of `cell` (in the checkout at `root`)
    compares, with `fault` (a key of FAULTS) planted in the program's
    optimizer."""
    real = train_resnet.build

    def build(*args, **kwargs):
        trainer, state, shapes = real(*args, **kwargs)
        FAULTS[fault](state.optimizer)
        return trainer, state, shapes

    if fault is not None:
        train_resnet.build = build
    try:
        _, out = harness.run_cell(root, cell, seed, SECONDS["train"], False,
                                  device, time.perf_counter())
    finally:
        train_resnet.build = real
    return {c.name: c.value for c in out.checks}


def substitute(cfg, config, mix, seed, device, keep_images=None,
               **reference) -> dict:
    """The reference put in the program's place: with the Reference
    arguments `reference` (a control's precision), or with a fault
    (`keep_images`: the loss over those images alone)."""
    sd = weights_resnet.draw(serve.checkpoint_shapes(cfg), config["weights"],
                             seed, device)
    pool = traffic.batches(mix, weights.seed64(seed))
    r = train_resnet.Reference(sd, config, mix["canvas"],
                               weights.seed64(seed) + 1, device, **reference)
    losses = [r.step(pool[0], keep_images)]
    grads = r.first_grads()
    losses += [r.step(pool[i], keep_images)
               for i in range(1, train_resnet.train.FOLLOWED)]
    first = {"loss": losses, "grad": grads,
             "change": {k: r.params[k].detach() - sd[k] for k in r.trainable}}
    del r
    return train_resnet.readings(first, sd, config, mix, pool, seed, device)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--controls", nargs="*", default=sorted(CONTROLS),
                   choices=sorted(CONTROLS))
    p.add_argument("--faults", nargs="*", default=[], choices=sorted(FAULTS))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        harness.log("error: no CUDA device")
        return 2
    dev = torch.device("cuda", 0)
    harness.log(f"card: {harness.power_limit()}")
    _, cell, config, mix = harness.load_cell(ROOT, args.workload)
    if config["entry"] != "train_resnet":
        harness.log(f"error: {cell['name']} is not a train_resnet cell")
        return 2
    cfg = train_resnet.program_config(config, mix)

    def out(seed, side, got):
        print(json.dumps({"cell": cell["name"], "seed": seed, "side": side,
                          **got}), flush=True)

    for seed in args.seeds:
        out(seed, "program", program_readings(cell["name"], seed, dev))
    for seed in args.control_seeds:
        for name in args.controls:
            out(seed, f"control:{name}", substitute(
                cfg, config, mix, seed, dev, **CONTROLS[name]))
        out(seed, "half_batch", substitute(
            cfg, config, mix, seed, dev,
            keep_images=slice(0, mix["batch"] // 2)))
        for fault in args.faults:
            out(seed, fault, program_readings(cell["name"], seed, dev,
                                              fault))
    return 0


if __name__ == "__main__":
    sys.exit(main())
