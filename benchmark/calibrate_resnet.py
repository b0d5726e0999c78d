"""Readings that the correctness limits of a ResNet serving cell are set
from (benchmark/calibrate.py for a cell whose entry is serve_resnet).

    python3 benchmark/calibrate_resnet.py --workload <cell> \
        --seeds 1 2 ... [--control-seeds 7 8 9] [--controls fp8_trunk]

In one process: for each of --seeds, a short run of the cell through the
harness (SECONDS of window, a whole pass over the mix's pool), printing
the numbers it compares (one JSON line a seed, "program"); for each of
--control-seeds and each of --controls the same numbers for a control,
the reference (benchmark/reference/multipath_resnet.py) computed in a
lower precision and put in the program's place on the same kept batches
(side "control:<name>"):
  fp8_int4   its trunk, reduce and pooled maps in fp8 and its head in int4;
  fp8_trunk  the trunk, reduce and pooled maps in fp8, the head in int8 as
             configured: only the trunk's side is lowered.
The benchmark's runs never run this.
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

from benchmark import harness, traffic, weights  # noqa: E402
from benchmark.entries import serve, serve_resnet  # noqa: E402

SECONDS = 3.0
CONTROLS = {"fp8_int4": serve_resnet.ref.base.Precision(fp8=True, head_bits=4),
            "fp8_trunk": serve_resnet.ref.base.Precision(fp8=True)}


def program_readings(cell: str, seed: int, device, root: str = ROOT) -> dict:
    """The numbers a short run of `cell` (in the checkout at `root`)
    compares."""
    _, out = harness.run_cell(root, cell, seed, SECONDS, False, device,
                              time.perf_counter())
    return {c.name: c.value for c in out.checks}


def control_readings(cfg, config, mix, seed, device,
                     control=CONTROLS["fp8_int4"]) -> dict:
    sd = serve_resnet.checkpoint(cfg, config, seed, device)
    pool = traffic.batches(mix, weights.seed64(seed))
    prob_err = box_err = tap_err = 0.0
    serve_resnet.ref.base.exact_float32()
    for i in sorted(serve.kept_batches(mix, seed)):
        images, hws = (torch.as_tensor(x, device=device)
                       for x in pool[i][:2])
        x, _ = serve_resnet.ref.base.canvases(images, hws, mix["canvas"])
        model = config["model"]
        low = serve_resnet.ref.trunk(sd, model["backbone"], x,
                                     model["skip_levels"], control)
        tap_err = max(tap_err, serve_resnet.tap_gap(sd, config, x, low))
        del low
        pr, br = serve_resnet.reference_readings(sd, config, mix, pool[i],
                                                 device)
        pc, bc = serve_resnet.reference_readings(sd, config, mix, pool[i],
                                                 device, control)
        pe, be = serve.gaps(pc, bc, pr, br)
        prob_err, box_err = max(prob_err, pe), max(box_err, be)
    return {"prob_err": prob_err, "box_err": box_err, "tap_err": tap_err}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--controls", nargs="*", default=["fp8_int4"],
                   choices=sorted(CONTROLS))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        harness.log("error: no CUDA device")
        return 2
    dev = torch.device("cuda", 0)
    harness.log(f"card: {harness.power_limit()}")
    _, cell, config, mix = harness.load_cell(ROOT, args.workload)
    if config["entry"] != "serve_resnet":
        harness.log(f"error: {cell['name']} is not a serve_resnet cell")
        return 2
    cfg = serve.program_config(config, mix)

    def out(seed, side, got):
        print(json.dumps({"cell": cell["name"], "seed": seed, "side": side,
                          **got}), flush=True)

    for seed in args.seeds:
        out(seed, "program", program_readings(cell["name"], seed, dev))
    for seed in args.control_seeds:
        for name in args.controls:
            out(seed, f"control:{name}",
                control_readings(cfg, config, mix, seed, dev,
                                 CONTROLS[name]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
