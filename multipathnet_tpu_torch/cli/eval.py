"""Evaluation entry point — port of multipathnet_tpu/cli/eval.py
(run_test.lua analog, SURVEY.md §2.1, §3.2).

    python -m multipathnet_tpu_torch.cli.eval --preset tiny --synthetic \
        --dataset-root DS --checkpoint-dir RUN [--device cpu] [--json]

with RUN the train.checkpoint_dir of a cli.train run on the same DS.
Prints the full COCO metric table (or one JSON line with --json). A serving
preset (int8 head, truncated-SVD ranks) restores the float checkpoint and
transforms it at load. Under torchrun

    torchrun --nproc_per_node=N -m multipathnet_tpu_torch.cli.eval ...

it evaluates over the reference's data mesh (the widest width up to N that
divides the eval batch; "eval mesh: W-wide data parallel" on stderr): each
rank decodes and detects its rows, the first evaluates and prints.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from multipathnet_tpu_torch.cli import common


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    common.add_config_args(p)
    p.add_argument("--checkpoint-dir", default="",
                   help="restore params from here (default: random init)")
    p.add_argument("--max-images", type=int, default=0)
    p.add_argument("--json", action="store_true",
                   help="print metrics as one JSON line")
    args = p.parse_args(argv)

    cfg = common.build_config(args)
    launched, mesh = common.launched_mesh(args.device,
                                          max(cfg.train.batch_size, 1))
    if launched and mesh is None:
        return  # a rank past the mesh's width
    first = common.is_first(mesh)
    loader, props = common.resolve_data(args, cfg, mesh)
    if loader.num_classes != cfg.model.num_classes:
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, num_classes=loader.num_classes))

    from multipathnet_tpu_torch.eval.tester import Tester

    if mesh is not None and mesh.n_data > 1 and first:
        print(f"eval mesh: {mesh.n_data}-wide data parallel",
              file=sys.stderr)
    trainer, _ = common.restore_float_state(cfg, args.checkpoint_dir,
                                            device=args.device, mesh=mesh)
    model, params = common.eval_model_for(cfg, trainer)
    tester = Tester(model, cfg, loader, props, params=params,
                    device=trainer.device, mesh=mesh)
    metrics = tester.test(max_images=args.max_images or None,
                          verbose=not args.json and first)
    if args.json and first:
        print(json.dumps({k: round(v, 5) for k, v in metrics.items()}))


if __name__ == "__main__":
    main()
