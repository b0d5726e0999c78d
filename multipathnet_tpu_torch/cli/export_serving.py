"""Export a serving bundle from a training checkpoint — port of
multipathnet_tpu/cli/export_serving.py.

    python -m multipathnet_tpu_torch.cli.export_serving \
        --preset multipath_vgg16_batched --checkpoint-dir RUN --out BUNDLE \
        --quant int8 [--svd-fc6 1024 --svd-fc7 256] [--device cpu]

The bundle (eval/serving.py) holds the config and the weights in serving
form: the fc kernels factored when the config (or --svd-fc6/7) gives
ranks, the head quantized to int8 with --quant int8 (the default).
`cli.serve --bundle BUNDLE` serves it.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

from multipathnet_tpu_torch.cli import common


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    common.add_config_args(p)
    p.add_argument("--checkpoint-dir", default="",
                   help="checkpoint dir (default: random init — useful "
                        "only for smoke tests)")
    p.add_argument("--out", required=True, help="bundle output directory")
    p.add_argument("--quant", default="int8", choices=("int8", "none"),
                   help="head quantization of the exported bundle")
    p.add_argument("--svd-fc6", type=int, default=-1, metavar="RANK",
                   help="truncated-SVD rank for fc6 (0 = full rank; "
                        "default: the preset's fc6_rank)")
    p.add_argument("--svd-fc7", type=int, default=-1, metavar="RANK",
                   help="truncated-SVD rank for fc7 (0 = full rank; "
                        "default: the preset's fc7_rank)")
    args = p.parse_args(argv)

    cfg = common.build_config(args)
    if args.svd_fc6 >= 0 or args.svd_fc7 >= 0:
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model,
            fc6_rank=args.svd_fc6 if args.svd_fc6 >= 0 else cfg.model.fc6_rank,
            fc7_rank=args.svd_fc7 if args.svd_fc7 >= 0 else cfg.model.fc7_rank,
        ))

    from multipathnet_tpu_torch.eval.serving import save_bundle
    from multipathnet_tpu_torch.models import convert

    trainer, state = common.restore_float_state(cfg, args.checkpoint_dir,
                                                device=args.device)
    if args.checkpoint_dir:
        print(f"exporting step {state.step}")
    svd_report: dict = {}
    save_bundle(args.out, cfg,
                convert.flax_from_state_dict(trainer.model.state_dict(),
                                             host=False),
                quant=args.quant, svd_report=svd_report)
    if svd_report:
        # an undertrained checkpoint's flat spectrum factors badly: show
        # each kernel's truncation error at export time
        print("SVD truncation rel err: " + ", ".join(
            f"{k}={e:.3f}" for k, e in sorted(svd_report.items())))
    sizes = {f: os.path.getsize(os.path.join(args.out, f))
             for f in sorted(os.listdir(args.out))}
    print(f"bundle written to {args.out}: " +
          ", ".join(f"{f} ({s / 1e6:.1f} MB)" for f, s in sizes.items()))


if __name__ == "__main__":
    main()
