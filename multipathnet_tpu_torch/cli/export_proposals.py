"""Bulk proposal export — port of multipathnet_tpu/cli/export_proposals.py:
run the SharpMask network over a split and write the proposals .npz that
the detector reads (data/proposals.ProposalStore), the reference's
offline-proposal workflow.

    python -m multipathnet_tpu_torch.cli.export_proposals --preset tiny \
        --synthetic --dataset-root DS --proposal-checkpoint-dir RUN \
        --output DS/proposals_generated.npz --top-k 64 [--with-masks] \
        [--device cpu]

with RUN the train.checkpoint_dir of a `cli.train --proposal-net` run.
Images go through at their own size, so the split must have one image
size; --with-masks stores each proposal's mask as compressed RLE beside
its box (the reference's DeepMask/SharpMask proposal files were mask
proposals).
"""

from __future__ import annotations

import argparse

import numpy as np

from multipathnet_tpu_torch.cli import common


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    common.add_config_args(p)
    p.add_argument("--proposal-checkpoint-dir", default="",
                   help="SharpMask checkpoint (random init if omitted)")
    p.add_argument("--output", required=True, help="output proposals .npz")
    p.add_argument("--top-k", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--with-masks", action="store_true",
                   help="decode a mask per proposal and store it as "
                        "compressed RLE beside the boxes")
    p.add_argument("--mask-threshold", type=float, default=0.5)
    args = p.parse_args(argv)

    cfg = common.build_config(args)
    loader, _ = common.resolve_data(args, cfg)

    import torch

    from multipathnet_tpu_torch.data import rle as rle_codec
    from multipathnet_tpu_torch.data.proposals import ProposalStore
    from multipathnet_tpu_torch.data.transforms import normalize
    from multipathnet_tpu_torch.models.sharpmask import generate_proposals

    trainer, _ = common.restore_proposal_state(
        cfg, args.proposal_checkpoint_dir, device=args.device)
    sizes = {loader.image_size(i) for i in range(len(loader))}
    if len(sizes) != 1:
        raise SystemExit(
            "export_proposals requires uniform image sizes (got "
            f"{sorted(sizes)[:4]}...); resize offline first")

    boxes_per, scores_per, ids, rles = [], [], [], []
    bs, n = args.batch_size, len(loader)
    for s in range(0, n, bs):
        idxs = list(range(s, min(s + bs, n)))
        raw = np.stack([loader.load_image(i) for i in
                        idxs + [idxs[-1]] * (bs - len(idxs))])
        images = normalize(torch.as_tensor(raw, device=trainer.device))
        out = generate_proposals(trainer.model, images, top_k=args.top_k,
                                 with_masks=args.with_masks)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        for j, i in enumerate(idxs):
            boxes_per.append(out["boxes"][j])
            scores_per.append(out["scores"][j])
            ids.append(loader.image_id(i))
            if args.with_masks:
                h, w = loader.image_size(i)
                rles.extend(rle_codec.masks_to_rles(
                    out["masks"][j], out["boxes"][j], h, w,
                    threshold=args.mask_threshold))
        print(f"\r{min(s + bs, n)}/{n} images", end="", flush=True)
    print()
    store = ProposalStore.from_lists(boxes_per, scores_per, ids)
    if args.with_masks:
        store.rles = rles
    store.save(args.output)
    print(f"wrote {args.output}: {len(ids)} images x {args.top_k} proposals"
          + (" (+RLE masks)" if args.with_masks else ""))


if __name__ == "__main__":
    main()
