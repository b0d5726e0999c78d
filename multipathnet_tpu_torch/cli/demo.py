"""Demo entry point — port of multipathnet_tpu/cli/demo.py (demo.lua
analog, SURVEY.md §2.1, §3.3).

One image -> proposals -> detections -> a PNG with the boxes drawn.
Proposals come from the split's proposal file (`--proposal-source file`),
from the SharpMask network (`sharpmask`, BASELINE config 5 end to end:
its masks are drawn under the detections they led to), or from a dense
sliding-window grid (`sliding`, also the source for `--image`).

    python -m multipathnet_tpu_torch.cli.demo --preset tiny --synthetic \
        --dataset-root DS --index 0 --output demo_out.png \
        [--proposal-source sharpmask --proposal-checkpoint-dir RUN] \
        [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from multipathnet_tpu_torch.cli import common

PALETTE = [(230, 60, 60), (60, 200, 90), (70, 100, 240), (240, 200, 40),
           (200, 80, 220), (60, 210, 210)]


def sliding_window_proposals(h: int, w: int, n: int = 256) -> np.ndarray:
    """Dense multi-scale window grid — the proposal source of last
    resort."""
    out = []
    for frac in (0.2, 0.35, 0.5, 0.7):
        bw, bh = w * frac, h * frac
        steps = max(int(np.sqrt(max(n // 8, 1))), 2)
        for cy in np.linspace(bh / 2, h - bh / 2, steps):
            for cx in np.linspace(bw / 2, w - bw / 2, steps):
                out.append([cx - bw / 2, cy - bh / 2, cx + bw / 2,
                            cy + bh / 2])
    return np.asarray(out[:n], np.float32)


def _overlay_masks(img, image, dets, proposal_masks, score_threshold):
    """Each kept detection's source proposal mask (dets["indices"]),
    resized to the detection's box and blended in its class color."""
    from PIL import Image

    overlay = np.asarray(img, np.float32)
    for box, score, cls, src, ok in zip(
            dets["boxes"], dets["scores"], dets["classes"], dets["indices"],
            dets["valid"]):
        if not ok or score < score_threshold or \
                int(src) >= len(proposal_masks):
            continue  # padded proposal slots have no mask
        x1, y1 = int(max(box[0], 0)), int(max(box[1], 0))
        x2 = int(min(box[2], image.shape[1]))
        y2 = int(min(box[3], image.shape[0]))
        if x2 <= x1 or y2 <= y1:
            continue
        m = Image.fromarray((proposal_masks[int(src)] * 255).astype(np.uint8))
        m = np.asarray(m.resize((x2 - x1, y2 - y1)), np.float32) / 255.0
        color = np.asarray(PALETTE[int(cls) % len(PALETTE)], np.float32)
        a = (m > 0.5)[..., None] * 0.45
        overlay[y1:y2, x1:x2] = overlay[y1:y2, x1:x2] * (1 - a) + color * a
    return Image.fromarray(overlay.astype(np.uint8))


def draw_detections(image: np.ndarray, dets: dict, class_names,
                    score_threshold: float = 0.3,
                    proposal_masks: np.ndarray | None = None):
    """Render boxes (and instance masks when SharpMask proposals provide
    them) -> (PIL image, number of boxes drawn)."""
    from PIL import Image, ImageDraw

    img = Image.fromarray(image).convert("RGB")
    if proposal_masks is not None and "indices" in dets:
        img = _overlay_masks(img, image, dets, proposal_masks,
                             score_threshold)
    dr = ImageDraw.Draw(img)
    n = 0
    for box, score, cls, ok in zip(dets["boxes"], dets["scores"],
                                   dets["classes"], dets["valid"]):
        if not ok or score < score_threshold:
            continue
        color = PALETTE[int(cls) % len(PALETTE)]
        dr.rectangle([float(box[0]), float(box[1]),
                      float(box[2]), float(box[3])], outline=color, width=2)
        name = class_names[int(cls) - 1] if int(cls) - 1 < len(class_names) \
            else str(int(cls))
        dr.text((float(box[0]) + 2, float(box[1]) + 2),
                f"{name} {float(score):.2f}", fill=color)
        n += 1
    return img, n


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    common.add_config_args(p)
    p.add_argument("--checkpoint-dir", default="")
    p.add_argument("--index", type=int, default=0, help="dataset image index")
    p.add_argument("--image", default="", help="arbitrary image file instead")
    p.add_argument("--output", default="demo_out.png")
    p.add_argument("--score-threshold", type=float, default=0.3)
    p.add_argument("--proposal-source", default="file",
                   choices=("file", "sharpmask", "sliding"),
                   help="file: precomputed .npz; sharpmask: run the "
                        "proposal net (config 5 end to end); sliding: a "
                        "dense grid")
    p.add_argument("--proposal-checkpoint-dir", default="",
                   help="SharpMask checkpoint (defaults to random init)")
    p.add_argument("--top-proposals", type=int, default=128)
    args = p.parse_args(argv)

    cfg = common.build_config(args)
    loader, props = common.resolve_data(args, cfg)
    if loader.num_classes != cfg.model.num_classes:
        cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, num_classes=loader.num_classes))

    import torch

    from multipathnet_tpu_torch.core.padding import pad_to
    from multipathnet_tpu_torch.eval.detect import Detector

    trainer, _ = common.restore_float_state(cfg, args.checkpoint_dir,
                                            strict=False, device=args.device)
    if args.image:
        from PIL import Image

        image = np.asarray(Image.open(args.image).convert("RGB"), np.uint8)
    else:
        image = loader.load_image(args.index)

    proposal_masks = None
    if args.proposal_source == "sharpmask":
        from multipathnet_tpu_torch.data.transforms import normalize
        from multipathnet_tpu_torch.models.sharpmask import \
            generate_proposals

        ptrainer, _ = common.restore_proposal_state(
            cfg, args.proposal_checkpoint_dir, strict=False,
            device=trainer.device)
        x = normalize(torch.as_tensor(np.array(image),
                                      device=trainer.device))[None]
        out = generate_proposals(ptrainer.model, x,
                                 top_k=args.top_proposals, with_masks=True)
        boxes = out["boxes"][0].cpu().numpy()
        proposal_masks = out["masks"][0].cpu().numpy()
        print(f"sharpmask: {len(boxes)} proposals (+masks), top score "
              f"{float(out['scores'][0].max()):.3f}")
    elif args.proposal_source == "sliding" or args.image:
        boxes = sliding_window_proposals(*image.shape[:2])
    else:
        boxes, _ = props.for_image_id(loader.image_id(args.index))

    h, w = image.shape[:2]
    pb, pm = pad_to(boxes.astype(np.float32), cfg.data.max_proposals)
    model, params = common.eval_model_for(cfg, trainer)
    det = Detector(model, cfg, params=params)
    out = det(image[None], np.asarray([[h, w]], np.float32), pb[None],
              pm[None])
    dets = {k: v[0] for k, v in out.items()}
    img, n = draw_detections(image, dets, loader.category_names,
                             args.score_threshold,
                             proposal_masks=proposal_masks)
    img.save(args.output)
    kept = int(dets["valid"].sum())
    print(f"{kept} detections ({n} above {args.score_threshold}); "
          f"wrote {args.output}")


if __name__ == "__main__":
    main()
