"""Split-level evaluation harness — port of multipathnet_tpu/eval/tester.py
(Tester_FRCNN analog, SURVEY.md §2.1, §3.2).

Loop over an eval split: batched detection on the device (eval/detect.py),
convert the fixed-size detection sets to COCO result dicts, score with the
self-contained evaluator (eval/coco_eval.py, eval/voc_eval.py). The
reference's mesh has no counterpart here: data-parallel evaluation is
ROADMAP A17.
"""

from __future__ import annotations

import numpy as np

from multipathnet_tpu_torch.core.config import Config
from multipathnet_tpu_torch.data.pipeline import DetectionPipeline
from multipathnet_tpu_torch.data.proposals import ProposalStore
from multipathnet_tpu_torch.eval.coco_eval import CocoEvaluator
from multipathnet_tpu_torch.eval.detect import Detector
from multipathnet_tpu_torch.models.multipath import MultiPathNet


def detections_to_coco(out: dict, image_ids, label_to_cat,
                       rles_per_image=None) -> list[dict]:
    """Fixed-size detection arrays (B, D, ...) -> COCO result dicts.

    rles_per_image: optional per-image lists of proposal RLE dicts — each
    detection then carries its SOURCE proposal's mask (via the NMS
    provenance indices), which is how the reference turned DeepMask mask
    proposals + detector scores into segmentation-challenge entries."""
    results = []
    for b, img_id in enumerate(image_ids):
        valid = out["valid"][b]
        rles = rles_per_image[b] if rles_per_image is not None else None
        for k, (box, score, cls, ok) in enumerate(zip(
                out["boxes"][b], out["scores"][b], out["classes"][b], valid)):
            if not ok:
                continue
            x1, y1, x2, y2 = (float(v) for v in box)
            d = {
                "image_id": int(img_id),
                "category_id": int(label_to_cat[int(cls)]),
                "bbox": [x1, y1, x2 - x1, y2 - y1],
                "score": float(score),
            }
            if rles is not None:
                src = int(out["indices"][b][k])
                if 0 <= src < len(rles):
                    d["segmentation"] = rles[src]
                else:  # padded slot — should not be valid, but stay safe
                    continue
            results.append(d)
    return results


def groundtruth_to_coco(loader, segm: bool = False) -> list[dict]:
    """segm=True rasterizes polygon GT (or passes RLE dicts through) into
    compressed RLEs for the mask-IoU protocol."""
    if segm:
        from multipathnet_tpu_torch.data import rle as rle_codec
    gts = []
    for i in range(len(loader)):
        ann = loader.annotations(i)
        img_id = loader.image_id(i)
        difficult = ann.get("difficult")
        segs = ann.get("segmentations") if segm else None
        hw = loader.image_size(i) if segm else None
        for k, (box, cls, crowd, area) in enumerate(zip(
                ann["boxes"], ann["classes"], ann["iscrowd"], ann["areas"])):
            x1, y1, x2, y2 = (float(v) for v in box)
            g = {
                "image_id": int(img_id),
                "category_id": int(loader.label_to_cat[int(cls)]),
                "bbox": [x1, y1, x2 - x1, y2 - y1],
                "area": float(area),
                "iscrowd": bool(crowd),
            }
            if difficult is not None:
                g["difficult"] = bool(difficult[k])  # VOC ignore semantics
            if segm:
                seg = segs[k] if segs else None
                assert seg is not None, (
                    f"segm eval needs GT masks; image {img_id} ann {k} "
                    "has none")
                if isinstance(seg, dict):
                    g["segmentation"] = seg  # already RLE
                else:  # COCO polygon list
                    h, w = hw
                    g["segmentation"] = rle_codec.encode(
                        rle_codec.polys_to_mask(seg, h, w))
            gts.append(g)
    return gts


class Tester:
    """`model`, `cfg`, `device` and `params` go to Detector (which moves
    the model to `device`, by default the model's own, and transforms a
    flax-layout `params` tree for a serving config at load)."""

    __test__ = False  # not a pytest class

    def __init__(self, model: MultiPathNet, cfg: Config, loader,
                 proposals: ProposalStore, params=None, device=None,
                 batch_size: int = None):
        self.cfg = cfg
        self.loader = loader
        self.proposals = proposals
        self.detector = Detector(model, cfg, device=device, params=params)
        self.pipeline = DetectionPipeline(
            loader, proposals, cfg.data,
            batch_size=batch_size or max(cfg.train.batch_size, 1),
            seed=cfg.train.seed)

    def collect_detections(self, max_images: int = None,
                           with_segm: bool = False) -> list[dict]:
        """The split loop in the reference's order: batch N's COCO-dict
        conversion runs after batch N+1's detection. Detector copies each
        batch to its device and returns host arrays, so nothing here
        overlaps the card (a pinned side-stream copy ahead of use measured
        no faster over a split on the card: PERF.md); results equal a
        serial loop's."""
        def convert(idxs, out):
            ids = [self.loader.image_id(i) for i in idxs]
            sliced = {k: np.asarray(v)[: len(ids)] for k, v in out.items()}
            rles = None
            if with_segm:
                rles = [self.proposals.rles_for_image_id(i) for i in ids]
                assert all(r is not None for r in rles), (
                    "segm eval needs a mask-proposal store "
                    "(ProposalStore.from_mask_proposals)")
            return detections_to_coco(
                sliced, ids, self.loader.label_to_cat, rles_per_image=rles)

        results = []
        done = 0
        pending = None
        for idxs, batch in self.pipeline.eval_batches():
            # the fields Detector reads: images, src_hws, proposals, prop_mask
            out = self.detector(*batch[:4])
            if pending is not None:
                results.extend(convert(*pending))
            pending = (idxs, out)
            done += len(idxs)
            if max_images and done >= max_images:
                break
        if pending is not None:
            results.extend(convert(*pending))
        return results

    def test(self, max_images: int = None, verbose: bool = False,
             protocol: str = None, mode: str = "bbox") -> dict:
        """protocol: "coco" (AP .5:.95 table) or "voc" (devkit mAP).
        Default: the loader's declared protocol (VocLoader) else COCO.
        mode: "bbox" or "segm" (mask IoU; detections carry their source
        proposal's mask — requires a mask-proposal store)."""
        segm = mode == "segm"
        dets = self.collect_detections(max_images, with_segm=segm)
        gts = groundtruth_to_coco(self.loader, segm=segm)
        if max_images:
            keep_ids = {self.loader.image_id(i)
                        for i in range(min(max_images, len(self.loader)))}
            gts = [g for g in gts if g["image_id"] in keep_ids]
            dets = [d for d in dets if d["image_id"] in keep_ids]
        protocol = protocol or getattr(self.loader, "protocol", "coco")
        if segm:
            assert protocol != "voc", "segm protocol is COCO-only"
            return CocoEvaluator(mode="segm").evaluate(gts, dets,
                                                       verbose=verbose)
        if protocol == "voc":
            from multipathnet_tpu_torch.eval.voc_eval import evaluate_voc

            res = evaluate_voc(gts, dets)
            return {"mAP": res["mAP"],
                    **{f"AP_{c}": v for c, v in res["AP_per_class"].items()}}
        return CocoEvaluator().evaluate(gts, dets, verbose=verbose)
