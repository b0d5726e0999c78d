"""Self-contained COCO-protocol detection AP evaluator — the port's copy of
multipathnet_tpu/eval/coco_eval.py, NumPy only (the reference's optional C++
box IoU is a speed path with the same results; ROADMAP). Metric dicts equal
the reference's exactly (tests/test_torch_eval.py).

Replaces the lua `coco` API's CocoEval used by Tester_FRCNN (SURVEY.md §2.1
"Test harness", §2.2 "COCO mask/eval ops") — pycocotools is not installed and
cannot be downloaded (SURVEY.md §7 environment facts).

Implements the standard COCO detection protocol [H, SURVEY.md §7.3 item 2]:
  - IoU thresholds 0.50:0.05:0.95, 101-point recall interpolation
  - greedy per-image/per-category matching, score-descending, crowd GT may
    absorb multiple detections (ignored, not penalized), ignored GT last
  - area ranges all/small/medium/large, maxDets 1/10/100
  - AP averaged over categories present in the ground truth

Inputs are plain dicts (bbox in COCO xywh), so the evaluator is independent of
the rest of the framework and testable on hand-constructed cases with
analytically known AP (tests/test_coco_eval.py).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

IOU_THRS = np.round(np.arange(0.5, 1.0, 0.05), 2)
REC_THRS = np.round(np.linspace(0.0, 1.0, 101), 2)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = (1, 10, 100)


def box_iou_xywh(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray):
    """IoU of xywh boxes; crowd GT uses union = area(dt) (maskApi semantics)."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx1, dy1 = dt[:, 0], dt[:, 1]
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    iw = np.maximum(
        np.minimum(dx2[:, None], gx2[None, :]) - np.maximum(dx1[:, None], gx1[None, :]), 0
    )
    ih = np.maximum(
        np.minimum(dy2[:, None], gy2[None, :]) - np.maximum(dy1[:, None], gy1[None, :]), 0
    )
    inter = iw * ih
    da = (dt[:, 2] * dt[:, 3])[:, None]
    ga = (gt[:, 2] * gt[:, 3])[None, :]
    union = np.where(iscrowd[None, :], da, da + ga - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


class CocoEvaluator:
    """evaluate(groundtruth, detections) -> metric dict.

    groundtruth: iterable of {"image_id", "category_id", "bbox" xywh,
        "area" (opt), "iscrowd" (opt), "ignore" (opt)}
    detections:  iterable of {"image_id", "category_id", "bbox" xywh, "score"}
    """

    def __init__(self, iou_thrs=IOU_THRS, rec_thrs=REC_THRS,
                 area_ranges=None, max_dets=MAX_DETS, iou_fn=None,
                 mode: str = "bbox"):
        """mode="segm" matches on mask IoU ("segmentation" RLE dicts on both
        GT and detections) — the COCO segmentation-challenge protocol the
        reference competed under (SURVEY.md §0)."""
        self.iou_thrs = np.asarray(iou_thrs, np.float64)
        self.rec_thrs = np.asarray(rec_thrs, np.float64)
        self.area_ranges = dict(area_ranges or AREA_RANGES)
        self.max_dets = tuple(sorted(max_dets))
        assert mode in ("bbox", "segm"), mode
        self.mode = mode
        self.iou_fn = iou_fn or box_iou_xywh

    # -- per (image, category) matching ------------------------------------
    def _match(self, dts, gts, area_rng):
        """Greedy matching for one (img, cat) over all IoU thresholds.

        Returns dict with per-threshold match/ignore flags and det scores.
        """
        t_n = len(self.iou_thrs)
        scores = np.array([d["score"] for d in dts], np.float64)
        order = np.argsort(-scores, kind="mergesort")
        dts = [dts[i] for i in order]
        scores = scores[order]
        max_det = self.max_dets[-1]
        dts = dts[:max_det]
        scores = scores[:max_det]

        g_ignore = np.array(
            [
                bool(g.get("ignore", False))
                or bool(g.get("iscrowd", False))
                or not (area_rng[0] <= g.get("area", g["bbox"][2] * g["bbox"][3]) < area_rng[1])
                for g in gts
            ],
            bool,
        )
        # ignored GT sorted last (stable) — matching prefers real GT
        g_order = np.argsort(g_ignore, kind="mergesort")
        gts = [gts[i] for i in g_order]
        g_ignore = g_ignore[g_order]
        iscrowd = np.array([bool(g.get("iscrowd", False)) for g in gts], bool)

        if self.mode == "segm":
            from multipathnet_tpu_torch.data import rle as rle_codec

            ious = rle_codec.iou(
                [d["segmentation"] for d in dts],
                [g["segmentation"] for g in gts], iscrowd.tolist(),
            ) if dts and gts else np.zeros((len(dts), len(gts)))
        else:
            ious = self.iou_fn(
                np.array([d["bbox"] for d in dts], np.float64).reshape(-1, 4),
                np.array([g["bbox"] for g in gts], np.float64).reshape(-1, 4),
                iscrowd,
            )

        d_n, g_n = len(dts), len(gts)
        dt_match = np.zeros((t_n, d_n), np.int64)  # 1 + matched gt index, 0 = none
        gt_match = np.zeros((t_n, g_n), np.int64)
        dt_ignore = np.zeros((t_n, d_n), bool)
        for ti, thr in enumerate(self.iou_thrs):
            for di in range(d_n):
                best = min(thr, 1 - 1e-10)
                m = -1
                for gi in range(g_n):
                    if gt_match[ti, gi] and not iscrowd[gi]:
                        continue
                    if m > -1 and not g_ignore[m] and g_ignore[gi]:
                        break  # only ignored GT remain; keep the real match
                    if ious[di, gi] < best:
                        continue
                    best = ious[di, gi]
                    m = gi
                if m == -1:
                    continue
                dt_match[ti, di] = m + 1
                gt_match[ti, m] = di + 1
                dt_ignore[ti, di] = g_ignore[m]
        # unmatched detections outside the area range are ignored, not FPs
        if self.mode == "segm":
            from multipathnet_tpu_torch.data import rle as rle_codec

            d_area = np.array([rle_codec.area(d["segmentation"])
                               for d in dts], np.float64)
        else:
            d_area = np.array([d["bbox"][2] * d["bbox"][3] for d in dts],
                              np.float64)
        d_out = (d_area < area_rng[0]) | (d_area >= area_rng[1])
        dt_ignore |= (dt_match == 0) & d_out[None, :]
        return {
            "scores": scores,
            "dt_match": dt_match,
            "dt_ignore": dt_ignore,
            "num_gt": int((~g_ignore).sum()),
        }

    # -- accumulation --------------------------------------------------------
    def evaluate(self, groundtruth, detections, verbose: bool = False) -> dict:
        gts_by = defaultdict(list)
        dts_by = defaultdict(list)
        img_ids = set()
        cat_ids = set()
        for g in groundtruth:
            gts_by[(g["image_id"], g["category_id"])].append(g)
            img_ids.add(g["image_id"])
            cat_ids.add(g["category_id"])
        for d in detections:
            dts_by[(d["image_id"], d["category_id"])].append(d)
            img_ids.add(d["image_id"])
        img_ids = sorted(img_ids)
        cat_ids = sorted(cat_ids)  # only categories with GT count toward AP

        t_n, r_n = len(self.iou_thrs), len(self.rec_thrs)
        a_names = list(self.area_ranges)
        # precision[T, R, K, A, M], recall[T, K, A, M]
        precision = -np.ones((t_n, r_n, len(cat_ids), len(a_names), len(self.max_dets)))
        recall = -np.ones((t_n, len(cat_ids), len(a_names), len(self.max_dets)))

        for ki, cat in enumerate(cat_ids):
            for ai, aname in enumerate(a_names):
                rng = self.area_ranges[aname]
                per_img = [
                    self._match(dts_by.get((im, cat), []), gts_by.get((im, cat), []), rng)
                    for im in img_ids
                    if (im, cat) in dts_by or (im, cat) in gts_by
                ]
                if not per_img:
                    continue
                for mi, max_det in enumerate(self.max_dets):
                    scores = np.concatenate([e["scores"][:max_det] for e in per_img])
                    dtm = np.concatenate([e["dt_match"][:, :max_det] for e in per_img], 1)
                    dtig = np.concatenate([e["dt_ignore"][:, :max_det] for e in per_img], 1)
                    npig = sum(e["num_gt"] for e in per_img)
                    if npig == 0:
                        continue
                    order = np.argsort(-scores, kind="mergesort")
                    dtm = dtm[:, order]
                    dtig = dtig[:, order]
                    tps = np.cumsum((dtm > 0) & ~dtig, 1).astype(np.float64)
                    fps = np.cumsum((dtm == 0) & ~dtig, 1).astype(np.float64)
                    for ti in range(t_n):
                        tp, fp = tps[ti], fps[ti]
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / np.maximum(tp + fp, 1e-12)
                        recall[ti, ki, ai, mi] = rc[-1] if nd else 0.0
                        # precision envelope (monotone non-increasing from right)
                        q = np.zeros(r_n)
                        if nd:
                            pr = pr.tolist()
                            for i in range(nd - 1, 0, -1):
                                if pr[i] > pr[i - 1]:
                                    pr[i - 1] = pr[i]
                            inds = np.searchsorted(rc, self.rec_thrs, side="left")
                            for ri, pi in enumerate(inds):
                                if pi < nd:
                                    q[ri] = pr[pi]
                        precision[ti, :, ki, ai, mi] = q

        def _ap(t=None, area="all", max_det=100):
            ai = a_names.index(area)
            mi = self.max_dets.index(max_det)
            p = precision[:, :, :, ai, mi] if t is None else \
                precision[[int(np.argmin(np.abs(self.iou_thrs - t)))], :, :, ai, mi]
            p = p[p > -1]
            return float(p.mean()) if p.size else -1.0

        def _ar(area="all", max_det=100):
            ai = a_names.index(area)
            mi = self.max_dets.index(max_det)
            r = recall[:, :, ai, mi]
            r = r[r > -1]
            return float(r.mean()) if r.size else -1.0

        metrics = {
            "AP": _ap(),
            "AP50": _ap(t=0.5),
            "AP75": _ap(t=0.75),
            "APsmall": _ap(area="small"),
            "APmedium": _ap(area="medium"),
            "APlarge": _ap(area="large"),
            "AR1": _ar(max_det=self.max_dets[0]),
            "AR10": _ar(max_det=self.max_dets[1]) if len(self.max_dets) > 2 else -1.0,
            "AR100": _ar(),
            "ARsmall": _ar(area="small"),
            "ARmedium": _ar(area="medium"),
            "ARlarge": _ar(area="large"),
        }
        if verbose:
            for k, v in metrics.items():
                print(f"  {k:9s} = {v:.4f}")
        return metrics


def evaluate_detections(groundtruth, detections, **kw) -> dict:
    return CocoEvaluator(**kw).evaluate(groundtruth, detections)
