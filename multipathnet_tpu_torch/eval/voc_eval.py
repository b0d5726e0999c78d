"""PASCAL VOC detection mAP — the port's copy of
multipathnet_tpu/eval/voc_eval.py, the utils.lua VOC-eval analog (SURVEY.md §2.1
"Detection utils": the reference supported PASCAL alongside COCO).

Protocol (VOC devkit): per class, detections sorted by score, greedy-matched
to unmatched GT at IoU >= 0.5; "difficult" GT are ignored (match them without
credit or penalty). AP either 11-point interpolated (VOC2007) or the exact
area under the monotonized PR curve (VOC2010+). mAP = mean over classes with
GT. Input dicts match eval/coco_eval.py (bbox xywh) with optional
"difficult" on GT.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from multipathnet_tpu_torch.eval.coco_eval import box_iou_xywh


def _class_ap(gts, dets, iou_thr: float, use_07_metric: bool) -> float:
    by_img = defaultdict(list)
    n_pos = 0
    for g in gts:
        by_img[g["image_id"]].append(g)
        if not g.get("difficult", False):
            n_pos += 1
    if n_pos == 0:
        return float("nan")

    dets = sorted(dets, key=lambda d: -d["score"])
    matched = {k: np.zeros(len(v), bool) for k, v in by_img.items()}
    tp = np.zeros(len(dets))
    fp = np.zeros(len(dets))
    for di, d in enumerate(dets):
        gl = by_img.get(d["image_id"], [])
        if not gl:
            fp[di] = 1
            continue
        iou = box_iou_xywh(
            np.asarray([d["bbox"]], float),
            np.asarray([g["bbox"] for g in gl], float),
            np.zeros(len(gl), bool))[0]
        best = int(np.argmax(iou))
        if iou[best] >= iou_thr:
            if gl[best].get("difficult", False):
                continue  # ignored: neither TP nor FP
            if not matched[d["image_id"]][best]:
                matched[d["image_id"]][best] = True
                tp[di] = 1
            else:
                fp[di] = 1  # duplicate
        else:
            fp[di] = 1

    tp_c = np.cumsum(tp)
    fp_c = np.cumsum(fp)
    rec = tp_c / n_pos
    prec = tp_c / np.maximum(tp_c + fp_c, 1e-12)

    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.01, 0.1):
            p = prec[rec >= t].max() if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    # VOC2010+: exact area under monotonized PR
    mrec = np.concatenate([[0.0], rec, [1.0]])
    mpre = np.concatenate([[0.0], prec, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.nonzero(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def evaluate_voc(groundtruth, detections, *, iou_threshold: float = 0.5,
                 use_07_metric: bool = False) -> dict:
    """Returns {"mAP": float, "AP_per_class": {cat_id: ap}}."""
    gts_by = defaultdict(list)
    dts_by = defaultdict(list)
    for g in groundtruth:
        gts_by[g["category_id"]].append(g)
    for d in detections:
        dts_by[d["category_id"]].append(d)
    aps = {}
    for cat, gl in gts_by.items():
        aps[cat] = _class_ap(gl, dts_by.get(cat, []), iou_threshold,
                             use_07_metric)
    vals = [v for v in aps.values() if not np.isnan(v)]
    return {"mAP": float(np.mean(vals)) if vals else 0.0,
            "AP_per_class": aps}
