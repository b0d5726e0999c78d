"""Synthetic COCO-format fixture generator — the port's copy of
multipathnet_tpu/data/synthetic.py: the same seed writes the same files
(tests/test_torch_data.py).

With no network, no COCO data, and no pretrained weights (SURVEY.md §6
"Practical consequence"), correctness is demonstrated on (a) op-level oracles
and (b) synthetic datasets with analytically known structure. This module
generates a tiny but fully COCO-shaped dataset on disk — instances JSON +
PNG images + a proposal .npz — so every layer above (loader, batch provider,
detector, evaluator) runs the exact production code path.

Scenes: solid background, `num_objects` axis-aligned shapes per image, one
shape type per category (rectangle / ellipse / cross / stripes-square), each
with a distinct color family => trivially learnable, and GT is exact.
Proposals mimic DeepMask output: jittered GT boxes + uniform random boxes.
"""

from __future__ import annotations

import json
import os

import numpy as np

from multipathnet_tpu_torch.data.proposals import ProposalStore

CATEGORY_NAMES = ("rect", "ellipse", "cross", "stripes")

_EXT = {"png": "png", "jpeg": "jpg"}


def _save(pil_img, path: str, image_format: str) -> None:
    """PNG (lossless) or quality-95 JPEG — the latter so fixtures exercise
    the real libjpeg decode path (COCO ships JPEGs; every fixture was PNG
    until r4, leaving CocoLoader's JPEG row with zero coverage)."""
    if image_format == "jpeg":
        pil_img.save(path, format="JPEG", quality=95)
    else:
        assert image_format == "png", image_format
        pil_img.save(path)
# distinct color per category (R, G, B)
_COLORS = np.array(
    [[220, 60, 60], [60, 200, 80], [70, 90, 220], [230, 200, 50]], np.uint8
)


def _draw(img: np.ndarray, cls: int, x1, y1, x2, y2) -> None:
    h, w, _ = img.shape
    x1i, y1i = int(round(x1)), int(round(y1))
    x2i, y2i = int(round(x2)), int(round(y2))
    color = _COLORS[cls % len(_COLORS)]
    if cls % 4 == 0:  # rect
        img[y1i:y2i, x1i:x2i] = color
    elif cls % 4 == 1:  # ellipse
        yy, xx = np.mgrid[y1i:y2i, x1i:x2i]
        cy, cx = (y1i + y2i) / 2, (x1i + x2i) / 2
        ry, rx = max((y2i - y1i) / 2, 1), max((x2i - x1i) / 2, 1)
        m = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
        img[y1i:y2i, x1i:x2i][m] = color
    elif cls % 4 == 2:  # cross
        mx, my = (x1i + x2i) // 2, (y1i + y2i) // 2
        tw = max((x2i - x1i) // 4, 1)
        th = max((y2i - y1i) // 4, 1)
        img[y1i:y2i, mx - tw // 2 : mx + tw // 2 + 1] = color
        img[my - th // 2 : my + th // 2 + 1, x1i:x2i] = color
    else:  # stripes
        patch = img[y1i:y2i, x1i:x2i]
        patch[::2] = color
        img[y1i:y2i, x1i:x2i] = patch


def _segmentation(cls: int, x1, y1, bw, bh) -> list:
    """COCO polygon matching the drawn shape (GT for mask-proposal training)."""
    x2, y2 = x1 + bw, y1 + bh
    if cls % 4 == 1:  # ellipse -> 16-gon
        cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
        t = np.linspace(0, 2 * np.pi, 16, endpoint=False)
        xs = cx + (bw / 2) * np.cos(t)
        ys = cy + (bh / 2) * np.sin(t)
        return [list(np.stack([xs, ys], -1).reshape(-1).astype(float))]
    if cls % 4 == 2:  # cross: two bars
        mx, my = (x1 + x2) / 2, (y1 + y2) / 2
        tw, th = max(bw / 4, 1), max(bh / 4, 1)
        v = [mx - tw / 2, y1, mx + tw / 2, y1, mx + tw / 2, y2,
             mx - tw / 2, y2]
        hz = [x1, my - th / 2, x2, my - th / 2, x2, my + th / 2,
              x1, my + th / 2]
        return [[float(x) for x in v], [float(x) for x in hz]]
    # rect / stripes: the box itself
    return [[float(x1), float(y1), float(x2), float(y1),
             float(x2), float(y2), float(x1), float(y2)]]


def generate(
    root: str,
    *,
    num_images: int = 16,
    image_size: int = 64,
    num_classes: int = 4,
    max_objects: int = 4,
    proposals_per_image: int = 32,
    jitter: float = 0.1,
    seed: int = 0,
    split: str = "synthetic",
    image_format: str = "png",
) -> dict:
    """Write images/, annotations/instances_<split>.json, proposals_<split>.npz.

    Returns paths dict. Deterministic for a given seed.

    image_format: "png" (lossless — the exact-AP fixtures rely on it) or
    "jpeg" (real COCO images are JPEG; quality-95 files exercise the actual
    libjpeg decode path in CocoLoader.load_image — SURVEY.md §2.2 JPEG row).
    """
    rng = np.random.default_rng(seed)
    s = image_size
    img_dir = os.path.join(root, split)
    ann_dir = os.path.join(root, "annotations")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)

    images, annotations = [], []
    prop_boxes, prop_scores, image_ids = [], [], []
    ann_id = 1
    from PIL import Image

    for i in range(num_images):
        img_id = 1000 + i
        img = np.full((s, s, 3), 16, np.uint8)
        img += rng.integers(0, 8, (s, s, 3), dtype=np.uint8)  # light noise
        n_obj = int(rng.integers(1, max_objects + 1))
        gt = []
        for _ in range(n_obj):
            cls = int(rng.integers(0, num_classes))
            bw = rng.uniform(0.15 * s, 0.45 * s)
            bh = rng.uniform(0.15 * s, 0.45 * s)
            x1 = rng.uniform(0, s - bw - 1)
            y1 = rng.uniform(0, s - bh - 1)
            _draw(img, cls, x1, y1, x1 + bw, y1 + bh)
            gt.append((cls, x1, y1, bw, bh))
            annotations.append({
                "id": ann_id,
                "image_id": img_id,
                "category_id": cls + 1,
                "bbox": [float(x1), float(y1), float(bw), float(bh)],
                "area": float(bw * bh),
                "iscrowd": 0,
                "segmentation": _segmentation(cls, x1, y1, bw, bh),
            })
            ann_id += 1
        fname = f"{split}_{img_id}.{_EXT[image_format]}"
        _save(Image.fromarray(img), os.path.join(img_dir, fname), image_format)
        images.append({"id": img_id, "file_name": fname,
                       "height": s, "width": s})

        # proposals: jittered GT (guaranteed fg pool) + random boxes
        pb, ps = [], []
        for cls, x1, y1, bw, bh in gt:
            for _ in range(max(proposals_per_image // (2 * n_obj), 2)):
                dx, dy = rng.normal(0, jitter * bw), rng.normal(0, jitter * bh)
                dw = bw * np.exp(rng.normal(0, jitter))
                dh = bh * np.exp(rng.normal(0, jitter))
                nx1 = np.clip(x1 + dx, 0, s - 2)
                ny1 = np.clip(y1 + dy, 0, s - 2)
                pb.append([nx1, ny1, min(nx1 + dw, s - 1), min(ny1 + dh, s - 1)])
                ps.append(rng.uniform(0.5, 1.0))
        while len(pb) < proposals_per_image:
            bw = rng.uniform(0.1 * s, 0.5 * s)
            bh = rng.uniform(0.1 * s, 0.5 * s)
            x1 = rng.uniform(0, s - bw - 1)
            y1 = rng.uniform(0, s - bh - 1)
            pb.append([x1, y1, x1 + bw, y1 + bh])
            ps.append(rng.uniform(0.0, 0.6))
        prop_boxes.append(np.asarray(pb[:proposals_per_image], np.float32))
        prop_scores.append(np.asarray(ps[:proposals_per_image], np.float32))
        image_ids.append(img_id)

    ann_path = os.path.join(ann_dir, f"instances_{split}.json")
    with open(ann_path, "w") as f:
        json.dump({
            "images": images,
            "annotations": annotations,
            "categories": [
                {"id": c + 1, "name": CATEGORY_NAMES[c % len(CATEGORY_NAMES)]}
                for c in range(num_classes)
            ],
        }, f)

    prop_path = os.path.join(root, f"proposals_{split}.npz")
    ProposalStore.from_lists(prop_boxes, prop_scores, image_ids).save(prop_path)
    return {"root": root, "annotations": ann_path, "images": img_dir,
            "proposals": prop_path, "split": split}


def generate_voc(
    root: str,
    *,
    num_images: int = 16,
    image_size: int = 64,
    num_classes: int = 4,
    max_objects: int = 4,
    proposals_per_image: int = 32,
    jitter: float = 0.1,
    seed: int = 0,
    split: str = "test",
    year: str = "2007",
    difficult_frac: float = 0.0,
    image_format: str = "png",
) -> dict:
    """Write a VOCdevkit/VOC{year} tree (Annotations XML + JPEGImages +
    ImageSets/Main/{split}.txt) with the same synthetic scenes as generate(),
    plus proposals keyed by numeric image id. Class names are the first
    `num_classes` standard VOC classes so VocLoader's default mapping holds.
    `difficult_frac` marks that fraction of objects difficult (VOC-eval
    ignore semantics)."""
    import xml.etree.ElementTree as ET

    from PIL import Image

    from multipathnet_tpu_torch.data.voc import VOC_CLASSES

    assert num_classes <= len(VOC_CLASSES)
    rng = np.random.default_rng(seed)
    s = image_size
    base = os.path.join(root, f"VOC{year}")
    ann_dir = os.path.join(base, "Annotations")
    img_dir = os.path.join(base, "JPEGImages")
    set_dir = os.path.join(base, "ImageSets", "Main")
    for d in (ann_dir, img_dir, set_dir):
        os.makedirs(d, exist_ok=True)

    ids, prop_boxes, prop_scores, image_ids = [], [], [], []
    for i in range(num_images):
        img_id = 1000 + i
        sid = f"{img_id:06d}"
        img = np.full((s, s, 3), 16, np.uint8)
        img += rng.integers(0, 8, (s, s, 3), dtype=np.uint8)
        n_obj = int(rng.integers(1, max_objects + 1))

        xroot = ET.Element("annotation")
        ET.SubElement(xroot, "filename").text = f"{sid}.{_EXT[image_format]}"
        size_el = ET.SubElement(xroot, "size")
        ET.SubElement(size_el, "width").text = str(s)
        ET.SubElement(size_el, "height").text = str(s)
        ET.SubElement(size_el, "depth").text = "3"

        gt = []
        for _ in range(n_obj):
            cls = int(rng.integers(0, num_classes))
            bw = rng.uniform(0.15 * s, 0.45 * s)
            bh = rng.uniform(0.15 * s, 0.45 * s)
            x1 = rng.uniform(0, s - bw - 1)
            y1 = rng.uniform(0, s - bh - 1)
            _draw(img, cls, x1, y1, x1 + bw, y1 + bh)
            gt.append((cls, x1, y1, bw, bh))
            obj = ET.SubElement(xroot, "object")
            ET.SubElement(obj, "name").text = VOC_CLASSES[cls]
            ET.SubElement(obj, "difficult").text = str(
                int(rng.uniform() < difficult_frac))
            bb = ET.SubElement(obj, "bndbox")
            # 0-based half-open -> VOC 1-based inclusive
            ET.SubElement(bb, "xmin").text = str(round(x1 + 1, 2))
            ET.SubElement(bb, "ymin").text = str(round(y1 + 1, 2))
            ET.SubElement(bb, "xmax").text = str(round(x1 + bw, 2))
            ET.SubElement(bb, "ymax").text = str(round(y1 + bh, 2))

        _save(Image.fromarray(img),
              os.path.join(img_dir, f"{sid}.{_EXT[image_format]}"),
              image_format)
        ET.ElementTree(xroot).write(os.path.join(ann_dir, f"{sid}.xml"))
        ids.append(sid)

        pb, ps = [], []
        for cls, x1, y1, bw, bh in gt:
            for _ in range(max(proposals_per_image // (2 * n_obj), 2)):
                dx, dy = rng.normal(0, jitter * bw), rng.normal(0, jitter * bh)
                dw = bw * np.exp(rng.normal(0, jitter))
                dh = bh * np.exp(rng.normal(0, jitter))
                nx1 = np.clip(x1 + dx, 0, s - 2)
                ny1 = np.clip(y1 + dy, 0, s - 2)
                pb.append([nx1, ny1, min(nx1 + dw, s - 1),
                           min(ny1 + dh, s - 1)])
                ps.append(rng.uniform(0.5, 1.0))
        while len(pb) < proposals_per_image:
            bw = rng.uniform(0.1 * s, 0.5 * s)
            bh = rng.uniform(0.1 * s, 0.5 * s)
            x1 = rng.uniform(0, s - bw - 1)
            y1 = rng.uniform(0, s - bh - 1)
            pb.append([x1, y1, x1 + bw, y1 + bh])
            ps.append(rng.uniform(0.0, 0.6))
        prop_boxes.append(np.asarray(pb[:proposals_per_image], np.float32))
        prop_scores.append(np.asarray(ps[:proposals_per_image], np.float32))
        image_ids.append(img_id)

    with open(os.path.join(set_dir, f"{split}.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    prop_path = os.path.join(root, f"proposals_voc_{split}.npz")
    ProposalStore.from_lists(prop_boxes, prop_scores, image_ids).save(prop_path)
    return {"root": root, "devkit": root, "base": base, "split": split,
            "proposals": prop_path}
