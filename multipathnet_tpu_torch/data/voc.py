"""PASCAL VOC dataset loader (VOCdevkit XML annotations) — the port's copy
of multipathnet_tpu/data/voc.py, held equal to it by tests/test_torch_data.py.

The reference trained/evaluated on PASCAL alongside COCO (SURVEY.md §2.1
"Dataset loader": "Wraps COCO JSON ... and PASCAL"; "utils.lua ... VOC eval").
Round-1 shipped the VOC *evaluator* (eval/voc_eval.py) with no data source —
this loader completes the protocol end to end.

Exposes the same loader contract as data/coco.py (len / image_id /
image_size / image_path / load_image / annotations / num_classes /
cat_to_label / label_to_cat), so DetectionPipeline, Tester and the CLIs work
unchanged. VOC semantics carried through:
  - XML pixel coordinates are 1-based inclusive -> converted to 0-based
    half-open (x1 = xmin - 1), the devkit convention;
  - "difficult" objects are kept and flagged: the VOC protocol ignores them
    at eval time (eval/voc_eval.py matches them without credit or penalty);
  - category ids are 1..20 in the standard class order (label == cat id).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle",
    "bus", "car", "cat", "chair", "cow",
    "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


class VocLoader:
    """VOCdevkit/VOC{year} tree: Annotations/*.xml, JPEGImages/*,
    ImageSets/Main/{split}.txt."""

    protocol = "voc"  # Tester routes to the VOC mAP evaluator

    def __init__(self, devkit_root: str, split: str = "test",
                 year: str = "2007", classes=None):
        self.base = os.path.join(devkit_root, f"VOC{year}")
        ids_file = os.path.join(self.base, "ImageSets", "Main",
                                f"{split}.txt")
        with open(ids_file) as f:
            self.ids = [line.strip() for line in f if line.strip()]
        self.classes = tuple(classes) if classes else VOC_CLASSES
        self._cls_index = {c: i + 1 for i, c in enumerate(self.classes)}
        self.category_ids = list(range(1, len(self.classes) + 1))
        self.category_names = list(self.classes)
        self.cat_to_label = {c: c for c in self.category_ids}
        self.label_to_cat = {c: c for c in self.category_ids}
        self._cache: dict[int, dict] = {}

    @property
    def num_classes(self) -> int:
        return len(self.classes) + 1  # + background

    def __len__(self) -> int:
        return len(self.ids)

    def _xml(self, i: int) -> dict:
        if i in self._cache:
            return self._cache[i]
        path = os.path.join(self.base, "Annotations", f"{self.ids[i]}.xml")
        root = ET.parse(path).getroot()
        size = root.find("size")
        h = int(size.find("height").text)
        w = int(size.find("width").text)
        fname = root.findtext("filename") or f"{self.ids[i]}.jpg"
        boxes, classes, difficult = [], [], []
        for obj in root.findall("object"):
            name = obj.findtext("name")
            label = self._cls_index.get(name)
            if label is None:
                continue  # class not in the configured list
            bb = obj.find("bndbox")
            # 1-based inclusive -> 0-based half-open
            x1 = float(bb.findtext("xmin")) - 1.0
            y1 = float(bb.findtext("ymin")) - 1.0
            x2 = float(bb.findtext("xmax"))
            y2 = float(bb.findtext("ymax"))
            boxes.append((x1, y1, x2, y2))
            classes.append(label)
            difficult.append(int(obj.findtext("difficult") or 0) != 0)
        rec = {
            "height": h, "width": w, "file_name": fname,
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "classes": np.asarray(classes, np.int32),
            "difficult": np.asarray(difficult, bool),
        }
        self._cache[i] = rec
        return rec

    def image_id(self, i: int) -> int:
        """VOC ids are strings like '000012'; numeric ids pass through as
        ints (synthetic fixtures + the standard devkit both qualify)."""
        return int(self.ids[i])

    def image_size(self, i: int):
        rec = self._xml(i)
        return rec["height"], rec["width"]

    def image_path(self, i: int) -> str:
        return os.path.join(self.base, "JPEGImages", self._xml(i)["file_name"])

    def load_image(self, i: int) -> np.ndarray:
        from PIL import Image

        with Image.open(self.image_path(i)) as im:
            return np.asarray(im.convert("RGB"), np.uint8)

    def annotations(self, i: int) -> dict:
        rec = self._xml(i)
        boxes = rec["boxes"]
        areas = ((boxes[:, 2] - boxes[:, 0])
                 * (boxes[:, 3] - boxes[:, 1])).astype(np.float32)
        return {
            "boxes": boxes,
            "classes": rec["classes"],
            "iscrowd": np.zeros(len(boxes), bool),  # no crowd concept in VOC
            "areas": areas,
            "difficult": rec["difficult"],
            "segmentations": [None] * len(boxes),
        }
