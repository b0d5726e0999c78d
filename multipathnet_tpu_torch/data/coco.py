"""Self-contained COCO-format dataset loaders — the port's copy of
multipathnet_tpu/data/coco.py, held equal to it by tests/test_torch_data.py.

Rebuilds the reference's data layer (SURVEY.md §2.1: loaders/loader.lua,
concatloader.lua, narrowloader.lua — unverified names, empty mount) without the
lua `coco` API: plain JSON parsing + NumPy, no pycocotools.

Loader contract (mirrors the reference's behavioral surface, SURVEY.md L2):
  - len(loader), loader.image_path(i), loader.load_image(i) -> HWC uint8 RGB
  - loader.annotations(i) -> dict with "boxes" (G,4 x1y1x2y2 f32), "classes"
    (G,) int32 contiguous labels in [1, num_classes-1] (0 = background),
    "iscrowd" (G,) bool, "areas" (G,) f32
  - ConcatLoader / NarrowLoader compose datasets: trainval35k =
    Concat(train2014, Narrow(val2014, 0, 35000)); minival5k =
    Narrow(val2014, 35000, 5000)  [SURVEY.md §0 split convention]
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np


class CocoLoader:
    """COCO instances JSON + image dir. Detection-oriented view."""

    def __init__(self, annotations_path: str, image_root: str = ""):
        with open(annotations_path) as f:
            js = json.load(f)
        self.image_root = image_root
        self.images = sorted(js["images"], key=lambda im: im["id"])
        self._img_index = {im["id"]: k for k, im in enumerate(self.images)}

        # contiguous category mapping: COCO ids are sparse (1..90 for 80 cats)
        cats = sorted(js.get("categories", []), key=lambda c: c["id"])
        self.category_ids = [c["id"] for c in cats]
        self.category_names = [c["name"] for c in cats]
        self.cat_to_label = {cid: i + 1 for i, cid in enumerate(self.category_ids)}
        self.label_to_cat = {v: k for k, v in self.cat_to_label.items()}

        self._anns: list[list[dict]] = [[] for _ in self.images]
        for ann in js.get("annotations", []):
            k = self._img_index.get(ann["image_id"])
            if k is not None:
                self._anns[k].append(ann)

    @property
    def num_classes(self) -> int:
        return len(self.category_ids) + 1  # + background

    def __len__(self) -> int:
        return len(self.images)

    def image_id(self, i: int) -> int:
        return int(self.images[i]["id"])

    def image_size(self, i: int):
        im = self.images[i]
        return int(im["height"]), int(im["width"])

    def image_path(self, i: int) -> str:
        return os.path.join(self.image_root, self.images[i]["file_name"])

    def load_image(self, i: int) -> np.ndarray:
        """HWC uint8 RGB via PIL (host-side JPEG/PNG decode; the device-side
        pipeline starts from this decoded array — SURVEY.md §2.2 JPEG row)."""
        from PIL import Image

        with Image.open(self.image_path(i)) as im:
            return np.asarray(im.convert("RGB"), np.uint8)

    def annotations(self, i: int) -> dict:
        anns = self._anns[i]
        g = len(anns)
        boxes = np.zeros((g, 4), np.float32)
        classes = np.zeros((g,), np.int32)
        iscrowd = np.zeros((g,), bool)
        areas = np.zeros((g,), np.float32)
        segs = []
        for k, a in enumerate(anns):
            x, y, w, h = a["bbox"]
            boxes[k] = (x, y, x + w, y + h)
            classes[k] = self.cat_to_label.get(a["category_id"], 0)
            iscrowd[k] = bool(a.get("iscrowd", 0))
            areas[k] = a.get("area", w * h)
            segs.append(a.get("segmentation"))
        return {"boxes": boxes, "classes": classes, "iscrowd": iscrowd,
                "areas": areas, "segmentations": segs}


class NarrowLoader:
    """Contiguous index slice of another loader (narrowloader.lua analog)."""

    def __init__(self, base, offset: int, length: int):
        assert 0 <= offset and offset + length <= len(base)
        self.base, self.offset, self.length = base, offset, length

    def __len__(self):
        return self.length

    def __getattr__(self, name):
        # delegate metadata (num_classes, category_names, ...) to the base
        return getattr(self.base, name)

    def _i(self, i):
        assert 0 <= i < self.length, f"index {i} out of range"
        return self.offset + i

    def image_id(self, i):
        return self.base.image_id(self._i(i))

    def image_size(self, i):
        return self.base.image_size(self._i(i))

    def image_path(self, i):
        return self.base.image_path(self._i(i))

    def load_image(self, i):
        return self.base.load_image(self._i(i))

    def annotations(self, i):
        return self.base.annotations(self._i(i))


class ConcatLoader:
    """Concatenation of loaders (concatloader.lua analog; trainval35k)."""

    def __init__(self, loaders):
        assert loaders
        self.loaders = list(loaders)
        self._cum = np.cumsum([len(l) for l in self.loaders])

    def __len__(self):
        return int(self._cum[-1])

    def __getattr__(self, name):
        return getattr(self.loaders[0], name)

    def _locate(self, i):
        assert 0 <= i < len(self), f"index {i} out of range"
        k = int(np.searchsorted(self._cum, i, side="right"))
        prev = 0 if k == 0 else int(self._cum[k - 1])
        return self.loaders[k], i - prev

    def image_id(self, i):
        l, j = self._locate(i)
        return l.image_id(j)

    def image_size(self, i):
        l, j = self._locate(i)
        return l.image_size(j)

    def image_path(self, i):
        l, j = self._locate(i)
        return l.image_path(j)

    def load_image(self, i):
        l, j = self._locate(i)
        return l.load_image(j)

    def annotations(self, i):
        l, j = self._locate(i)
        return l.annotations(j)


def make_split(dataset_root: str, split: str,
               annotations: Optional[str] = None,
               val_take: int = 35000, minival: int = 5000):
    """The reference's split convention (SURVEY.md §0, §2.1):
    trainval35k = train2014 + first 35k of val2014; minival5k = last 5k.
    val_take/minival are parameters so the convention is testable on small
    fixtures."""
    def ann(name):
        return annotations or os.path.join(
            dataset_root, "annotations", f"instances_{name}.json")

    def imgs(name):
        return os.path.join(dataset_root, name)

    if split in ("train2014", "val2014", "train2017", "val2017"):
        return CocoLoader(ann(split), imgs(split))
    if split == "trainval35k":
        train = CocoLoader(ann("train2014"), imgs("train2014"))
        val = CocoLoader(ann("val2014"), imgs("val2014"))
        return ConcatLoader([train, NarrowLoader(val, 0, val_take)])
    if split == "minival5k":
        val = CocoLoader(ann("val2014"), imgs("val2014"))
        return NarrowLoader(val, len(val) - minival, minival)
    raise KeyError(f"unknown split {split!r}")
