"""Precomputed-proposal storage — the port's copy of
multipathnet_tpu/data/proposals.py. The `.npz` layout is the same, so either
package reads the other's files (tests/test_torch_data.py).

The reference consumes DeepMask/SharpMask proposals from `.t7` tensor files
keyed by image (SURVEY.md §2.1 "Batch provider", §3.1). The format here:
a single `.npz` with flat arrays + offsets (O(1) mmap-friendly load, no
per-image pickles):

  boxes   (N, 4) f32  x1y1x2y2 image coordinates
  scores  (N,)   f32  proposal objectness
  offsets (I+1,) i64  image i owns rows [offsets[i], offsets[i+1])
  image_ids (I,) i64  COCO image ids, aligned with the loader's order
  [rles]  optional segmentation masks (COCO compressed-RLE dicts), aligned
          with `boxes` — the DeepMask/SharpMask mask-proposal payload that
          turns detections into segmentation-challenge results
"""

from __future__ import annotations

import json

import numpy as np


class ProposalStore:
    def __init__(self, boxes, scores, offsets, image_ids, rles=None):
        self.boxes = np.asarray(boxes, np.float32)
        self.scores = np.asarray(scores, np.float32)
        self.offsets = np.asarray(offsets, np.int64)
        self.image_ids = np.asarray(image_ids, np.int64)
        self.rles = list(rles) if rles is not None else None
        if self.rles is not None:
            assert len(self.rles) == len(self.boxes), (
                len(self.rles), len(self.boxes))
        self._by_id = {int(v): i for i, v in enumerate(self.image_ids)}

    @classmethod
    def load(cls, path: str) -> "ProposalStore":
        z = np.load(path)
        rles = None
        if "rles_json" in z.files:
            rles = json.loads(str(z["rles_json"]))
        return cls(z["boxes"], z["scores"], z["offsets"], z["image_ids"],
                   rles=rles)

    def save(self, path: str) -> None:
        extra = {}
        if self.rles is not None:
            extra["rles_json"] = json.dumps(self.rles)
        np.savez_compressed(
            path, boxes=self.boxes, scores=self.scores,
            offsets=self.offsets, image_ids=self.image_ids, **extra,
        )

    def __len__(self) -> int:
        return len(self.image_ids)

    def for_index(self, i: int):
        s, e = int(self.offsets[i]), int(self.offsets[i + 1])
        return self.boxes[s:e], self.scores[s:e]

    def for_image_id(self, image_id: int):
        return self.for_index(self._by_id[int(image_id)])

    def rles_for_image_id(self, image_id: int):
        """Segmentation masks for one image (None if the store is box-only)."""
        if self.rles is None:
            return None
        i = self._by_id[int(image_id)]
        s, e = int(self.offsets[i]), int(self.offsets[i + 1])
        return self.rles[s:e]

    @classmethod
    def from_mask_proposals(cls, per_image_rles, per_image_scores, image_ids,
                            keep_rles: bool = True):
        """Ingest DeepMask/SharpMask-style segmentation proposals: lists of
        COCO RLE dicts per image -> tight boxes via the (native) RLE codec
        (SURVEY.md §2.2 'Loading DeepMask proposals (RLE->boxes)').
        keep_rles retains the masks so detections can carry them into the
        COCO segmentation protocol (eval/tester.py mode='segm')."""
        from multipathnet_tpu_torch.data import rle as rle_codec

        per_image_boxes = []
        for rles in per_image_rles:
            boxes = np.zeros((len(rles), 4), np.float32)
            for i, r in enumerate(rles):
                x, y, w, h = rle_codec.to_bbox(r)
                boxes[i] = (x, y, x + w, y + h)
            per_image_boxes.append(boxes)
        store = cls.from_lists(per_image_boxes, per_image_scores, image_ids)
        if keep_rles:
            store.rles = [r for rles in per_image_rles for r in rles]
        return store

    @classmethod
    def from_t7(cls, path: str, **kwargs) -> "ProposalStore":
        """Reference-era Torch7 proposal files need the reference's t7
        reader (data/t7.py), which the port does not carry yet (ROADMAP
        A12d); convert them with the JAX package meanwhile."""
        raise NotImplementedError(
            "ProposalStore.from_t7 waits for the port of data/t7.py "
            "(ROADMAP A12d); load the .t7 with multipathnet_tpu's "
            "ProposalStore.from_t7 and save() it as .npz")

    @classmethod
    def from_lists(cls, per_image_boxes, per_image_scores, image_ids):
        offsets = np.zeros(len(image_ids) + 1, np.int64)
        for i, b in enumerate(per_image_boxes):
            offsets[i + 1] = offsets[i] + len(b)
        boxes = (np.concatenate(per_image_boxes, 0)
                 if len(per_image_boxes) else np.zeros((0, 4), np.float32))
        scores = (np.concatenate(per_image_scores, 0)
                  if len(per_image_scores) else np.zeros((0,), np.float32))
        return cls(boxes, scores, offsets, image_ids)
