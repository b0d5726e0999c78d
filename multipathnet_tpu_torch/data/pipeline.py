"""Host data pipeline: loader + proposals -> fixed-shape batches — port of
multipathnet_tpu/data/pipeline.py.

The host does only the irreducible host work — file decode and padding to
static shapes — on a background thread with a small decode pool; everything
else (resize, normalize, flip, IoU matching, fg/bg sampling) runs in the
train step on the device (train/loop.py). Batches are the port's
train.loop.Batch of numpy arrays, field for field the reference's
(tests/test_torch_data.py); `epoch_on_device` hands each one to a `put`
(Trainer.stream_batch: pinned memory, a side CUDA stream) `depth` batches
ahead of its use.

`shard=(index, count)` makes the pipeline one data-parallel rank's: each
batch is cut into `count` equal parts of consecutive rows and only part
`index` is decoded and returned, so the ranks' parts together are the
single-process batch, in its order (`examples_decoded` counts what this
pipeline decoded).
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from typing import Iterator, Optional

import numpy as np

from multipathnet_tpu_torch.core.config import DataConfig
from multipathnet_tpu_torch.core.padding import pad_axis_to, pad_to
from multipathnet_tpu_torch.data.proposals import ProposalStore
from multipathnet_tpu_torch.train.loop import Batch


class DetectionPipeline:
    def __init__(self, loader, proposals: ProposalStore, cfg: DataConfig,
                 batch_size: int, seed: int = 0,
                 raw_hw: Optional[tuple] = None,
                 with_masks: bool = False, mask_size: int = 28,
                 num_workers: int = 2, shard: tuple = (0, 1)):
        index, count = shard
        if batch_size % count or not 0 <= index < count:
            raise ValueError(f"batch {batch_size} does not split into "
                             f"{count} parts, or part {index} is not one")
        self.shard = shard
        self.examples_decoded = 0
        self.loader = loader
        self.proposals = proposals
        self.cfg = cfg
        self.batch_size = batch_size
        self.seed = seed
        self.with_masks = with_masks
        self.mask_size = mask_size
        # decode worker pool (the reference's nDonkeys analog); 0 = inline
        self._pool = None
        if num_workers > 0:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=num_workers,
                                            thread_name_prefix="decode")
        if raw_hw is None:
            hs, ws = zip(*(loader.image_size(i) for i in range(len(loader))))
            raw_hw = (max(hs), max(ws))
        self.raw_hw = raw_hw

    def __len__(self) -> int:
        return len(self.loader) // self.batch_size

    def _make_example(self, i: int):
        cfg = self.cfg
        img = self.loader.load_image(i)
        h, w = img.shape[:2]
        img = pad_axis_to(pad_axis_to(img, self.raw_hw[0], 0),
                          self.raw_hw[1], 1)
        props, _ = self.proposals.for_image_id(self.loader.image_id(i))
        props, pmask = pad_to(props.astype(np.float32), cfg.max_proposals)
        ann = self.loader.annotations(i)
        keep = ~ann["iscrowd"]  # crowds are not sampling targets
        gtb, gmask = pad_to(ann["boxes"][keep].astype(np.float32),
                            cfg.max_gt_per_image)
        gtc = pad_axis_to(ann["classes"][keep].astype(np.int32),
                          cfg.max_gt_per_image)
        out = [img, np.array([h, w], np.float32), props, pmask, gtb, gtc,
               gmask]
        if self.with_masks:
            out.append(self._gt_masks(ann, keep, h, w))
        return tuple(out)

    def _gt_masks(self, ann, keep, h, w) -> np.ndarray:
        """Rasterize per-GT instance masks cropped to their box, resized to
        (mask_size, mask_size) — mask-proposal training targets."""
        from PIL import Image

        from multipathnet_tpu_torch.data import rle

        m = self.mask_size
        out = np.zeros((self.cfg.max_gt_per_image, m, m), np.float32)
        segs = [s for s, k in zip(ann["segmentations"], keep) if k]
        boxes = ann["boxes"][keep]
        for gi, (seg, box) in enumerate(zip(segs, boxes)):
            if gi >= out.shape[0]:
                break
            x1, y1, x2, y2 = (int(np.floor(box[0])), int(np.floor(box[1])),
                              int(np.ceil(box[2])), int(np.ceil(box[3])))
            x2, y2 = max(x2, x1 + 1), max(y2, y1 + 1)
            if isinstance(seg, list) and seg:
                full = rle.polys_to_mask(seg, h, w)
            elif isinstance(seg, dict):
                full = rle.decode(seg)
            else:  # no segmentation: the box itself is the mask
                full = np.zeros((h, w), np.uint8)
                full[max(y1, 0):y2, max(x1, 0):x2] = 1
            crop = full[max(y1, 0):y2, max(x1, 0):x2]
            if crop.size == 0:
                continue
            img = Image.fromarray((crop * 255).astype(np.uint8))
            out[gi] = np.asarray(img.resize((m, m), Image.BILINEAR),
                                 np.float32) / 255.0
        return out

    def _rows(self, idxs):
        """This shard's part of a batch's image indices."""
        index, count = self.shard
        if len(idxs) % count:
            raise ValueError(f"a batch of {len(idxs)} does not split into "
                             f"{count} parts")
        k = len(idxs) // count
        return idxs[index * k:(index + 1) * k]

    def _assemble(self, idxs) -> Batch:
        ints = [int(i) for i in self._rows(idxs)]
        self.examples_decoded += len(ints)
        if self._pool is not None:
            examples = list(self._pool.map(self._make_example, ints))
        else:
            examples = [self._make_example(i) for i in ints]
        stack = [np.stack(c) for c in zip(*examples)]
        return Batch(*stack)

    def epoch(self, epoch_idx: int) -> Iterator[Batch]:
        """Deterministic shuffled epoch with background prefetch."""
        rng = np.random.default_rng((self.seed, epoch_idx))
        order = rng.permutation(len(self.loader))
        n = len(self)
        q: queue.Queue = queue.Queue(maxsize=max(self.cfg.prefetch, 1))
        stop = object()

        def worker():
            try:
                for bi in range(n):
                    idxs = order[bi * self.batch_size:(bi + 1) * self.batch_size]
                    q.put(self._assemble(idxs))
            finally:
                q.put(stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item

    def epoch_on_device(self, epoch_idx: int, put, depth: int = 2
                        ) -> Iterator[Batch]:
        """epoch() with device prefetch: `put` (Trainer.stream_batch) is
        called `depth` batches ahead of consumption, so the host->device
        copy of batch N+1 overlaps the device compute of batch N. The copy
        is asynchronous, so enqueueing early costs only device memory for
        `depth` extra batches (about 10 MB each at 8 x 640^2)."""
        return device_prefetch(self.epoch(epoch_idx), put, depth=depth)

    def eval_batches(self, batch_size: Optional[int] = None) -> Iterator[tuple]:
        """Sequential (no shuffle/aug) batches for the tester: yields
        (image_indices, Batch). The last partial batch is padded by repeating
        the final example; consumers slice by len(indices). A shard's
        Batch holds its rows of the padded batch; the indices stay the
        whole batch's."""
        bs = batch_size or self.batch_size
        n = len(self.loader)
        for s in range(0, n, bs):
            idxs = list(range(s, min(s + bs, n)))
            pad = idxs + [idxs[-1]] * (bs - len(idxs))
            yield idxs, self._assemble(pad)


def device_prefetch(batches, put, depth: int = 2):
    """Keep `depth` batches in flight to the device.

    `put` starts an (asynchronous) host->device copy and returns device
    tensors that work queued after it may read (core/device.HostToDevice);
    batches are yielded in order.
    """
    buf: deque = deque()
    depth = max(depth, 1)
    for b in batches:
        buf.append(put(b))
        if len(buf) > depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()
