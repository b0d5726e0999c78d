"""The one traffic generator: host batches from a mix's parameters and a seed.

A mix is a JSON file, benchmark/traffic/<mix>.json. Every batch is drawn
on the host with numpy from the seed, as a user hands the program numpy
arrays: uint8 images in a square buffer of `canvas` pixels a side, each
image's valid extent `long_side` on its long side and uniform in
`short_side` (inclusive) on the other, portrait or landscape at random,
the buffer zero beyond it; pixels uniform in 0..254 as bench.py draws
them. Proposals, all valid, lie inside the extent: x1 and y1 uniform in
[0, xy_frac * side), widths and heights uniform in [side_min, side_frac
* side) of the extent's side, as bench.py's generator draws them on a
full canvas. A training mix adds `gt` = [min, max] ground-truth boxes an
image, drawn as the proposals are, and their classes uniform in
`gt_classes` = [low, high); the rest of the `max_gt` slots are masked out.
`pool` distinct batches are drawn and the run cycles through them.
"""

from __future__ import annotations

import numpy as np


def _boxes(rng, hws, n: int, mix: dict) -> np.ndarray:
    """(B, n, 4) float32 boxes inside each extent (h, w) of hws."""
    h = hws[:, 0:1].astype(np.float64)
    w = hws[:, 1:2].astype(np.float64)
    b = hws.shape[0]
    lo, frac = mix["side"]
    x1 = rng.uniform(0.0, 1.0, (b, n)) * w * mix["xy_frac"]
    y1 = rng.uniform(0.0, 1.0, (b, n)) * h * mix["xy_frac"]
    bw = lo + rng.uniform(0.0, 1.0, (b, n)) * (frac * w - lo)
    bh = lo + rng.uniform(0.0, 1.0, (b, n)) * (frac * h - lo)
    return np.stack([x1, y1, x1 + bw, y1 + bh], -1).astype(np.float32)


def _images(rng, mix: dict):
    """-> (images (B, S, S, 3) uint8, src_hws (B, 2) float32)."""
    b, s = mix["batch"], mix["canvas"]
    lo, hi = mix["short_side"]
    short = rng.integers(lo, hi + 1, b)
    portrait = rng.random(b) < 0.5
    long = np.full(b, mix["long_side"])
    hws = np.stack([np.where(portrait, long, short),
                    np.where(portrait, short, long)], -1)
    images = rng.integers(0, 255, (b, s, s, 3), dtype=np.uint8)
    for i, (h, w) in enumerate(hws):
        images[i, h:] = 0
        images[i, :, w:] = 0
    return images, hws.astype(np.float32)


def detect_batch(rng, mix: dict) -> tuple:
    """(images, src_hws, proposals, prop_mask), Detector's arguments."""
    images, hws = _images(rng, mix)
    props = _boxes(rng, hws, mix["proposals"], mix)
    return images, hws, props, np.ones(props.shape[:2], bool)


def train_batch(rng, mix: dict) -> tuple:
    """detect_batch's arrays plus (gt_boxes, gt_classes, gt_mask) padded
    to mix["max_gt"] slots, Trainer.step's batch."""
    images, hws, props, pmask = detect_batch(rng, mix)
    b, slots = mix["batch"], mix["max_gt"]
    lo, hi = mix["gt"]
    count = rng.integers(lo, hi + 1, b)
    gt = _boxes(rng, hws, slots, mix)
    classes = rng.integers(mix["gt_classes"][0], mix["gt_classes"][1],
                           (b, slots)).astype(np.int32)
    mask = np.arange(slots)[None, :] < count[:, None]
    gt = np.where(mask[..., None], gt, 0.0).astype(np.float32)
    classes = np.where(mask, classes, 0).astype(np.int32)
    return images, hws, props, pmask, gt, classes, mask


KINDS = {"detect": detect_batch, "train": train_batch}


def batches(mix: dict, seed: int) -> list:
    """The mix's pool of distinct batches drawn from `seed`."""
    rng = np.random.default_rng(seed)
    make = KINDS[mix["kind"]]
    return [make(rng, mix) for _ in range(mix["pool"])]
