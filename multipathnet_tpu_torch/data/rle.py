"""COCO run-length-encoding codec — the port's copy of the NumPy codec in
multipathnet_tpu/data/rle.py (maskApi.c's formats, written from the spec).

- *uncompressed RLE*: {"size": [h, w], "counts": [n0, n1, ...]} — column-major
  (Fortran order) runs, starting with the count of 0s.
- *compressed RLE*: the LEB128-like ASCII string used inside COCO JSON.

The codec entry points (mask_to_counts, counts_to_mask, encode_counts,
decode_counts, area, to_bbox, and through them encode, decode and iou)
dispatch to the C++ codec of data/rle_native.py (the port's copy of
native/rle.cpp, built with g++ at first use) when it builds and loads, as
the reference dispatches to its own; it is a host speed path whose
results equal the NumPy versions (the `_np` functions, the oracle and the
fallback) byte for byte (tests/test_torch_rle_native.py). `codec()` says
which one runs. tests/test_torch_data.py holds this module equal to the
reference's.
"""

from __future__ import annotations

import numpy as np

from multipathnet_tpu_torch.data import rle_native


def mask_to_counts_np(mask: np.ndarray) -> list[int]:
    """Binary mask (h, w) -> uncompressed RLE counts (column-major)."""
    flat = np.asfortranarray(mask.astype(np.uint8)).reshape(-1, order="F")
    # run-length encode, first run counts zeros (may be 0-length)
    changes = np.nonzero(np.diff(flat))[0] + 1
    bounds = np.concatenate([[0], changes, [flat.size]])
    runs = np.diff(bounds).tolist()
    if flat.size and flat[0] == 1:
        runs = [0] + runs
    return [int(r) for r in runs]


def counts_to_mask_np(counts, size) -> np.ndarray:
    """Uncompressed RLE -> binary mask (h, w) uint8."""
    h, w = size
    total = int(np.sum(counts))
    assert total == h * w, f"RLE covers {total} px, mask is {h}x{w}"
    flat = np.zeros(h * w, np.uint8)
    pos, val = 0, 0
    for c in counts:
        if val:
            flat[pos : pos + c] = 1
        pos += c
        val ^= 1
    return flat.reshape((h, w), order="F")


def encode_counts_np(counts) -> str:
    """Counts -> COCO compressed RLE string (maskApi rleToString format):
    each count is delta-encoded (from the count two back) and written as a
    variable-length base-32 signed integer using chars 48..111, with bit 0x20
    as the continuation flag."""
    s = []
    counts = list(counts)
    for i, c in enumerate(counts):
        x = int(c)
        if i > 2:
            x -= int(counts[i - 2])
        more = True
        while more:
            v = x & 0x1F
            x >>= 5
            # sign-propagating shift: done when remaining bits match sign bit
            more = not (x == 0 and not (v & 0x10)) and not (x == -1 and (v & 0x10))
            if more:
                v |= 0x20
            s.append(chr(v + 48))
    return "".join(s)


def decode_counts_np(s: str) -> list[int]:
    """COCO compressed RLE string -> counts."""
    counts: list[int] = []
    i = 0
    n = len(s)
    while i < n:
        x = 0
        k = 0
        more = True
        while more:
            v = ord(s[i]) - 48
            x |= (v & 0x1F) << (5 * k)
            more = bool(v & 0x20)
            i += 1
            k += 1
            if not more and (v & 0x10):
                x |= -1 << (5 * k)  # sign-extend
        if len(counts) > 2:
            x += counts[-2]
        counts.append(int(x))
    return counts


def codec() -> str:
    """"native" when the C++ codec built and loaded, else "numpy"."""
    return "native" if rle_native.available() else "numpy"


def mask_to_counts(mask: np.ndarray) -> list[int]:
    """Binary mask (h, w) -> uncompressed RLE counts (column-major)."""
    if rle_native.available():
        return rle_native.mask_to_counts(mask)
    return mask_to_counts_np(mask)


def counts_to_mask(counts, size) -> np.ndarray:
    """Uncompressed RLE -> binary mask (h, w) uint8."""
    if rle_native.available():
        return rle_native.counts_to_mask(counts, size)
    return counts_to_mask_np(counts, size)


def encode_counts(counts) -> str:
    """Counts -> COCO compressed RLE string."""
    if rle_native.available():
        return rle_native.encode_string(counts)
    return encode_counts_np(counts)


def decode_counts(s: str) -> list[int]:
    """COCO compressed RLE string -> counts."""
    if rle_native.available():
        return rle_native.decode_string(s)
    return decode_counts_np(s)


def encode(mask: np.ndarray) -> dict:
    """Binary mask -> compressed RLE dict (as found in COCO JSON)."""
    h, w = mask.shape
    return {"size": [int(h), int(w)], "counts": encode_counts(mask_to_counts(mask))}


def decode(rle: dict) -> np.ndarray:
    """RLE dict (compressed string or uncompressed list counts) -> mask."""
    return counts_to_mask(_counts_of(rle), rle["size"])


def _counts_of(rle: dict) -> list[int]:
    """The uncompressed counts of an RLE dict (compressed or not)."""
    counts = rle["counts"]
    if isinstance(counts, bytes):
        counts = counts.decode("ascii")
    if isinstance(counts, str):
        counts = decode_counts(counts)
    return counts


def area_np(rle: dict) -> int:
    """Foreground pixel count straight from the runs (no mask materialize)."""
    return int(np.sum(_counts_of(rle)[1::2]))


def to_bbox_np(rle: dict) -> np.ndarray:
    """RLE -> tight (x, y, w, h) bbox, computed from runs without a full mask.

    This is the DeepMask-proposals -> boxes path (SURVEY.md §2.2): column-major
    runs give column index = pos // h, row index = pos % h for each fg run.
    """
    h, _ = rle["size"]
    counts = np.asarray(_counts_of(rle), np.int64)
    if counts[1::2].sum() == 0:
        return np.zeros(4, np.float32)
    ends = np.cumsum(counts)
    starts = ends - counts
    fg_s, fg_e = starts[1::2], ends[1::2] - 1  # inclusive run ends
    live = counts[1::2] > 0
    fg_s, fg_e = fg_s[live], fg_e[live]
    x0 = int(np.min(fg_s // h))
    x1 = int(np.max(fg_e // h))
    # rows: a run can wrap columns; if it spans >= h pixels it covers all rows
    rs = fg_s % h
    re = fg_e % h
    wraps = (fg_e // h) > (fg_s // h)
    if np.any(wraps):
        y0, y1 = 0, h - 1
    else:
        y0 = int(np.min(rs))
        y1 = int(np.max(re))
    return np.array([x0, y0, x1 - x0 + 1, y1 - y0 + 1], np.float32)


def area(rle: dict) -> int:
    """Foreground pixel count straight from the runs (no mask materialize)."""
    if rle_native.available():
        return rle_native.area_bbox(_counts_of(rle), rle["size"][0])[0]
    return area_np(rle)


def to_bbox(rle: dict) -> np.ndarray:
    """RLE -> tight float32 (x, y, w, h) bbox, from the runs."""
    if rle_native.available():
        return rle_native.area_bbox(_counts_of(rle), rle["size"][0])[1]
    return to_bbox_np(rle)


def paste_mask(mask: np.ndarray, box, height: int, width: int,
               threshold: float = 0.5) -> np.ndarray:
    """Paste an (m, m) probability mask predicted for `box` (x1,y1,x2,y2
    image coords) into a full (height, width) binary mask.

    This rasterizes SharpMaskNet.decode_masks output into the image frame —
    the step that turns net mask logits into the RLE payload the reference's
    DeepMask/SharpMask proposal files carried (SURVEY.md §0/§2.2). Bilinear
    sampling at pixel centers with the same geometry decode_masks pooled
    under (the m x m grid spans the box), pure NumPy, edge-clamped."""
    out = np.zeros((height, width), np.uint8)
    x1, y1, x2, y2 = [float(v) for v in box]
    xi1, yi1 = max(int(np.floor(x1)), 0), max(int(np.floor(y1)), 0)
    xi2, yi2 = min(int(np.ceil(x2)), width), min(int(np.ceil(y2)), height)
    bw, bh = x2 - x1, y2 - y1
    if xi2 <= xi1 or yi2 <= yi1 or bw <= 0 or bh <= 0:
        return out
    m = mask.shape[0]
    mask = np.asarray(mask, np.float32)
    # target pixel centers -> source mask coords (align_corners=False)
    us = (np.arange(xi1, xi2) + 0.5 - x1) / bw * m - 0.5
    vs = (np.arange(yi1, yi2) + 0.5 - y1) / bh * m - 0.5
    u0 = np.clip(np.floor(us).astype(np.int64), 0, m - 1)
    v0 = np.clip(np.floor(vs).astype(np.int64), 0, m - 1)
    u1 = np.minimum(u0 + 1, m - 1)
    v1 = np.minimum(v0 + 1, m - 1)
    fu = np.clip(us - u0, 0.0, 1.0)[None, :]
    fv = np.clip(vs - v0, 0.0, 1.0)[:, None]
    patch = (mask[np.ix_(v0, u0)] * (1 - fv) * (1 - fu)
             + mask[np.ix_(v0, u1)] * (1 - fv) * fu
             + mask[np.ix_(v1, u0)] * fv * (1 - fu)
             + mask[np.ix_(v1, u1)] * fv * fu)
    out[yi1:yi2, xi1:xi2] = patch > threshold
    return out


def masks_to_rles(masks, boxes, height: int, width: int,
                  threshold: float = 0.5) -> list:
    """(K, m, m) probability masks + (K, 4) boxes -> K compressed RLE dicts
    in the image frame. The proposal-export path (cli/export_proposals
    --with-masks): generated proposals become the same artifact shape the
    reference consumed from DeepMask/SharpMask .t7 files."""
    return [encode(paste_mask(mk, bx, height, width, threshold=threshold))
            for mk, bx in zip(np.asarray(masks), np.asarray(boxes))]


def polys_to_mask(polys, height: int, width: int) -> np.ndarray:
    """Rasterize COCO polygon segmentation -> binary mask (h, w).

    Even-odd fill via PIL (installed); replaces maskApi's rleFrPoly.
    """
    from PIL import Image, ImageDraw

    img = Image.new("L", (width, height), 0)
    draw = ImageDraw.Draw(img)
    for p in polys:
        pts = [(float(p[i]), float(p[i + 1])) for i in range(0, len(p) - 1, 2)]
        if len(pts) >= 3:
            draw.polygon(pts, outline=1, fill=1)
    return np.asarray(img, np.uint8)


def iou(dt: list[dict], gt: list[dict], iscrowd: list[int]) -> np.ndarray:
    """Mask IoU matrix (len(dt), len(gt)); crowd GT uses union = area(dt)
    (maskApi rleIou semantics)."""
    out = np.zeros((len(dt), len(gt)), np.float64)
    dm = [decode(d).astype(bool) for d in dt]
    gm = [decode(g).astype(bool) for g in gt]
    for j, g in enumerate(gm):
        ga = g.sum()
        for i, d in enumerate(dm):
            da = d.sum()
            inter = np.logical_and(d, g).sum()
            union = da if iscrowd[j] else da + ga - inter
            out[i, j] = inter / union if union > 0 else 0.0
    return out
