"""Plain reference of MultiPath VGG-16 detection, in float32 PyTorch.

It imports nothing of the program and takes nothing the program made: it
reads the float checkpoint the benchmark drew ({name: tensor}, the port's
parameter names in torch layout) and the raw batch, and works out again
what the program derives from them (the int8 codes and scales of the
head, the pyramids, the views' geometry). The arithmetic follows the
published description and the configuration's options:

- pixels: RGB in [0, 1] less the ImageNet mean over its std, resized onto
  the canvas by the antialiased linear (triangle) resize, zero beyond the
  scaled extent;
- trunk: VGG-16's 13 3x3 convolutions with ReLU and 2x2 max pooling after
  blocks 1-4, tapping conv3_3, conv4_3, conv5_3 (strides 4, 8, 16); each
  tap reduced by its 1x1 convolution (no bias) to skip_reduce_dim;
- pool (MultiPath §3.1-3.2, roi_mode "align"): each view (the proposal
  scaled about its centre by a foveal factor, clipped to the canvas) is
  sampled on an average pyramid of each level's map (2x area pooling, an
  odd edge pooling alone) at the scale where its G bins span (0.5, 1]
  cell, with S x S bilinear samples a bin averaged; the 1x view sums
  every skip level, the context views read the last level ("reference"
  topology), or every view sums every level ("dense");
- head: skip bias and ReLU, one fc6 -> ReLU -> fc7 -> ReLU branch a view,
  each fc the (in -> rank) factor then the (rank -> fc_dim) layer where
  the configuration gives a rank, then one layer for the K integral
  classifiers and the class-specific box deltas; with head_quant "int8"
  every layer is symmetric int8: per-output-channel weight scales
  amax / 127, per-row activation scales amax * float32(1/127), round half
  to even, the integer products summed exactly;
- output: the K softmaxes averaged (MultiPath §3.3), the Fast R-CNN deltas
  decoded with the configured means and stds (widths clamped at
  log(1000 / 16)), clipped to the scaled extent, in source coordinates.

`Precision` lowers it for the control: the trunk, reduce and pooled maps
in fp8 (e4m3, one scale a tensor) in place of bf16, and the head in int4
in place of int8.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)
BBOX_CLIP = math.log(1000.0 / 16.0)
VGG16 = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
STRIDES = {"c3": 4, "c4": 8, "c5": 16}


class Precision(NamedTuple):
    """fp8: round the trunk's operands and the pooled maps to scaled e4m3;
    head_bits: the head's integer width (8 as configured, 4 for the
    control); 0 computes the head in float32."""

    fp8: bool = False
    head_bits: int = 8


def exact_float32() -> None:
    """float32 GEMMs and convolutions without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale that maps its largest
    magnitude to e4m3's largest finite value, back in float32."""
    amax = x.abs().amax().clamp(min=1e-30)
    s = 448.0 / amax
    return (x * s).to(torch.float8_e4m3fn).float() / s


# ------------------------------------------------------------- pixels ---

def _resize_weights(n_in: int, n_out: int, scale: torch.Tensor):
    """Antialiased linear resize weights, (B, n_out, n_in)."""
    dev = scale.device
    inv = (1.0 / scale)[:, None, None]
    ks = torch.clamp(inv, min=1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=dev)
              + 0.5)[None, :, None] * inv - 0.5
    cells = torch.arange(n_in, dtype=torch.float32, device=dev)
    w = torch.clamp(1.0 - torch.abs(sample - cells) / ks, min=0.0)
    total = w.sum(2, keepdim=True)
    w = torch.where(total.abs() > 1000 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside, w, torch.zeros_like(w))


def canvases(images_u8: torch.Tensor, src_hws: torch.Tensor, canvas: int):
    """-> (normalized canvases (B, S, S, 3) float32, scales (B,))."""
    dev = images_u8.device
    x = images_u8.float() / 255.0
    x = (x - torch.tensor(IMAGE_MEAN, device=dev)) / torch.tensor(
        IMAGE_STD, device=dev)
    sh, sw = src_hws[:, 0].float(), src_hws[:, 1].float()
    scale = torch.minimum(torch.full_like(sh, canvas) / sh,
                          torch.full_like(sw, canvas) / sw)
    h, w = images_u8.shape[1:3]
    out = torch.einsum("bpy,byxc->bpxc", _resize_weights(h, canvas, scale), x)
    out = torch.einsum("bqx,bpxc->bpqc", _resize_weights(w, canvas, scale),
                       out)
    ys = torch.arange(canvas, dtype=torch.float32, device=dev)
    valid = ((ys[None, :, None] < (sh * scale)[:, None, None])
             & (ys[None, None, :] < (sw * scale)[:, None, None]))
    return out * valid[..., None], scale


# -------------------------------------------------------------- trunk ---

def _conv(x, w, b, prec: Precision, padding: int):
    if prec.fp8:
        x, w = fp8(x), fp8(w)
    y = F.conv2d(x, w, None, padding=padding)
    return y if b is None else y + b[:, None, None]


def trunk(sd: dict, x: torch.Tensor, levels, prec: Precision) -> dict:
    """Normalized canvases (B, S, S, 3) -> {level: reduced (B, H, W, C)}."""
    x = x.permute(0, 3, 1, 2)
    taps = {}
    for blk, (_, n) in enumerate(VGG16, start=1):
        for c in range(1, n + 1):
            name = f"backbone.conv{blk}_{c}"
            x = F.relu(_conv(x, sd[name + ".weight"], sd[name + ".bias"],
                             prec, 1))
        if blk >= 3:
            taps[f"c{blk}"] = x
        if blk < 5:
            x = F.max_pool2d(x, 2, 2)
    out = {}
    for lv in levels:
        y = _conv(taps[lv], sd[f"reduce_{lv}.weight"], None, prec, 0)
        y = y.permute(0, 2, 3, 1)
        out[lv] = fp8(y) if prec.fp8 else y.contiguous()
    return out


# --------------------------------------------------------------- pool ---

def window(g: int) -> tuple:
    """Rows and columns that hold every sample of a G-bin view at its
    scale: G + 3, and G + 9 rounded up to 8."""
    return g + 3, -(-(g + 9) // 8) * 8


def n_scales(h: int, w: int, g: int) -> int:
    """Enough 2x scales that the largest view's bins span at most a cell."""
    return max(1, int(math.ceil(math.log2(max(max(h, w) / g, 1.0)))) + 1)


class Stack(NamedTuple):
    """One level's average pyramid, its scales stacked along rows."""

    flat: torch.Tensor   # (B * rows, wmax, C)
    offsets: list        # first row of each scale
    heights: list
    widths: list
    rows: int            # rows of one image's stack
    base: float          # 1 / stride


def pyramid(fmap: torch.Tensor, stride: int, g: int) -> Stack:
    """fmap (B, H, W, C) -> its stacked average pyramid (float32)."""
    b, h, w, c = fmap.shape
    ns = n_scales(h, w, g)
    wy, wx = window(g)
    min_rows = max(wy, 10)
    wmax = max(-(-w // 8) * 8, wx)
    heights, widths, rows = [], [], []
    ch, cw = h, w
    for _ in range(ns):
        heights.append(ch)
        widths.append(cw)
        rows.append(max(ch, min_rows))
        ch, cw = (ch + 1) // 2, (cw + 1) // 2
    offsets = [sum(rows[:i]) for i in range(ns)]
    flat = fmap.new_zeros((b, sum(rows), wmax, c), dtype=torch.float32)
    cur = fmap.float()
    for s in range(ns):
        ch, cw = heights[s], widths[s]
        flat[:, offsets[s]:offsets[s] + ch, :cw] = cur
        if s + 1 == ns:
            break
        ph, pw = ch + ch % 2, cw + cw % 2
        pad = F.pad(cur, (0, 0, 0, pw - cw, 0, ph - ch))
        cnt = torch.zeros((ph, pw), device=fmap.device)
        cnt[:ch, :cw] = 1.0
        tot = pad.reshape(b, ph // 2, 2, pw // 2, 2, c).sum((2, 4))
        n = cnt.reshape(ph // 2, 2, pw // 2, 2).sum((1, 3))
        cur = tot / n[None, :, :, None]
    return Stack(flat.reshape(b * sum(rows), wmax, c), offsets, heights,
                 widths, sum(rows), 1.0 / stride)


def expand(rois: torch.Tensor, f: float, hw) -> torch.Tensor:
    """Boxes scaled by f about their centres, clipped to the canvas."""
    cx = (rois[..., 0] + rois[..., 2]) * 0.5
    cy = (rois[..., 1] + rois[..., 3]) * 0.5
    hw_ = (rois[..., 2] - rois[..., 0]) * f * 0.5
    hh = (rois[..., 3] - rois[..., 1]) * f * 0.5
    return torch.stack([(cx - hw_).clamp(0, hw[1]), (cy - hh).clamp(0, hw[0]),
                        (cx + hw_).clamp(0, hw[1]), (cy + hh).clamp(0, hw[0])],
                       -1)


def view_samples(st: Stack, views: torch.Tensor, g: int, s: int):
    """views (N, 4) canvas coords -> (selected scale (N,), sample rows
    sy (N, G*S) and columns sx (N, G*S) in that scale's cells)."""
    f32 = torch.float32
    dev = views.device
    b = views.to(f32) * st.base
    x1, y1 = b[:, 0], b[:, 1]
    bw = torch.clamp(b[:, 2] - x1, min=1e-6)
    bh = torch.clamp(b[:, 3] - y1, min=1e-6)
    span = torch.maximum(bw, bh) / g
    lvl = torch.clamp(torch.ceil(torch.log2(torch.clamp(span, min=1.0))),
                      0, len(st.heights) - 1).long()
    cell = torch.exp2(lvl.to(f32))[:, None]
    hl = torch.tensor(st.heights, dtype=f32, device=dev)[lvl][:, None]
    wl = torch.tensor(st.widths, dtype=f32, device=dev)[lvl][:, None]
    k = torch.arange(g * s, device=dev)
    off = (k // s).to(f32) + ((k % s).to(f32) + 0.5) / s
    sy = torch.minimum(torch.clamp((y1[:, None] + off * bh[:, None] / g)
                                   / cell, min=0.0), hl - 1.0)
    sx = torch.minimum(torch.clamp((x1[:, None] + off * bw[:, None] / g)
                                   / cell, min=0.0), wl - 1.0)
    return lvl, sy, sx


def pool_level(st: Stack, views: torch.Tensor, img: torch.Tensor, g: int,
               s: int, chunk: int = 2048) -> torch.Tensor:
    """views (N, 4) of images img (N,) on one level -> (N, G, G, C)
    float32: each bin the mean of its S x S bilinear samples."""
    lvl, sy, sx = view_samples(st, views, g, s)
    dev = views.device
    wy, wx = window(g)
    h = torch.tensor(st.heights, device=dev)[lvl]
    w = torch.tensor(st.widths, device=dev)[lvl]
    y0 = torch.minimum(torch.floor(sy[:, 0]).long().clamp(min=0),
                       (h - wy).clamp(min=0))
    x0 = torch.minimum(torch.floor(sx[:, 0]).long().clamp(min=0),
                       (w - wx).clamp(min=0))
    cy = torch.arange(wy, dtype=torch.float32, device=dev)
    cx = torch.arange(wx, dtype=torch.float32, device=dev)
    ay = torch.clamp(1 - torch.abs((sy - y0[:, None])[..., None] - cy), 0)
    ax = torch.clamp(1 - torch.abs((sx - x0[:, None])[..., None] - cx), 0)
    offs = torch.tensor(st.offsets, device=dev)[lvl]
    row0 = img.long() * st.rows + offs + y0
    c = st.flat.shape[-1]
    out = []
    for i in range(0, views.shape[0], chunk):
        sl = slice(i, i + chunk)
        rows = row0[sl, None] + torch.arange(wy, device=dev)
        cols = x0[sl, None] + torch.arange(wx, device=dev)
        win = st.flat[rows[:, :, None], cols[:, None, :]]  # (n, wy, wx, C)
        t = torch.einsum("niy,nyxc->nixc", ay[sl], win)
        v = torch.einsum("nixc,njx->nijc", t, ax[sl])
        n = v.shape[0]
        out.append(v.reshape(n, g, s, g, s, c).mean((2, 4)))
    return torch.cat(out)


def view_plan(model: dict) -> list:
    """[(foveal factors, levels)] in view order."""
    fs, ls = tuple(model["foveal_scales"]), tuple(model["skip_levels"])
    if model["foveal_topology"] == "dense" or len(fs) == 1 or len(ls) == 1:
        return [(fs, ls)]
    return [((fs[0],), ls), (fs[1:], (ls[-1],))]


def pool(model: dict, maps: dict, rois: torch.Tensor, canvas: int):
    """rois (B, R, 4) canvas coords -> (B, F, R, G, G, C) float32."""
    g, s = model["roi_output_size"], model["roi_samples_per_bin"]
    b, r = rois.shape[:2]
    stacks = {lv: pyramid(maps[lv], STRIDES[lv], g) for lv in maps}
    img = torch.arange(b, device=rois.device).repeat_interleave(r)
    out = []
    for factors, levels in view_plan(model):
        for f in factors:
            v = expand(rois, f, (canvas, canvas)).reshape(-1, 4)
            out.append(sum(pool_level(stacks[lv], v, img, g, s)
                           for lv in levels).reshape(b, r, g, g, -1))
    return torch.stack(out, 1)


# --------------------------------------------------------------- head ---

def quantize(x: torch.Tensor, bits: int, dim: int):
    """Symmetric integer codes of x along `dim` (one scale per slice of
    the other axis): (codes as float64, scales float32)."""
    q = float(2 ** (bits - 1) - 1)
    amax = x.float().abs().amax(dim=dim, keepdim=True)
    if dim == -1:   # activations: amax * float32(1 / q)
        sc = torch.clamp(amax * float(np.float32(1.0 / q)), min=1e-12)
    else:           # weights: amax / q
        sc = torch.clamp(amax / q, min=1e-12)
    codes = torch.clamp(torch.round(x.float() / sc), -q, q)
    return codes.double(), sc


def dense(sd: dict, name: str, x: torch.Tensor, bits: int) -> torch.Tensor:
    """Layer `name` of the head on rows x (n, K) -> (n, N) float32."""
    w = sd[name + ".weight"]
    bias = sd.get(name + ".bias")
    if not bits:
        y = x @ w.t()
        return y if bias is None else y + bias
    xc, xs = quantize(x, bits, -1)
    wc, ws = quantize(w, bits, 1)
    acc = xc @ wc.t()                             # exact in float64
    y = acc * (xs.double() * ws.double().t())
    if bias is not None:
        y = y + bias.double()
    return y.float()


def head(sd: dict, model: dict, pooled: torch.Tensor, bits: int,
         rows: int = 2048):
    """pooled (B, F, R, G, G, C) -> (scores (B, R, K, classes), deltas
    (B, R, D)), float32, in blocks of `rows` ROIs."""
    b, f, r = pooled.shape[:3]
    k, ncls = len(model["integral_thresholds"]), model["num_classes"]
    x = pooled.reshape(b, f, r, -1)
    bias = sd["head.skip_bias"].repeat(x.shape[-1] // pooled.shape[-1])
    out = []
    for i in range(0, r, rows):
        xi = x[:, :, i:i + rows]
        n = xi.shape[0] * xi.shape[2]
        branches = []
        for v in range(f):
            h = F.relu(xi[:, v].reshape(n, -1) + bias)
            for fc in (f"fc6_f{v}", f"fc7_f{v}"):
                if "head." + fc + "_u.weight" in sd:
                    h = dense(sd, "head." + fc + "_u", h, bits)
                h = F.relu(dense(sd, "head." + fc, h, bits))
            branches.append(h)
        out.append(dense(sd, "head.cls_bbox", torch.cat(branches, -1),
                         bits).reshape(xi.shape[0], xi.shape[2], -1))
    y = torch.cat(out, 1)
    return y[..., :k * ncls].reshape(b, r, k, ncls), y[..., k * ncls:]


# -------------------------------------------------------------- boxes ---

def decode(rois: torch.Tensor, deltas: torch.Tensor, means, stds):
    """rois (..., 4), deltas (..., 4) -> boxes (..., 4)."""
    d = deltas * torch.tensor(stds, device=deltas.device) + torch.tensor(
        means, device=deltas.device)
    w = torch.clamp(rois[..., 2] - rois[..., 0], min=1e-8)
    h = torch.clamp(rois[..., 3] - rois[..., 1], min=1e-8)
    cx = rois[..., 0] + 0.5 * (rois[..., 2] - rois[..., 0])
    cy = rois[..., 1] + 0.5 * (rois[..., 3] - rois[..., 1])
    px = d[..., 0] * w + cx
    py = d[..., 1] * h + cy
    pw = torch.exp(torch.clamp(d[..., 2], max=BBOX_CLIP)) * w
    ph = torch.exp(torch.clamp(d[..., 3], max=BBOX_CLIP)) * h
    return torch.stack([px - 0.5 * pw, py - 0.5 * ph, px + 0.5 * pw,
                        py + 0.5 * ph], -1)


@torch.no_grad()
def detect_scores(sd: dict, model: dict, canvas: int, images_u8, src_hws,
                  proposals, prec: Precision = Precision()):
    """A batch -> (probs (B, P, classes), boxes (B, P, classes, 4)) in
    source coordinates, before NMS."""
    exact_float32()
    x, scale = canvases(images_u8, src_hws, canvas)
    maps = trunk(sd, x, model["skip_levels"], prec)
    del x
    rois = proposals.float() * scale[:, None, None]
    pooled = pool(model, maps, rois, canvas)
    del maps
    scores, deltas = head(sd, model, pooled, prec.head_bits
                          if model["head_quant"] == "int8" else 0)
    del pooled
    probs = torch.softmax(scores, -1).mean(2)
    b, p, ncls = probs.shape
    if model["class_specific_bbox"]:
        d = deltas.reshape(b, p, ncls, 4)
    else:
        d = deltas[:, :, None, :].expand(b, p, ncls, 4)
    boxes = decode(rois[:, :, None, :], d, model["bbox_reg_means"],
                   model["bbox_reg_stds"])
    lim = src_hws.float() * scale[:, None]
    hi = torch.stack([lim[:, 1], lim[:, 0], lim[:, 1], lim[:, 0]], -1)
    boxes = torch.minimum(boxes.clamp(min=0.0), hi[:, None, None, :])
    return probs, boxes / scale[:, None, None, None]
