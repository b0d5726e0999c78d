"""Work of MultiPath VGG-16 detection, counted from the cell's shapes.

Every count is of what the computation needs, whatever kernel computes
it: each input byte read once, each output byte written once, operations
of the plainest form of the arithmetic (a multiply and an add count two).
The pool's count depends on the proposals, so it is made from the batch
with the reference's geometry.
"""

from __future__ import annotations

import torch

from benchmark.reference import multipath as ref

BF16, INT8, F32 = 2, 1, 4


def trunk(model: dict, canvas: int, batch: int, first_block: int = 1) -> dict:
    """The 13 convolutions (those of blocks first_block..5) and the 1x1
    reductions of `batch` canvases: bf16 operands, float32 canvases in,
    the reduced maps out in bf16."""
    ops, weights, side, cin = 0, 0, canvas, 3
    outs = {}
    for blk, (ch, n) in enumerate(ref.VGG16, start=1):
        for _ in range(n):
            if blk >= first_block:
                ops += 2 * side * side * cin * ch * 9
                weights += cin * ch * 9 + ch
            cin = ch
        if blk >= 3:
            outs[f"c{blk}"] = (side, ch)
        if blk < 5:
            side //= 2
    red = model["skip_reduce_dim"]
    out_bytes = 0
    for lv in model["skip_levels"]:
        s, c = outs[lv]
        ops += 2 * s * s * c * red
        weights += c * red
        out_bytes += s * s * red * BF16
    return {"ops": batch * ops,
            "bytes": weights * BF16 + batch * (canvas * canvas * 3 * F32
                                               + out_bytes)}


def head(model: dict, rows: int) -> dict:
    """The head's GEMMs on `rows` ROIs: fc6 and fc7 a view (factored where
    the configuration gives a rank) and the classifier and box layer;
    int8 weights and input codes, bf16 output, where head_quant is int8
    (else bf16 throughout)."""
    g, c = model["roi_output_size"], model["skip_reduce_dim"]
    views = len(model["foveal_scales"])
    fc = model["fc_dim"]
    w_b = INT8 if model["head_quant"] == "int8" else BF16
    macs, weights = 0, 0
    for k, rank in ((g * g * c, model["fc6_rank"]), (fc, model["fc7_rank"])):
        shape = ((k, rank), (rank, fc)) if rank else ((k, fc),)
        for i, o in shape:
            macs += views * i * o
            weights += views * i * o
    ncls = model["num_classes"]
    out = len(model["integral_thresholds"]) * ncls + 4 * (
        ncls if model["class_specific_bbox"] else 1)
    macs += views * fc * out
    weights += views * fc * out
    inputs = rows * views * (g * g * c * w_b + (F32 if w_b == INT8 else 0))
    return {"ops": 2 * rows * macs,
            "bytes": weights * w_b + inputs + rows * out * BF16}


def _union_cells(regions: torch.Tensor, img: torch.Tensor, batch: int,
                 side: int) -> int:
    """Base cells under any of the rectangles regions (N, 4) = (y0, y1,
    x0, x1), half open, each in image img (N,) of side x side cells."""
    dev = regions.device
    grid = torch.zeros((batch, side + 1, side + 1), dtype=torch.int32,
                       device=dev)
    y0, y1, x0, x1 = regions.unbind(1)
    one = torch.ones_like(y0, dtype=torch.int32)
    for yy, xx, sign in ((y0, x0, 1), (y0, x1, -1), (y1, x0, -1),
                         (y1, x1, 1)):
        grid.index_put_((img, yy, xx), sign * one, accumulate=True)
    cover = grid.cumsum(1).cumsum(2)[:, :side, :side]
    return int((cover > 0).sum())


@torch.no_grad()
def pool(model: dict, canvas: int, rois: torch.Tensor) -> dict:
    """The pool of one batch, rois (B, R, 4) in canvas coordinates: the
    base-map cells (bf16, reduced width) that some view's bilinear
    samples need, read once; the output codes and scales (or bf16 pooled
    values) written once; the proposals read once. Operations: a view's
    S x S samples folded into its bin weights, then the two separable
    contractions over the cells its samples touch,
    2 G C (rows x cols) + 2 G^2 C cols, a view and level."""
    g, s = model["roi_output_size"], model["roi_samples_per_bin"]
    c = model["skip_reduce_dim"]
    b, r = rois.shape[:2]
    img = torch.arange(b, device=rois.device).repeat_interleave(r)
    ops, cells = 0, 0
    per_level = {lv: [] for lv in model["skip_levels"]}
    for factors, levels in ref.view_plan(model):
        for f in factors:
            v = ref.expand(rois.float(), f, (canvas, canvas)).reshape(-1, 4)
            for lv in levels:
                per_level[lv].append(v)
    for lv, vs in per_level.items():
        if not vs:
            continue
        side = canvas // ref.STRIDES[lv]
        hs, h = [], side
        for _ in range(ref.n_scales(side, side, g)):
            hs.append(h)
            h = (h + 1) // 2
        st = ref.Stack(None, [], hs, hs, 0, 1.0 / ref.STRIDES[lv])
        views = torch.cat(vs)
        lvl, sy, sx = ref.view_samples(st, views, g, s)
        y_lo, y_hi = sy.floor().amin(1), sy.floor().amax(1) + 1
        x_lo, x_hi = sx.floor().amin(1), sx.floor().amax(1) + 1
        hl = torch.tensor(hs, device=views.device, dtype=torch.float32)[lvl]
        y_hi = torch.minimum(y_hi, hl - 1)
        x_hi = torch.minimum(x_hi, hl - 1)
        rows, cols = y_hi - y_lo + 1, x_hi - x_lo + 1
        ops += int((2 * g * c * rows * cols + 2 * g * g * c * cols).sum())
        cell = torch.exp2(lvl.float())
        reg = torch.stack([y_lo * cell, (y_hi + 1) * cell, x_lo * cell,
                           (x_hi + 1) * cell], 1).clamp(max=side).long()
        cells += _union_cells(reg, img.repeat(len(vs)), b, side)
    out_b = INT8 if model["head_quant"] == "int8" else BF16
    n_out = b * r * len(model["foveal_scales"])
    return {"ops": ops,
            "bytes": cells * c * BF16 + n_out * (g * g * c * out_b + (
                F32 if out_b == INT8 else 0)) + b * r * 4 * F32}


def train(model: dict, canvas: int, batch: int, rows: int,
          frozen: int) -> dict:
    """Operations of one training step: the forward of the whole model
    (trunk, reduce, the float head on `rows` sampled ROIs) and the
    backward, twice the forward, of the trainable part (blocks frozen+1..5,
    reduce, head). The pool, a fraction of a percent of it, is left out."""
    full = trunk(model, canvas, batch)["ops"]
    part = trunk(model, canvas, batch, frozen + 1)["ops"]
    fhead = head(dict(model, head_quant="none"), rows)["ops"]
    return {"ops": full + fhead + 2 * (part + fhead)}
