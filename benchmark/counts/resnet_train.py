"""Work of one fine-tuning step of MultiPath on a ResNet-101 trunk, counted
from the published shapes (He et al., arXiv:1512.03385, Table 1,
conv1-conv4_x; benchmark/reference/train_resnet.py) at the cell's canvas,
by the rules of benchmark/counts/multipath.py (a multiply and an add
count two operations; each input byte read once, each output byte
written once).

`train` gives two counts:
- "ops", the step's operations as benchmark/counts/multipath.train
  counts a VGG-16 step (what mfu.train reads): the forward of the whole
  trunk and its reductions (benchmark/counts/resnet.trunk), the float
  head on the sampled ROIs, and twice the forward of the trainable part
  (conv3_x, conv4_x, the reductions, the head) for the backward;
- "trunk" {"ops", "bytes"}, what the trunk's roofline reads: the forward
  of every convolution of the trunk and the reductions, and the backward
  of the training stages' convolutions as computed: each one's weight
  gradient (its forward's operations again) and, where its input carries
  a gradient, its input gradient (again). The first block of the lowest
  training stage reads the frozen stage's detached output, so its first
  1x1 convolution and its projection compute no input gradient. The
  reductions' backward is left out (no span holds it). Bytes: the
  forward's (bf16 weights, float32 canvases in, bf16 reduced maps out)
  plus each training convolution's bf16 weight read and float32 weight
  gradient written once.
"""

from __future__ import annotations

from benchmark.counts import multipath, resnet
from benchmark.counts.multipath import BF16, F32
from benchmark.reference.multipath_resnet import STAGES


def convs(model: dict, canvas: int):
    """(stage, reads the stage's input, multiply-adds a canvas, weights)
    of every convolution of the trunk, stem (stage 1) first."""
    side = canvas // 2
    yield 1, True, side * side * 3 * 64 * 49, 3 * 64 * 49
    side //= 2                   # the max-pool
    cin, f = 64, 64
    for stage, blocks in enumerate(STAGES[model["backbone"]], start=2):
        for i in range(blocks):
            stride = 2 if stage > 2 and i == 0 else 1
            yield stage, i == 0, side * side * cin * f, cin * f
            side //= stride      # the stride sits on the 3x3
            yield stage, False, side * side * f * f * 9, f * f * 9
            yield stage, False, side * side * f * 4 * f, f * 4 * f
            if i == 0:
                yield stage, True, side * side * cin * 4 * f, cin * 4 * f
            cin = 4 * f
        f *= 2


def reductions(model: dict, canvas: int) -> int:
    """Multiply-adds a canvas of the 1x1 reductions of the taps: c3, c4
    and c5 at strides 4, 8 and 16 with 256, 512 and 1024 channels."""
    red = model["skip_reduce_dim"]
    return sum((canvas // (4 << i)) ** 2 * (256 << i) * red
               for i in range(len(STAGES[model["backbone"]]))
               if f"c{i + 3}" in model["skip_levels"])


def train(model: dict, canvas: int, batch: int, rows: int,
          frozen: int) -> dict:
    """One step of `batch` canvases with `rows` sampled ROIs, the stages
    1..frozen frozen (stage 1 the stem)."""
    fwd = resnet.trunk(model, canvas, batch)
    head = multipath.head(dict(model, head_quant="none"), rows)["ops"]
    part = sum(m for s, _, m, _ in convs(model, canvas) if s > frozen)
    part = 2 * batch * (part + reductions(model, canvas))
    back, grad_weights = 0, 0
    for stage, reads_input, macs, weights in convs(model, canvas):
        if stage <= frozen:
            continue
        lowest = stage == frozen + 1
        back += macs * (1 if lowest and reads_input else 2)
        grad_weights += weights
    return {"ops": fwd["ops"] + head + 2 * (part + head),
            "trunk": {"ops": fwd["ops"] + 2 * batch * back,
                      "bytes": fwd["bytes"] + grad_weights * (BF16 + F32)}}
