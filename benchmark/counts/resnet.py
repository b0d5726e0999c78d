"""Work of a ResNet-101 trunk and its 1x1 reductions, counted from the
published shapes (He et al., arXiv:1512.03385, Table 1, conv1-conv4_x;
benchmark/reference/multipath_resnet.py) at the cell's canvas.

As in benchmark/counts/multipath.py: each input byte read once, each
output byte written once, a multiply and an add counted as two
operations. The frozen BatchNorms, ReLUs, residual sums and the max-pool
are elementwise and counted as no operations; the bytes are the bf16
weights, the float32 canvases in and the bf16 reduced maps out.
"""

from __future__ import annotations

from benchmark.counts.multipath import BF16, F32
from benchmark.reference.multipath_resnet import STAGES


def trunk(model: dict, canvas: int, batch: int) -> dict:
    """The stem, the bottlenecks of conv2_x..conv4_x (projections
    included) and the reductions of `batch` canvases."""
    macs = 0     # a canvas's multiply-adds
    weights = 0

    def conv(side, cin, cout, k):
        nonlocal macs, weights
        macs += side * side * cin * cout * k * k
        weights += cin * cout * k * k

    side = canvas // 2
    conv(side, 3, 64, 7)
    side //= 2                   # the max-pool
    cin, f = 64, 64
    outs = {}
    for stage, blocks in enumerate(STAGES[model["backbone"]], start=2):
        for i in range(blocks):
            stride = 2 if stage > 2 and i == 0 else 1
            conv(side, cin, f, 1)
            side //= stride      # the stride sits on the 3x3
            conv(side, f, f, 3)
            conv(side, f, 4 * f, 1)
            if i == 0:
                conv(side, cin, 4 * f, 1)
            cin = 4 * f
        outs[f"c{stage + 1}"] = (side, cin)
        f *= 2
    red = model["skip_reduce_dim"]
    out_bytes = 0
    for lv in model["skip_levels"]:
        s, c = outs[lv]
        conv(s, c, red, 1)
        out_bytes += s * s * red * BF16
    return {"ops": 2 * batch * macs,
            "bytes": weights * BF16 + batch * (canvas * canvas * 3 * F32
                                               + out_bytes)}
