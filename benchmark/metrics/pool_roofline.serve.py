"""The pool layer's share of its roofline: the counted bound of the
batch's pool (benchmark/counts/multipath.pool: the base-map cells some
view needs read once, the output written once; operations at bf16's peak)
over the device time of the kernels launched inside
MultiPathNet.pool_rois (the pyramids and the pool kernels with their
int8 epilogue). Moves img_per_s."""

from benchmark.peaks import bound_s


def read(layer):
    if layer is None or layer["kind"] != "serve":
        return None
    dev = layer["span_device_s"].get("pool_rois")
    if not dev:
        return None
    return 100.0 * bound_s(layer["work"]["pool"], "bf16") / dev
