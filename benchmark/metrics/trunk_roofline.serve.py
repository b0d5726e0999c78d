"""The trunk's share of its roofline: the counted bound of the batch's
VGG-16 convolutions and 1x1 reductions (benchmark/counts/multipath.trunk;
operations at bf16's peak) over the device time of the kernels launched
inside MultiPathNet.features. Moves img_per_s."""

from benchmark.peaks import bound_s


def read(layer):
    if layer is None or layer["kind"] != "serve":
        return None
    dev = layer["span_device_s"].get("features")
    if not dev:
        return None
    return 100.0 * bound_s(layer["work"]["trunk"], "bf16") / dev
