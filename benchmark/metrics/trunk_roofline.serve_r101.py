"""The ResNet-101 trunk's share of its roofline: the counted bound of the
batch's stem, bottleneck and 1x1 reduction convolutions
(benchmark/counts/resnet.trunk; operations at bf16's peak) over the device
time of the kernels launched inside MultiPathNet.features, those inside
its stage spans features.stem and features.stage2..4 (ResNet.forward)
included. Moves img_per_s."""

from benchmark.peaks import bound_s


def read(layer):
    if layer is None or layer["kind"] != "serve":
        return None
    dev = sum(v for k, v in layer["span_device_s"].items()
              if k == "features" or k.startswith("features."))
    if not dev:
        return None
    return 100.0 * bound_s(layer["work"]["trunk"], "bf16") / dev
