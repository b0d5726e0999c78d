"""The ResNet-101 trunk's share of its roofline in a training step: the
counted bound of the step's trunk work (benchmark/counts/resnet_train.
train's "trunk": the forward of the stem, the bottlenecks and the 1x1
reductions, and the backward of conv3_x's and conv4_x's convolutions,
each one's weight gradient and, where its input carries one, its input
gradient; operations at bf16's peak) over the device time, a step, of the
kernels launched inside the forward span features with its children
features.stem and features.stage2..4 (ResNet.forward), and inside the
backward spans features.stage3.backward and features.stage4.backward
(ResNet._BackwardSpans). The reductions' backward runs outside those
spans and is counted out with them. Moves train_step_ms. None unless the
slice holds the backward spans (a program without them)."""

from benchmark.peaks import bound_s


def read(layer):
    if (layer is None or layer["kind"] != "train"
            or "span_device_s" not in layer):
        return None
    spans = layer["span_device_s"]
    if not any(k.startswith("features.") and k.endswith(".backward")
               for k in spans):
        return None
    dev = sum(v for k, v in spans.items()
              if k == "features" or k.startswith("features."))
    return 100.0 * bound_s(layer["work"]["trunk"], "bf16") / dev
