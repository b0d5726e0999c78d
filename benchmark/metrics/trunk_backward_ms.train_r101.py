"""Device milliseconds a step of the ResNet trunk's backward: the mean,
over the profiled slice's `train.step` root spans, of the summed device
intervals of the program's spans features.stage3.backward and
features.stage4.backward under each root (models/backbones/resnet.py:
a pair of timing events on autograd's stream, opened when a stage's
output gradient is whole and closed when its input's, or its
parameters', gradients are; idle time inside a span counts). The
reductions' backward is outside them. Moves train_step_ms. None unless
the slice left one root a step, each holding the spans with their device
intervals."""


def read(layer):
    if layer is None or layer["kind"] != "train":
        return None
    from multipathnet_tpu_torch.utils import profiling

    records = getattr(profiling, "records", None)
    if records is None:
        return None
    roots = [r for r in records() if r["name"] == "train.step"]
    if not roots or len(roots) != layer["steps"]:
        return None
    total = 0.0
    for root in roots:
        ms = [s["device_ms"] for s in profiling.walk(root)
              if s["name"].startswith("features.")
              and s["name"].endswith(".backward")]
        if not ms or any(m is None for m in ms):
            return None
        total += sum(ms)
    return total / len(roots)
