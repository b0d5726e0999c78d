"""Device milliseconds a step of the optimizer (train/schedule.Optimizer.
step: the gradient norm and SGD's multi-tensor passes): the mean, over the
profiled slice's `train.step` root spans, of the device interval of the
program's span train.optimizer under each root
(multipathnet_tpu_torch.utils.profiling: a pair of timing events on the
stream, so idle time inside the span counts). Moves train_step_ms. None
unless the slice left one root a step, each holding the span with its
device interval."""


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
              if s["name"] == "train.optimizer"]
        if not ms or any(m is None for m in ms):
            return None
        total += sum(ms)
    return total / len(roots)
