"""Device milliseconds a step of the pool's backward (ops/roi_pool.py: K3
and K4 with their plain ops): the mean, over the profiled slice's
`train.step` root spans, of the summed device intervals of the program's
spans pool_rois.backward under each root (multipathnet_tpu_torch.utils.
profiling: a pair of timing events on the stream, so idle time inside a
span counts; the windows are checked before the span opens, so no wait of
the host for the card falls inside it). Moves train_step_ms. None unless
the slice left one root a step, each holding the span with its device
interval."""


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
              if s["name"] == "pool_rois.backward"]
        if not ms or any(m is None for m in ms):
            return None
        total += sum(ms)
    return total / len(roots)
