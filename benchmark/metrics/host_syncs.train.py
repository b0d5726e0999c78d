"""Blocking waits of the host on the card a step: the mean, over the
profiled slice's `train.step` root spans, of the change of every
sync.<site> counter of multipathnet_tpu_torch.utils.profiling over the
root (the batch's puts, the flip's widths, constant uploads, the pool
backward's window checks). Moves train_step_ms. None unless the slice
left one root a step."""


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
    return sum(v for r in roots for k, v in r["counters"].items()
               if k.startswith("sync.")) / len(roots)
