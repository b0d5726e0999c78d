"""Blocking waits of the host on the card a batch: the mean, over the
profiled slice's `detect` root spans, of the change of every sync.<site>
counter of multipathnet_tpu_torch.utils.profiling over the root (the
inputs' puts, constant uploads, NMS's rounds, the outputs' fetches).
Moves img_per_s. None unless the slice left one root a batch."""


def read(layer):
    if layer is None or layer["kind"] != "serve":
        return None
    from multipathnet_tpu_torch.utils import profiling

    records = getattr(profiling, "records", None)
    if records is None:
        return None
    roots = [r for r in records() if r["name"] == "detect"]
    if not roots or len(roots) != layer["batches"]:
        return None
    return sum(v for r in roots for k, v in r["counters"].items()
               if k.startswith("sync.")) / len(roots)
