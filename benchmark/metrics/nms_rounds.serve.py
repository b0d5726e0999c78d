"""Rounds of ops/nms.nms_sorted's fixpoint a batch (each reads one flag
back from the card): the mean, over the profiled slice's `detect` root
spans, of the change of the nms.rounds counter of
multipathnet_tpu_torch.utils.profiling over the root. Moves img_per_s.
None unless the slice left one root a batch."""


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
    return sum(r["counters"].get("nms.rounds", 0)
               for r in roots) / len(roots)
