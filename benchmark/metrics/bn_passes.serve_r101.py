"""Frozen BatchNorm passes a batch (models/layers.FrozenBatchNorm, each a
separate float32 pass over a convolution's output): the mean, over the
profiled slice's `detect` root spans, of the change of the bn.passes
counter of multipathnet_tpu_torch.utils.profiling over the root. 94 a
ResNet-101 batch while the BatchNorms run apart from the convolutions; a
fold into them drives it to 0. Moves img_per_s. None where the program
keeps no such counter, or unless the slice left one root a batch."""


def read(layer):
    if layer is None or layer["kind"] != "serve":
        return None
    from multipathnet_tpu_torch.utils import profiling

    records = getattr(profiling, "records", None)
    if records is None or "bn.passes" not in profiling.counters():
        return None
    roots = [r for r in records() if r["name"] == "detect"]
    if not roots or len(roots) != layer["batches"]:
        return None
    return sum(r["counters"].get("bn.passes", 0)
               for r in roots) / len(roots)
