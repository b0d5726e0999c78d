"""Host-clock milliseconds a batch inside ops.nms.multiclass_nms, over the
untraced window of the traced run: its per-class top-k, its fixpoint
rounds and their host syncs. Moves img_per_s."""


def read(layer):
    if layer is None or layer["kind"] != "serve":
        return None
    return layer["nms_ms"]
