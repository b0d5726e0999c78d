"""Share of a served batch in which nothing ran on the device:
100 * (1 - busy / batch_s), busy the device's busy seconds a batch in the
profiled slice (the union of every kernel, copy and set; benchmark/
trace.py) and batch_s the untraced window's seconds a batch, so the
profiler's own host cost does not count as idle. Moves img_per_s."""


def read(layer):
    if layer is None or layer["kind"] != "serve" or not layer["busy_s"]:
        return None
    return 100.0 * (1.0 - layer["busy_s"] / layer["batches"]
                    / layer["batch_s"])
