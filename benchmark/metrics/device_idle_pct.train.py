"""Share of a training step in which nothing ran on the device:
100 * (1 - busy / step_s), busy the device's busy seconds a step in the
profiled slice (the union of every kernel, copy and set; benchmark/
trace.py) and step_s the untraced window's seconds a step, so the
profiler's own host cost does not count as idle. Moves train_step_ms."""


def read(layer):
    if layer is None or layer["kind"] != "train" or not layer["busy_s"]:
        return None
    return 100.0 * (1.0 - layer["busy_s"] / layer["steps"]
                    / layer["step_s"])
