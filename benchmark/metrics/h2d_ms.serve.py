"""Device milliseconds a batch of the work launched inside the program's
span detect.put (eval/detect.Detector: the inputs' synchronous copies from
pageable host memory, core/device.put), from the profiled slice's trace.
Moves img_per_s."""


def read(layer):
    if layer is None or layer["kind"] != "serve":
        return None
    dev = layer["span_device_s"].get("detect.put")
    if not dev:
        return None
    return 1e3 * dev
