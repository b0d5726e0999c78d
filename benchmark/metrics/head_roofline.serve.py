"""The head's share of its roofline: the counted bound of the batch's head
GEMMs (benchmark/counts/multipath.head; operations at int8's peak for the
int8 head) over the device time of the kernels launched inside
MultiPathNet.predict_rois, its rescale and quantize passes included.
Moves img_per_s."""

from benchmark.peaks import bound_s


def read(layer):
    if layer is None or layer["kind"] != "serve":
        return None
    dev = layer["span_device_s"].get("predict_rois")
    if not dev:
        return None
    dtype = "int8" if layer["head_int8"] else "bf16"
    return 100.0 * bound_s(layer["work"]["head"], dtype) / dev
