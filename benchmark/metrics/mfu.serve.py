"""The serving step's share of the card's peak: the batch's counted
operations (benchmark/counts/multipath.py) as time at their peaks (trunk
and pool at bf16's, the int8 head at int8's), summed, over the untraced
window's seconds a batch. Moves img_per_s."""

from benchmark.peaks import PEAK_OPS


def read(layer):
    if layer is None or layer["kind"] != "serve":
        return None
    w = layer["work"]
    head = "int8" if layer["head_int8"] else "bf16"
    t = (w["trunk"]["ops"] / PEAK_OPS["bf16"]
         + w["pool"]["ops"] / PEAK_OPS["bf16"]
         + w["head"]["ops"] / PEAK_OPS[head])
    return 100.0 * t / layer["batch_s"]
