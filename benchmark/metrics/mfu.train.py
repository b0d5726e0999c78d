"""The training step's share of the card's bf16 peak: the step's counted
operations (benchmark/counts/multipath.train: the forward of the whole
model and twice it for the backward of the trainable part) over
train_step_ms. Moves train_step_ms."""

from benchmark.peaks import PEAK_OPS


def read(layer):
    if layer is None or layer["kind"] != "train":
        return None
    return 100.0 * layer["work"]["ops"] / PEAK_OPS["bf16"] / layer["step_s"]
