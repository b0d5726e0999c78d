"""The port's TensorBoard event files (utils/tbevents.py) against the JAX
package's: the wire format byte for byte, the masked CRC32C test vector,
files written by each package read back by the other, and
MetricsLogger(tensorboard_dir=) writing them."""

import os
import struct

import pytest

from multipathnet_tpu.utils import tbevents as jtb
from multipathnet_tpu.utils.metrics import MetricsLogger as JMetricsLogger
from multipathnet_tpu_torch.utils import tbevents
from multipathnet_tpu_torch.utils.metrics import MetricsLogger


def test_tbevents_byte_golden():
    """tests/test_profiling.py's golden: one scalar event at a fixed wall
    time, byte for byte, and crc32c(b"123456789") == 0xE3069283 under the
    mask."""
    ev = tbevents.encode_scalar_event(3, 1700000000.0, {"loss": 1.5})
    want = (b"\x09" + struct.pack("<d", 1700000000.0)      # wall_time = 1
            + b"\x10\x03"                                  # step = 2 (3)
            + b"\x2a\x0d"                                  # summary = 5
            + b"\x0a\x0b"                                  # Summary.value
            + b"\x0a\x04loss"                              # Value.tag
            + b"\x15" + struct.pack("<f", 1.5))            # simple_value
    assert ev == want, ev.hex()
    crc = tbevents._masked_crc(b"123456789")
    c = (crc - 0xA282EAD8) & 0xFFFFFFFF
    unmasked = ((c << 15) | (c >> 17)) & 0xFFFFFFFF
    assert unmasked == 0xE3069283, hex(unmasked)


@pytest.mark.parametrize("step", [0, 1, 127, 128, 300, 2**40])
def test_encoding_equals_reference(step):
    """Events, records and varints equal the JAX package's bytes, across
    the varint's byte boundaries and with several tags."""
    scalars = {"loss": 0.25, "lr": 1e-3, "grad_norm": 12345.678,
               "tag/with/slash": -3.0}
    assert (tbevents.encode_scalar_event(step, 1700000123.5, scalars)
            == jtb.encode_scalar_event(step, 1700000123.5, scalars))
    assert tbevents._varint(step) == jtb._varint(step)
    payload = tbevents.encode_scalar_event(step, 1.0, scalars)
    assert tbevents._record(payload) == jtb._record(payload)
    with pytest.raises(ValueError):
        tbevents._varint(-1)


def _write(writer_cls, logdir, rows):
    clock = iter(1700000000.0 + i for i in range(100))
    w = writer_cls(str(logdir), now=lambda: next(clock))
    for step, scalars in rows:
        w.add_scalars(step, scalars)
    w.close()
    return w.path


ROWS = [(1, {"loss": 2.5, "lr": 0.01}), (2, {"loss": 2.0}),
        (10, {"loss": 1.25, "AP50": 0.5})]


def test_files_read_across_packages(tmp_path):
    """A file the port writes is the reference's byte for byte at the same
    clock and reads back with the reference's read_scalars; a file the
    reference writes reads back with the port's."""
    ours = _write(tbevents.EventFileWriter, tmp_path / "port", ROWS)
    theirs = _write(jtb.EventFileWriter, tmp_path / "ref", ROWS)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    want = {"loss": {1: 2.5, 2: 2.0, 10: 1.25},
            "lr": {1: pytest.approx(0.01)}, "AP50": {10: 0.5}}
    assert jtb.read_scalars(ours) == want
    assert tbevents.read_scalars(theirs) == want


def test_read_scalars_checks_crc(tmp_path):
    path = _write(tbevents.EventFileWriter, tmp_path, ROWS)
    data = bytearray(open(path, "rb").read())
    data[-6] ^= 0xFF                      # inside the last payload
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        tbevents.read_scalars(path)
    assert tbevents.read_scalars(path, verify_crc=False)["loss"][1] == 2.5


def test_metrics_logger_tensorboard_export(tmp_path):
    """MetricsLogger(tensorboard_dir=) writes one event file whose scalars
    equal the reference logger's on the same rows; non-numeric values go
    to the JSONL row only."""
    def run(cls, sub):
        tb = str(tmp_path / sub)
        m = cls(str(tmp_path / f"{sub}.jsonl"), echo=False,
                tensorboard_dir=tb)
        m.log(1, loss=2.5, lr=0.01, tag="interim")
        m.log(2, loss=2.0, lr=0.01)
        m.flush()
        m.close()
        files = [f for f in os.listdir(tb) if "tfevents" in f]
        assert len(files) == 1, files
        return tbevents.read_scalars(os.path.join(tb, files[0]))

    seen = run(MetricsLogger, "port")
    assert seen == run(JMetricsLogger, "ref")
    assert seen["loss"] == {1: 2.5, 2: 2.0} and "tag" not in seen
    assert abs(seen["lr"][1] - 0.01) < 1e-7
