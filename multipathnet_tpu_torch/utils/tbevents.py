"""Self-contained TensorBoard event-file writer/reader (no TensorFlow) —
the port's copy of multipathnet_tpu/utils/tbevents.py, held byte-equal to
it by tests/test_torch_tbevents.py (the golden bytes, and files written by
each package read back by the other).

`utils/metrics.MetricsLogger(tensorboard_dir=...)` writes through it.

Format: a ``tfevents`` file is a TFRecord stream —

    uint64  length (little-endian)
    uint32  masked CRC32C of the 8 length bytes
    bytes   payload (an ``Event`` protobuf)
    uint32  masked CRC32C of the payload

— where CRC32C is the Castagnoli CRC (poly 0x82F63B78, reflected) and
``mask(c) = ((c >> 15 | c << 17) + 0xa282ead8) mod 2^32``. The first
record is ``Event{file_version: "brain.Event:2"}``; scalar records are
``Event{wall_time, step, summary: Summary{value: [Value{tag,
simple_value}]}}``. ``simple_value`` is the classic scalar encoding, which
TensorBoard reads natively.

Only the three proto fields above are encoded/decoded; this is not a
general protobuf implementation.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Iterator, Tuple

# -- CRC32C (Castagnoli), table-driven ---------------------------------------

_CRC_TABLE = []
for _n in range(256):
    _c = _n
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = _crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- minimal proto encode ------------------------------------------------------


def _varint(n: int) -> bytes:
    # Negative ints would loop forever (Python's >> never reaches 0) and
    # proto int64 negatives need 10-byte two's-complement anyway; no caller
    # here ever has one, so fail loudly instead of hanging.
    if n < 0:
        raise ValueError(f"_varint requires n >= 0, got {n}")
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _len_field(field_num: int, payload: bytes) -> bytes:
    return bytes([(field_num << 3) | 2]) + _varint(len(payload)) + payload


def encode_scalar_event(step: int, wall_time: float,
                        scalars: Dict[str, float]) -> bytes:
    """``Event`` proto bytes for one step's scalar dict."""
    values = b""
    for tag, v in scalars.items():
        val = (_len_field(1, tag.encode("utf-8"))
               + b"\x15" + struct.pack("<f", float(v)))  # simple_value = 2
        values += _len_field(1, val)  # Summary.value (repeated) = 1
    ev = (b"\x09" + struct.pack("<d", float(wall_time))  # wall_time = 1
          + b"\x10" + _varint(int(step))                 # step = 2
          + _len_field(5, values))                       # summary = 5
    return ev


def _encode_version_event(wall_time: float) -> bytes:
    return (b"\x09" + struct.pack("<d", float(wall_time))
            + _len_field(3, b"brain.Event:2"))  # file_version = 3


def _record(payload: bytes) -> bytes:
    hdr = struct.pack("<Q", len(payload))
    return (hdr + struct.pack("<I", _masked_crc(hdr))
            + payload + struct.pack("<I", _masked_crc(payload)))


class EventFileWriter:
    """Append-only scalar writer; one ``events.out.tfevents.*`` per instance.

    ``now`` is injectable so tests can pin byte-exact goldens.
    """

    def __init__(self, logdir: str, now=time.time):
        os.makedirs(logdir, exist_ok=True)
        self._now = now
        name = (f"events.out.tfevents.{int(now())}."
                f"{socket.gethostname()}.mpn")
        self.path = os.path.join(logdir, name)
        self._f = open(self.path, "ab", buffering=0)
        self._f.write(_record(_encode_version_event(now())))

    def add_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        self._f.write(_record(encode_scalar_event(step, self._now(),
                                                  scalars)))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


# -- minimal proto decode (for tests / offline inspection) --------------------


def _iter_fields(buf: bytes) -> Iterator[Tuple[int, int, bytes]]:
    i = 0
    while i < len(buf):
        key, shift = 0, 0
        while True:
            b = buf[i]
            i += 1
            key |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, shift = 0, 0
            while True:
                b = buf[i]
                i += 1
                v |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            yield field, wire, _varint(v)
        elif wire == 1:
            yield field, wire, buf[i:i + 8]
            i += 8
        elif wire == 5:
            yield field, wire, buf[i:i + 4]
            i += 4
        elif wire == 2:
            ln, shift = 0, 0
            while True:
                b = buf[i]
                i += 1
                ln |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            yield field, wire, buf[i:i + ln]
            i += ln
        else:  # pragma: no cover - groups never written
            raise ValueError(f"unsupported wire type {wire}")


def _decode_varint(raw: bytes) -> int:
    v, shift = 0, 0
    for b in raw:
        v |= (b & 0x7F) << shift
        shift += 7
    return v


def read_scalars(path: str, verify_crc: bool = True
                 ) -> Dict[str, Dict[int, float]]:
    """{tag: {step: value}} from one event file (CRC-checked framing)."""
    out: Dict[str, Dict[int, float]] = {}
    with open(path, "rb") as f:
        data = f.read()
    i = 0
    while i < len(data):
        hdr = data[i:i + 8]
        (ln,) = struct.unpack("<Q", hdr)
        if verify_crc:
            (hc,) = struct.unpack("<I", data[i + 8:i + 12])
            if hc != _masked_crc(hdr):
                raise ValueError(f"length CRC mismatch at offset {i}")
        payload = data[i + 12:i + 12 + ln]
        if verify_crc:
            (pc,) = struct.unpack("<I", data[i + 12 + ln:i + 16 + ln])
            if pc != _masked_crc(payload):
                raise ValueError(f"payload CRC mismatch at offset {i}")
        i += 16 + ln
        step, summary = 0, None
        for field, wire, raw in _iter_fields(payload):
            if field == 2 and wire == 0:
                step = _decode_varint(raw)
            elif field == 5 and wire == 2:
                summary = raw
        if summary is None:
            continue
        for field, wire, raw in _iter_fields(summary):
            if field != 1 or wire != 2:
                continue
            tag, val = None, None
            for f2, w2, r2 in _iter_fields(raw):
                if f2 == 1 and w2 == 2:
                    tag = r2.decode("utf-8")
                elif f2 == 2 and w2 == 5:
                    (val,) = struct.unpack("<f", r2)
            if tag is not None and val is not None:
                out.setdefault(tag, {})[step] = val
    return out
