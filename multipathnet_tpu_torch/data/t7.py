"""Read-only Torch7 `.t7` deserializer — port of multipathnet_tpu/data/t7.py
(numpy only, no card work), so the port reads the reference's released
artifacts (whole nn-module checkpoints, proposal `.t7` files) with no
torch7/torchfile dependency.

The Torch7 binary serialization format (torch7 File.lua / serialization
docs) is a stream of typed records, little-endian:

    int32 type tag:
      0 nil | 1 number | 2 string | 3 table | 4 torch object | 5 boolean
      6 function | 7 legacy-recur-function | 8 recur-function
    number  -> float64
    string  -> int32 length + raw bytes
    boolean -> int32 (1 = true)
    table   -> int32 heap index (re-referenced objects are memoized), then
               int32 pair count, then count x (key record, value record)
    torch   -> int32 heap index, then a version string record ("V <n>"; a
               bare class name in pre-versioning files), then the class name
               string record (when versioned), then class-specific payload:
        torch.*Tensor  : int32 ndim, ndim longs sizes, ndim longs strides,
                         long storageOffset (1-based), storage record
                         (nDimension goes through THFile writeInt — 4
                         bytes — while sizes/strides/offset are longs;
                         torchfile's read_int/read_long_array split
                         mirrors this)
        torch.*Storage : long size, size x element bytes
        anything else  : one record (a table) holding the object's __dict__
    function -> int32 heap index, int32 dump size + bytes, upvalues table
               (the bytecode is Lua; we keep the raw bytes, unexecuted)

"long" is 8 bytes in standard torch builds (`long_size=4` covers 32-bit
writers). Tensors materialize as numpy arrays through the stride/offset map
(negative or overlapping strides are handled by numpy's as_strided + copy).

Security note: unlike pickle, this format has no code execution on load —
function records are kept as inert bytes.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

TYPE_NIL = 0
TYPE_NUMBER = 1
TYPE_STRING = 2
TYPE_TABLE = 3
TYPE_TORCH = 4
TYPE_BOOLEAN = 5
TYPE_FUNCTION = 6
TYPE_LEGACY_RECUR_FUNCTION = 7
TYPE_RECUR_FUNCTION = 8

_TENSOR_DTYPES = {
    "torch.DoubleTensor": np.float64, "torch.FloatTensor": np.float32,
    "torch.HalfTensor": np.float16, "torch.LongTensor": np.int64,
    "torch.IntTensor": np.int32, "torch.ShortTensor": np.int16,
    "torch.CharTensor": np.int8, "torch.ByteTensor": np.uint8,
    # CUDA tensors appear in GPU-saved checkpoints; payload layout matches
    "torch.CudaTensor": np.float32, "torch.CudaDoubleTensor": np.float64,
    "torch.CudaHalfTensor": np.float16, "torch.CudaLongTensor": np.int64,
    "torch.CudaIntTensor": np.int32, "torch.CudaByteTensor": np.uint8,
}
_STORAGE_DTYPES = {k.replace("Tensor", "Storage"): v
                   for k, v in _TENSOR_DTYPES.items()}


@dataclass
class T7Object:
    """A deserialized non-tensor torch class instance: `obj.name` is the
    class (e.g. "nn.Linear"), `obj.fields` its __dict__ (string keys
    normalized to str). Index access falls through to fields."""

    name: str
    version: int = 0
    fields: dict = field(default_factory=dict)

    def __getitem__(self, k):
        return self.fields[k]

    def __contains__(self, k):
        return k in self.fields

    def get(self, k, default=None):
        return self.fields.get(k, default)

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"T7Object({self.name}, fields={sorted(self.fields)})"


@dataclass
class T7Function:
    """Inert Lua function record (bytecode kept, never executed)."""

    dump: bytes
    upvalues: object = None


class _Reader:
    def __init__(self, data: bytes, long_size: int = 8):
        self.data = data
        self.pos = 0
        self.longfmt = "<q" if long_size == 8 else "<i"
        self.long_size = long_size
        self.memo: dict = {}

    def _unpack(self, fmt, size):
        v = struct.unpack_from(fmt, self.data, self.pos)[0]
        self.pos += size
        return v

    def read_int(self) -> int:
        return self._unpack("<i", 4)

    def read_long(self) -> int:
        return self._unpack(self.longfmt, self.long_size)

    def read_double(self) -> float:
        return self._unpack("<d", 8)

    def read_bytes(self, n: int) -> bytes:
        b = self.data[self.pos:self.pos + n]
        if len(b) != n:
            raise ValueError(f"truncated .t7: wanted {n} bytes at "
                             f"{self.pos}, file has {len(self.data)}")
        self.pos += n
        return b

    def read_string(self) -> str:
        n = self.read_int()
        raw = self.read_bytes(n)
        try:
            return raw.decode("utf-8")
        except UnicodeDecodeError:
            return raw.decode("latin-1")

    # -- records ------------------------------------------------------------

    def read(self):
        tag = self.read_int()
        if tag == TYPE_NIL:
            return None
        if tag == TYPE_NUMBER:
            v = self.read_double()
            return int(v) if v.is_integer() and abs(v) < 2 ** 53 else v
        if tag == TYPE_STRING:
            return self.read_string()
        if tag == TYPE_BOOLEAN:
            return self.read_int() == 1
        if tag == TYPE_TABLE:
            return self._read_table()
        if tag == TYPE_TORCH:
            return self._read_torch()
        if tag in (TYPE_FUNCTION, TYPE_RECUR_FUNCTION,
                   TYPE_LEGACY_RECUR_FUNCTION):
            return self._read_function(tag)
        raise ValueError(f"unknown .t7 record tag {tag} at {self.pos - 4}")

    def _read_table(self):
        idx = self.read_int()
        if idx in self.memo:
            return self.memo[idx]
        out: dict = {}
        self.memo[idx] = out
        for _ in range(self.read_int()):
            k = self.read()
            out[k] = self.read()
        return out

    def _read_function(self, tag):
        # all three function tags memoize identically (torch File.lua
        # writes only tag+index on re-reference, legacy tag 7 included)
        idx = self.read_int()
        if idx in self.memo:
            return self.memo[idx]
        size = self.read_int()
        fn = T7Function(dump=self.read_bytes(size))
        self.memo[idx] = fn
        fn.upvalues = self.read()
        return fn

    def _read_torch(self):
        idx = self.read_int()
        if idx in self.memo:
            return self.memo[idx]
        ver = self.read_string()
        if ver.startswith("V ") and ver[2:].isdigit():
            version = int(ver[2:])
            name = self.read_string()
        else:  # pre-versioning file: the "version" string IS the class name
            version, name = 0, ver

        if name in _TENSOR_DTYPES:
            return self._read_tensor(idx, name)
        if name in _STORAGE_DTYPES:
            return self._read_storage(idx, name)

        obj = T7Object(name=name, version=version)
        self.memo[idx] = obj
        payload = self.read()
        if isinstance(payload, dict):
            obj.fields = {str(k): v for k, v in payload.items()}
        else:  # custom write() payloads (rare); keep raw
            obj.fields = {"__payload__": payload}
        return obj

    def _read_tensor(self, idx, name):
        ndim = self.read_int()  # int32 (THFile writeInt), NOT a long
        sizes = [self.read_long() for _ in range(ndim)]
        strides = [self.read_long() for _ in range(ndim)]
        offset = self.read_long() - 1  # torch storageOffset is 1-based
        storage = self.read()  # storages memoize by their own heap index
        if storage is None or ndim == 0:  # empty tensor
            arr = np.zeros(sizes or (0,), _TENSOR_DTYPES[name])
        else:
            itemsize = storage.dtype.itemsize
            arr = np.lib.stride_tricks.as_strided(
                storage[offset:], shape=sizes,
                strides=[s * itemsize for s in strides]).copy()
        # a tensor re-referenced later resolves to the same array
        self.memo[idx] = arr
        return arr

    def _read_storage(self, idx, name):
        dtype = np.dtype(_STORAGE_DTYPES[name])
        size = self.read_long()
        arr = np.frombuffer(self.read_bytes(size * dtype.itemsize),
                            dtype=dtype).copy()
        self.memo[idx] = arr
        return arr


def loads(data: bytes, long_size: int = 8):
    """Deserialize one top-level object from `.t7` bytes."""
    return _Reader(data, long_size=long_size).read()


def load(path: str, long_size: int = 8):
    """Deserialize the first object in a `.t7` file (the reference's
    torch.save always writes exactly one)."""
    with open(path, "rb") as f:
        return loads(f.read(), long_size=long_size)


def as_list(table) -> list:
    """Lua array-like table (1..n int keys) -> python list. Mixed tables
    raise; a real list passes through."""
    if isinstance(table, list):
        return table
    n = len(table)
    try:
        return [table[i] for i in range(1, n + 1)]
    except KeyError as e:
        raise ValueError(f"table is not a 1..{n} Lua array "
                         f"(missing key {e})") from None


def state_dict(obj, prefix: str = "") -> dict:
    """Flatten a deserialized nn-module graph into {dotted.path: ndarray}.

    Torch objects contribute their tensor-valued fields; `modules` arrays
    recurse with numeric path components (matching how nn.Sequential
    children are addressed). This is the bridge from a raw `.t7` model to
    import_weights' explicit mappings — the caller renames paths to the
    documented contract."""
    out: dict = {}

    def walk(node, pfx):
        if isinstance(node, np.ndarray):
            if node.size:
                out[pfx.rstrip(".")] = node
            return
        if isinstance(node, T7Object):
            walk_fields = node.fields
        elif isinstance(node, dict):
            walk_fields = node
        else:
            return
        for k, v in walk_fields.items():
            key = str(k)
            if key.startswith("_") or key in ("gradInput", "output",
                                              "gradWeight", "gradBias",
                                              "train"):
                continue  # runtime buffers, not parameters
            walk(v, f"{pfx}{key}.")

    walk(obj, prefix)
    return out
