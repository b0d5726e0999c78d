"""ctypes bridge to the native RLE and box-IoU codec — port of
multipathnet_tpu/data/rle_native.py over the port's own copy of the C++
source (multipathnet_tpu_torch/native/rle.cpp).

At first use g++ compiles the source into build/rle/<hash>/librle.so at
the repository root (listed in .gitignore), keyed by a hash of the source
and the flags, as ops/_build.py builds the CUDA kernels; nothing is
written beside the source. Nothing is compiled or loaded when this module
is imported. If the build or the load fails, `available()` is False,
`load_error()` says why and a RuntimeWarning says so once; data/rle.py
and eval/coco_eval.py then run their NumPy versions, whose results the
native ones equal byte for byte (tests/test_torch_rle_native.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import warnings
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "native" / "rle.cpp"
BUILD_ROOT = _PKG.parent / "build" / "rle"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall", "-shared")

_lib = None
_error: str | None = None


def build() -> Path:
    """Compile the codec unless a build of this source exists; returns
    the library's path. Raises RuntimeError if g++ is missing or fails."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    out_dir = BUILD_ROOT / h.hexdigest()[:16]
    lib_path = out_dir / "librle.so"
    if lib_path.exists():
        return lib_path
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++, or $CXX) on PATH")
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".librle.{os.getpid()}.so"
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)  # atomic: concurrent builds race safely
    return lib_path


def _try_load():
    global _lib, _error
    if _lib is not None or _error is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        _error = f"{type(e).__name__}: {e}"
        warnings.warn(f"native RLE codec unavailable, the NumPy codec runs "
                      f"instead: {_error}", RuntimeWarning, stacklevel=3)
        return None
    i64 = ctypes.c_int64
    lib.rle_decode_string.restype = i64
    lib.rle_decode_string.argtypes = [
        ctypes.c_char_p, i64, ctypes.POINTER(i64), i64]
    lib.rle_encode_string.restype = i64
    lib.rle_encode_string.argtypes = [
        ctypes.POINTER(i64), i64, ctypes.c_char_p, i64]
    lib.rle_counts_to_mask.restype = i64
    lib.rle_counts_to_mask.argtypes = [
        ctypes.POINTER(i64), i64, ctypes.POINTER(ctypes.c_uint8), i64]
    lib.rle_mask_to_counts.restype = i64
    lib.rle_mask_to_counts.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), i64, ctypes.POINTER(i64), i64]
    lib.rle_area_bbox.restype = None
    lib.rle_area_bbox.argtypes = [
        ctypes.POINTER(i64), i64, i64, ctypes.POINTER(ctypes.c_double)]
    lib.bb_iou.restype = None
    lib.bb_iou.argtypes = [
        ctypes.POINTER(ctypes.c_double), i64,
        ctypes.POINTER(ctypes.c_double), i64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_double)]
    _lib = lib
    return lib


def available() -> bool:
    """Whether the codec built and loaded (building it on first call)."""
    return _try_load() is not None


def load_error() -> str | None:
    """Why the codec is not available, or None."""
    _try_load()
    return _error


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def decode_string(s: str) -> list[int]:
    raw = s.encode("ascii")
    out = np.empty(len(raw) + 4, np.int64)
    n = _try_load().rle_decode_string(raw, len(raw), _i64p(out), out.size)
    if n < 0:
        raise ValueError("malformed RLE string")
    return out[:n].tolist()


def encode_string(counts) -> str:
    c = np.ascontiguousarray(counts, np.int64)
    cap = 16 * max(len(c), 1)
    buf = ctypes.create_string_buffer(cap)
    n = _try_load().rle_encode_string(_i64p(c), len(c), buf, cap)
    if n < 0:
        raise ValueError("encode buffer overflow")
    return buf.raw[:n].decode("ascii")


def counts_to_mask(counts, size) -> np.ndarray:
    h, w = size
    c = np.ascontiguousarray(counts, np.int64)
    mask = np.empty(h * w, np.uint8)
    if _try_load().rle_counts_to_mask(_i64p(c), len(c), _u8p(mask),
                                      h * w) != 0:
        raise ValueError(f"RLE does not cover {h}x{w}")
    return mask.reshape((h, w), order="F")


def mask_to_counts(mask: np.ndarray) -> list[int]:
    flat = np.ascontiguousarray(
        np.asarray(mask).astype(np.uint8).reshape(-1, order="F"))
    out = np.empty(flat.size + 2, np.int64)
    n = _try_load().rle_mask_to_counts(_u8p(flat), flat.size, _i64p(out),
                                       out.size)
    if n < 0:
        raise ValueError("counts buffer overflow")
    return out[:n].tolist()


def area_bbox(counts, h: int):
    """-> (foreground pixel count, float32 (x, y, w, h) tight box)."""
    c = np.ascontiguousarray(counts, np.int64)
    out = np.empty(5, np.float64)
    _try_load().rle_area_bbox(_i64p(c), len(c), h, _f64p(out))
    return int(out[0]), out[1:].astype(np.float32)


def box_iou_xywh(dt: np.ndarray, gt: np.ndarray,
                 iscrowd: np.ndarray) -> np.ndarray:
    dt = np.ascontiguousarray(dt, np.float64).reshape(-1, 4)
    gt = np.ascontiguousarray(gt, np.float64).reshape(-1, 4)
    ic = np.ascontiguousarray(iscrowd, np.uint8)
    if ic.shape != (len(gt),):
        raise ValueError(f"iscrowd {ic.shape} for {len(gt)} GT boxes")
    out = np.empty((len(dt), len(gt)), np.float64)
    if out.size:
        _try_load().bb_iou(_f64p(dt), len(dt), _f64p(gt), len(gt), _u8p(ic),
                           _f64p(out))
    return out
