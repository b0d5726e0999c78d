"""Build and load the CUDA kernels under multipathnet_tpu_torch/csrc/.

nvcc compiles each source into an object, all sources at once in parallel,
and links them into one shared library with a plain C interface at first
use, into build/kernels/<hash>/ at the repository root (listed in
.gitignore), keyed by a hash of the sources and the flags, so a changed
source rebuilds and an unchanged one loads what is there. The library is
bound with ctypes: every pointer and the stream pass as c_void_p, every
size as c_int, and each entry point returns the cudaError_t of its launch.
The bf16 pool body encodes its TMA tensor maps through the runtime's
cudaGetDriverEntryPoint, so the link line names no driver library.

Nothing is compiled or loaded when this module is imported; CPU-only hosts
never reach `kernels()`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "kernels"
SOURCES = ("roi_window_pool.cu", "roi_window_pool_wgmma.cu",
           "roi_window_grad.cu", "window_read_probe.cu")
HEADERS = ("roi_window_pool.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int
# entry point -> argtypes (csrc/roi_window_pool.cu, csrc/roi_window_grad.cu,
# csrc/window_read_probe.cu)
_SIGNATURES = {
    "mpn_window_pool_multi": [_I, _I, _I, _I, _P, _P, _P, _I, _I, _I,
                              _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    "mpn_resident_pool": [_I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                          _P, _P, _P],
    "mpn_pool_kernel_attrs": [_I, _I, _I, _P],
    "mpn_window_grad": [_I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    "mpn_window_rmw_grad": [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    "mpn_window_read_probe": [_I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or CUDA_HOME set)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> tuple[Path, float, str]:
    """Compile the kernels unless a build of these sources exists.
    Returns (library path, seconds spent compiling, compiler output)."""
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / "libmpn_kernels.so"
    if lib_path.exists():
        return lib_path, 0.0, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), str(os.getpid())
    objs = [out_dir / f".{Path(s).stem}.{tag}.o" for s in SOURCES]
    t0 = time.perf_counter()
    compiles = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True))
                for cmd in ([nvcc, *NVCC_FLAGS,
                             *(["-Xptxas", "-v"] if verbose else []),
                             "-c", "-o", str(obj), str(CSRC / src)]
                            for src, obj in zip(SOURCES, objs))]
    outs = [proc.communicate()[0] for _, proc in compiles]
    for (cmd, proc), out in zip(compiles, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    log = "".join(outs)
    tmp = out_dir / f".libmpn_kernels.{tag}.so"
    cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    for obj in objs:
        obj.unlink()
    os.replace(tmp, lib_path)  # atomic: concurrent builds race safely
    return lib_path, seconds, log + proc.stdout + proc.stderr


def kernels() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib_path, _, _ = build()
        lib = ctypes.CDLL(str(lib_path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
