"""Build and bind the port's hand-written CUDA kernels.

All sources under ../csrc/*.cu are compiled by nvcc for sm_90a into ONE
shared library with a plain C interface (no PyTorch headers, which keeps
the build short) and loaded with ctypes. The library lands in
../build/ (listed in .gitignore) under a name that carries a hash of the
sources, so an edited source can never load a stale binary. Nothing is
built or loaded when this module is imported: the first launch does it.

Every C entry point takes pointers as c_void_p (device memory, or host
memory it reads before it launches: host_ptr; None for a null pointer),
ints as c_int and floats as c_float, then the device index and
PyTorch's current CUDA stream on it, selects that device, launches on
that stream, and returns cudaGetLastError(); the caller raises on
anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures: name -> argtypes (restype is int, the cudaError_t).
SIGNATURES = {
    "sba_det_pyramid": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "sba_haar_trace": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "sba_top2": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "sba_lm_depth_point": [_P] * 14 + [_I] * 2 + [_F] + [_I, _P],
    "sba_lm_depth_settle": [_P] * 14 + [_I] * 2 + [_F] * 6 + [_I, _P],
    "sba_lm_global_solve": [_P] * 10 + [_I] + [_I, _P],
    "sba_lm_global_point": [_P] * 20 + [_I] * 7 + [_F] * 3 + [_I, _P],
    "sba_lm_global_settle": [_P] * 14 + [_I] * 2 + [_F] * 4 + [_I, _P],
}

_lib = None
build_seconds = None  # wall time of this process's nvcc run, if it ran one


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc():
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME is unset)")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def build(verbose: bool = False, defines=()) -> Path:
    """Compile csrc/*.cu into build/libsba_kernels_<hash>.so (if absent).
    `defines`: macros to set, for the measurement variants of the
    kernels (kernel_times.py --ablate)."""
    global build_seconds
    srcs = _sources()
    flags = [*ARCH_FLAGS, *(f"-D{d}" for d in defines)]
    digest = hashlib.sha256()
    for s in srcs:
        digest.update(s.name.encode())
        digest.update(s.read_bytes())
    digest.update(" ".join(flags).encode())
    out = BUILD_DIR / f"libsba_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        _nvcc(), *flags, "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
        *[str(s) for s in srcs if s.suffix == ".cu"],
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    if verbose:
        print(proc.stderr, flush=True)
    os.replace(tmp, out)
    return out


def library(defines=None):
    """The loaded kernel library (built on first call). Given `defines`,
    build and load that variant in place of the loaded library."""
    global _lib
    if _lib is None or defines is not None:
        lib = ctypes.CDLL(str(build(defines=defines or ())))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


class Kernel:
    """One CUDA entry point with its launch count.

    `launches` rises by one each time `launch` starts the kernel and at no
    other time, so a run can show that it went through the kernel."""

    def __init__(self, symbol: str):
        self.symbol = symbol
        self.launches = 0

    def launch(self, device, *args):
        fn = getattr(library(), self.symbol)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, device.index, stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol} launch failed: cudaError {err}")
        self.launches += 1


def ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def host_ptr(a):
    """A C-contiguous numpy array's data, for an argument the C side reads
    on the host before it launches."""
    if not a.flags.c_contiguous:
        raise ValueError("expected a C-contiguous array")
    return a.ctypes.data_as(ctypes.c_void_p)


def check(t: torch.Tensor, name: str, dtype, device, shape=None):
    """Raise unless t is a contiguous CUDA tensor of dtype (and shape)."""
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
