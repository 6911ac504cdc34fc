"""ctypes bindings for the native host library, ported from the JAX
package's utils/native.py: image codecs (libpng, libjpeg), a threaded
prefetch loader, and the float64 reference-convention oracle.

The library is compiled from the repo's csrc/sba_native.cpp, which this
module only reads, at first use (never at import) with
`g++ -O2 -std=c++17 -shared -fPIC ... -lpng -ljpeg -lz -lpthread` into
the port's build/ directory, under a name that carries a hash of the
source and the flags, so an edited source never loads a stale binary.
The build writes a per-process temporary file and renames it into place,
so processes that build at once do not collide. The binary under csrc/
and csrc/build.py are never used.

Everything degrades gracefully: without g++, libpng's or libjpeg's
headers, `available()` is False (`unavailable_reason()` says why) and
image IO falls back to PIL.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np
import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "csrc" / "sba_native.cpp"
BUILD_DIR = _PKG / "build"
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]
LINK_LIBS = ["-lpng", "-ljpeg", "-lz", "-lpthread"]

_LIB = None
_TRIED = False
_WHY = None  # why the library is unavailable, once a load failed


def build() -> Path:
    """Compile SOURCE into BUILD_DIR/libsba_native_<hash>.so (if absent)
    and return its path; raises if the source or the toolchain is
    missing or the compile fails."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS + LINK_LIBS).encode())
    out = BUILD_DIR / f"libsba_native_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *LINK_LIBS]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}): {proc.stderr.strip()}")
    os.replace(tmp, out)
    return out


def _load():
    global _LIB, _TRIED, _WHY
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError) as e:  # no g++ (FileNotFoundError), headers or source
        _WHY = f"{type(e).__name__}: {e}"
        return None

    lib.sba_load_image.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.sba_load_image.restype = ctypes.c_int
    lib.sba_save_png.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.sba_save_png.restype = ctypes.c_int
    lib.sba_free.argtypes = [ctypes.c_void_p]
    lib.sba_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.sba_loader_create.restype = ctypes.c_void_p
    lib.sba_loader_next.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_long,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.sba_loader_next.restype = ctypes.c_int
    lib.sba_loader_destroy.argtypes = [ctypes.c_void_p]
    d = ctypes.POINTER(ctypes.c_double)
    i = ctypes.POINTER(ctypes.c_int)
    lib.sba_oracle_eight_point.argtypes = [d, d, ctypes.c_int, d, d, d, i, i]
    lib.sba_oracle_bcd.argtypes = [d, d, ctypes.c_int, d, d, d, ctypes.c_int, ctypes.c_int]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def unavailable_reason():
    """None when the library loads, else why it does not (the build's
    error)."""
    return None if available() else _WHY


def load_image_native(path: str):
    lib = _load()
    if lib is None:
        return None
    buf = ctypes.POINTER(ctypes.c_uint8)()
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.sba_load_image(path.encode(), ctypes.byref(buf), ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        return None
    n = h.value * w.value * 3
    arr = np.ctypeslib.as_array(buf, shape=(n,)).reshape(h.value, w.value, 3).copy()
    lib.sba_free(buf)
    return arr


def save_png_native(path: str, rgb) -> bool:
    lib = _load()
    if lib is None:
        return False
    arr = np.ascontiguousarray(np.asarray(rgb, dtype=np.uint8))
    rc = lib.sba_save_png(
        path.encode(), arr.ctypes.data_as(ctypes.c_void_p), arr.shape[0], arr.shape[1]
    )
    return rc == 0


class NativeImageLoader:
    """Threaded prefetching loader over a list of image paths (all images
    must share dimensions). Iterates (index, array) in completion order."""

    def __init__(self, paths, n_threads=2):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {_WHY}")
        self._lib = lib
        self._paths = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._n = len(paths)
        self._handle = lib.sba_loader_create(arr, self._n, n_threads)
        self._buf = None

    def __iter__(self):
        h = ctypes.c_int()
        w = ctypes.c_int()
        while True:
            if self._buf is None:
                # allocate generously on first use
                self._buf = np.empty(64 * 1024 * 1024, np.uint8)
            idx = self._lib.sba_loader_next(
                self._handle,
                self._buf.ctypes.data_as(ctypes.c_void_p),
                self._buf.nbytes,
                ctypes.byref(h),
                ctypes.byref(w),
            )
            if idx == -1:
                break
            if idx == -2:
                continue
            n = h.value * w.value * 3
            yield idx, self._buf[:n].reshape(h.value, w.value, 3).copy()

    def close(self):
        if self._handle:
            self._lib.sba_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def oracle_eight_point(b1, b2):
    """Float64 reference-convention 8-point (golden oracle) on (N, 3)
    bearings (arrays, or tensors on any device).

    Returns (euler1, euler2, t, valid1, valid2)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_WHY}")
    b1 = np.ascontiguousarray(_host64(b1))
    b2 = np.ascontiguousarray(_host64(b2))
    n = b1.shape[0]
    e1 = np.zeros(3)
    e2 = np.zeros(3)
    t = np.zeros(3)
    v1 = ctypes.c_int()
    v2 = ctypes.c_int()
    lib.sba_oracle_eight_point(
        _dptr(b1), _dptr(b2), n, _dptr(e1), _dptr(e2), _dptr(t),
        ctypes.byref(v1), ctypes.byref(v2),
    )
    return e1, e2, t, bool(v1.value), bool(v2.value)


def oracle_bcd(b1, b2, rot0, tran0, d0, iters=50, compat=True):
    """Float64 reference-convention three-stage BCD solve (golden oracle).

    Returns (rot, tran, d) after d -> rot -> tran stages."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_WHY}")
    b1 = np.ascontiguousarray(_host64(b1))
    b2 = np.ascontiguousarray(_host64(b2))
    n = b1.shape[0]
    rot = _host64(rot0)
    tran = _host64(tran0)
    d = np.ascontiguousarray(_host64(d0))
    lib.sba_oracle_bcd(_dptr(b1), _dptr(b2), n, _dptr(rot), _dptr(tran), _dptr(d), iters,
                       int(compat))
    return rot, tran, d


def _host64(x):
    """x as a new float64 numpy array (a tensor is copied off its
    device)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.array(x, np.float64)
