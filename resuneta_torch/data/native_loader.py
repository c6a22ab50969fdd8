"""ctypes bindings for the native C++ batch loader (csrc/loader.cpp; the
JAX package's resuneta_tpu/data/native_loader.py).

The library builds with g++ at first use into
`build/loader/libresuneta_loader-<hash>.so`, the hash taken over the
source, the flags and the machine's architecture, so an edited source
never loads a stale library; nothing is built when the module is
imported. The flags name no host CPU (no -march=native: the row gather is
memcpy), so a build directory copied to another machine of the same
architecture still serves. Where there is no compiler, or the build or
load fails, every consumer falls back to numpy fancy indexing (or the
caller's np.load pool), which gives the same bytes: the native path is an
accelerator, never a dependency. `backend()` says which path runs.
"""

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "loader"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode() +
        platform.machine().encode()).hexdigest()
    return BUILD_DIR / f"libresuneta_loader-{digest[:16]}.so"


def _build_so(out: Path):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _build_failed:
            return _lib
        so_path = library_path()
        try:
            if not so_path.exists():
                _build_so(so_path)
            lib = ctypes.CDLL(str(so_path))
        except (OSError, subprocess.CalledProcessError):
            # no g++ (FileNotFoundError), a failed build, or a library the
            # loader refuses: the numpy path serves
            _build_failed = True
            return None
        lib.rl_load_batch.restype = ctypes.c_int
        lib.rl_load_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_char_p,
            ctypes.c_long, ctypes.c_int,
        ]
        lib.rl_gather_rows.restype = ctypes.c_int
        lib.rl_gather_rows.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_long), ctypes.c_int,
            ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
        ]
        _lib = lib
    return _lib


def backend() -> str:
    """"native" where the C++ library serves gather_rows and
    load_npy_batch, else "numpy" (the fallback)."""
    return "native" if get_lib() is not None else "numpy"


def load_npy_batch(paths, item_shape, dtype, n_threads=8):
    """Parallel-load a list of same-shape .npy files into one stacked array.
    Returns None if the native library is unavailable or any file mismatches
    (callers fall back to np.load)."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n,) + tuple(item_shape), dtype)
    bytes_per_item = out[0].nbytes if n else 0
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    rc = lib.rl_load_batch(arr, n, out.ctypes.data_as(ctypes.c_char_p),
                           bytes_per_item, n_threads)
    if rc != 0:
        return None
    return out


def gather_rows(src, indices, n_threads=8):
    """dest[i] = src[indices[i]] with a parallel memcpy per row; `src` is an
    ndarray or a memmap (made C-contiguous first if it is not). Negative
    indices count from the end and out-of-range ones raise IndexError, as
    fancy indexing does, which is the fallback without the library."""
    indices = np.asarray(indices, np.int64)
    lib = get_lib()
    if lib is None:
        return np.ascontiguousarray(src[indices])
    n_src = src.shape[0]
    if indices.size and (indices.min() < -n_src or indices.max() >= n_src):
        raise IndexError(f"row index out of range for {n_src} rows")
    indices = np.ascontiguousarray(np.where(indices < 0, indices + n_src,
                                            indices))
    src_arr = np.ascontiguousarray(src)   # a view where already contiguous
    out = np.empty((len(indices),) + src.shape[1:], src.dtype)
    item_bytes = out[0].nbytes if len(indices) else 0
    rc = lib.rl_gather_rows(
        src_arr.ctypes.data, indices.ctypes.data_as(
            ctypes.POINTER(ctypes.c_long)),
        len(indices), out.ctypes.data, item_bytes, n_threads)
    if rc != 0:
        raise RuntimeError(f"rl_gather_rows returned {rc}")
    return out
