"""Build the CUDA kernels at first use and load them with ctypes.

Each source in `csrc/` compiles on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/lib<name>-<hash>.so csrc/<file>.cu

into a shared library with a plain C interface (no PyTorch headers, so a
build takes seconds, not minutes). The file name carries a hash of the
source, the shared headers in `csrc/` (`*.cuh`) and the flags, so an edited
source or header never loads a stale library.
Nothing is built when a module is imported: `load()` builds on first use,
`build_all()` starts one nvcc per source at once.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = {"convseg": "convseg.cu", "convseg_bwd": "convseg_bwd.cu",
           "jfa": "jfa.cu", "canny": "canny.cu", "densemm": "densemm.cu",
           "poolconv": "poolconv.cu"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "kernels build on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names=None) -> dict:
    """Compile every missing library, one nvcc process per source, all
    started together. Returns {name: compiler output} for what was built
    (ptxas' register and shared-memory report); raises on any failure."""
    names = list(SOURCES) if names is None else list(names)
    todo = {n: library_path(n) for n in names if not library_path(n).exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The built library for `name` (built now if missing), cached."""
    if name not in _LIBS:
        build_all([name])
        _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return _LIBS[name]
