"""Build and load the port's CUDA kernels from the sources in `csrc/`.

nvcc compiles `csrc/*.cu` for sm_90a into one shared library with a plain C
interface, which is loaded with ctypes. This path needs neither ninja nor
PyTorch's headers (torch.utils.cpp_extension.load needs both, and a source
that includes PyTorch's headers takes minutes to compile), so the whole
build takes seconds. The library lands in `_kernels_build/` beside this
file, named by a hash of the sources and flags: a changed source rebuilds,
an unchanged one loads the cached library.

Nothing is fetched and nothing falls back: a missing nvcc or a failed
compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_kernels_build"
ROUTE = "nvcc+ctypes"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# what the last build() did, for the smoke script's report
BUILD_INFO: dict = {}

_lib = None


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.h"))


def find_nvcc() -> str:
    """nvcc from CUDA_HOME / CUDA_PATH, then PATH, then the toolkit's
    default install prefix."""
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def build() -> Path:
    """Compile the kernels if the cached library is missing or stale;
    returns the library's path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    lib_path = BUILD_DIR / f"liboslam_kernels-{h.hexdigest()[:16]}.so"
    if lib_path.is_file():
        BUILD_INFO.update(route=ROUTE, path=str(lib_path), cached=True,
                          seconds=0.0, ptxas="")
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           *[str(s) for s in _sources() if s.suffix == ".cu"]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib_path)
    BUILD_INFO.update(route=ROUTE, path=str(lib_path), cached=False,
                      seconds=seconds, ptxas=proc.stderr + proc.stdout)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), with every
    function's argtypes and restype declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i, f, d = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                      ctypes.c_double)
        lib.oslam_bilateral7x7.argtypes = [p, p, i, i, i, d, f, p]
        lib.oslam_bilateral7x7.restype = i
        lib.oslam_gated_subsample5x5.argtypes = [p, p, i, i, i, f, p]
        lib.oslam_gated_subsample5x5.restype = i
        lib.oslam_error_string.argtypes = [i]
        lib.oslam_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, kernel: str) -> None:
    """Raise if a launcher reported a CUDA error."""
    if err != 0:
        msg = library().oslam_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}: {msg}")
