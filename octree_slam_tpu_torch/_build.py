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

`build_native` compiles the repo's host I/O runtime (`native/src/*.cpp`:
libpng decode and encode, the threaded frame prefetcher, the OBJ parser)
with g++ the way `native/Makefile` does, into the same directory, named the
same way; io/native.py loads it.
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

NATIVE_SRC = _PKG.parent / "native" / "src"
NATIVE_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
NATIVE_LIBS = ("-lpng", "-lz", "-lpthread")

# what the last build() did, for the smoke script's report
BUILD_INFO: dict = {}

_lib = None
# launcher name -> its ctypes function object in _lib
_launchers: dict = {}


def _sources(csrc: Path):
    return sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.h"))


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


def build(csrc: Path = CSRC) -> Path:
    """Compile the kernel sources in `csrc` if their cached library is
    missing or stale; returns the library's path."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(csrc):
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
           *[str(s) for s in _sources(csrc) if s.suffix == ".cu"]]
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


def load(lib_path: Path) -> ctypes.CDLL:
    """Make the library at `lib_path` the one the wrappers launch, with
    every function's argtypes and restype declared."""
    global _lib
    lib = ctypes.CDLL(str(lib_path))
    p, i, f, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_double
    lib.oslam_bilateral7x7.argtypes = [p, p, i, i, i, d, f, p]
    lib.oslam_bilateral7x7.restype = i
    # an older source (a baseline of examples/compare_stencil_kernels.py)
    # may lack bilateral_window
    if hasattr(lib, "oslam_bilateral_window"):
        lib.oslam_bilateral_window.argtypes = [p, p, i, i, i, i, d, f, p]
        lib.oslam_bilateral_window.restype = i
    lib.oslam_gated_pyramid5x5.argtypes = [p, p, p, i, i, i, f, i, p]
    lib.oslam_gated_pyramid5x5.restype = i
    # likewise an older source may lack band_march
    if hasattr(lib, "oslam_band_march"):
        lib.oslam_band_march.argtypes = [p, p, p, p, p, p, p, p, i, p, p, i,
                                         i, i, i, f, i, p, p, p, p, p]
        lib.oslam_band_march.restype = i
    # and splat_zbuffer
    if hasattr(lib, "oslam_splat_zbuffer"):
        lib.oslam_splat_zbuffer.argtypes = [p, p, p, i, p, p, p, i, i, f, f,
                                            f, f, i, i, i, f, f, p, p, p]
        lib.oslam_splat_zbuffer.restype = i
    lib.oslam_error_string.argtypes = [i]
    lib.oslam_error_string.restype = ctypes.c_char_p
    _lib = lib
    _launchers.clear()
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from `csrc/` and loaded on first
    use."""
    return _lib if _lib is not None else load(build())


def launcher(kernel: str):
    """The ctypes function object of `kernel`'s launcher, `oslam_<kernel>`,
    held after its first lookup."""
    fn = _launchers.get(kernel)
    if fn is None:
        fn = _launchers[kernel] = getattr(library(), f"oslam_{kernel}")
    return fn


def check(err: int, kernel: str) -> None:
    """Raise if a launcher reported a CUDA error."""
    if err != 0:
        msg = library().oslam_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}: {msg}")


def native_lib_path(src: Path = NATIVE_SRC) -> Path:
    """Where build_native puts the library of the sources in `src`: named
    by a hash of the sources and flags."""
    h = hashlib.sha256(" ".join(NATIVE_FLAGS + NATIVE_LIBS).encode())
    for f in sorted(src.glob("*.cpp")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"liboslam_native-{h.hexdigest()[:16]}.so"


def build_native(src: Path = NATIVE_SRC, rebuild: bool = False) -> Path:
    """Compile the host I/O runtime's sources in `src` with g++ (CXX) if
    their cached library is missing or stale, or always with `rebuild`;
    returns its path. Raises RuntimeError with the compiler's output when
    the build fails (no compiler, no libpng headers)."""
    cxx = os.environ.get("CXX", "g++")
    sources = sorted(src.glob("*.cpp"))
    lib_path = native_lib_path(src)
    if lib_path.is_file() and not rebuild:
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    cmd = [cxx, *NATIVE_FLAGS, "-o", str(tmp), *map(str, sources),
           *NATIVE_LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"{cxx} failed to start: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path
