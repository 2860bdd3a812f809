"""ctypes bindings to the repo's native host I/O runtime (counterpart:
octree_slam_tpu/io/native.py).

The runtime (`native/src/*.cpp`) is the data-loader half: libpng frame
decode and encode, a threaded in-order frame prefetcher (the OpenNIDevice
frame pump's counterpart, reference openni_device.cpp:96-156) and a
Wavefront OBJ parser. `_build.build_native` compiles it with g++ into the
package's `_kernels_build/` on first use. Where it cannot be built (no
compiler, no libpng headers) `available()` is False, `BUILD_ERROR` holds
the compiler's first error line, and the callers (io/tum.py, io/bmp.py)
take their pure paths, as the reference's do. It is host code: no device
is involved.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np

_lib: Optional[ctypes.CDLL] = None
_tried = False
# the first error line of a failed build, else None
BUILD_ERROR: Optional[str] = None


def _first_error(msg: str) -> str:
    lines = [ln.strip() for ln in msg.splitlines() if ln.strip()]
    return next((ln for ln in lines if "error" in ln.lower()),
                lines[0] if lines else msg)


def load_library() -> Optional[ctypes.CDLL]:
    """Load (building on first use) the native library; None if it cannot
    be built or loaded."""
    global _lib, _tried, BUILD_ERROR
    if _lib is not None or _tried:
        return _lib
    _tried = True
    from octree_slam_tpu_torch import _build
    try:
        try:
            lib = ctypes.CDLL(str(_build.build_native()))
        except OSError:
            # a cached library built on another host (copied with the
            # checkout) may not load here: build it again, so that a
            # failure is this host's own compiler or loader error
            lib = ctypes.CDLL(str(_build.build_native(rebuild=True)))
    except (RuntimeError, OSError) as e:
        BUILD_ERROR = _first_error(str(e))
        return None

    lib.oslam_image_load.restype = ctypes.c_void_p
    lib.oslam_image_load.argtypes = [ctypes.c_char_p]
    for fn in ("oslam_image_width", "oslam_image_height",
               "oslam_image_channels", "oslam_image_bit_depth"):
        getattr(lib, fn).restype = ctypes.c_uint32
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.oslam_image_data.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.oslam_image_data.argtypes = [ctypes.c_void_p]
    lib.oslam_image_free.argtypes = [ctypes.c_void_p]

    lib.oslam_png_write.restype = ctypes.c_int
    lib.oslam_png_write.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32]

    lib.oslam_prefetch_create.restype = ctypes.c_void_p
    lib.oslam_prefetch_create.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_double, ctypes.c_uint32, ctypes.c_uint32]
    lib.oslam_prefetch_len.restype = ctypes.c_size_t
    lib.oslam_prefetch_len.argtypes = [ctypes.c_void_p]
    lib.oslam_prefetch_next.restype = ctypes.c_int
    lib.oslam_prefetch_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint16),
        ctypes.POINTER(ctypes.c_uint8)]
    lib.oslam_prefetch_destroy.argtypes = [ctypes.c_void_p]

    lib.oslam_obj_load.restype = ctypes.c_void_p
    lib.oslam_obj_load.argtypes = [ctypes.c_char_p]
    for fn in ("oslam_obj_num_vertices", "oslam_obj_num_faces"):
        getattr(lib, fn).restype = ctypes.c_size_t
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    for fn, ty in (("oslam_obj_vertices", ctypes.c_float),
                   ("oslam_obj_normals", ctypes.c_float),
                   ("oslam_obj_faces", ctypes.c_int32),
                   ("oslam_obj_uvs", ctypes.c_float),
                   ("oslam_obj_bbox", ctypes.c_float)):
        getattr(lib, fn).restype = ctypes.POINTER(ty)
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.oslam_obj_free.argtypes = [ctypes.c_void_p]

    _lib = lib
    return _lib


def available() -> bool:
    return load_library() is not None


def _need() -> ctypes.CDLL:
    lib = load_library()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {BUILD_ERROR}")
    return lib


def read_png(path: str) -> np.ndarray:
    """Decode a PNG: grey -> (H, W) uint8 / uint16, colour -> (H, W, 3)
    uint8 (palettes expanded, alpha dropped)."""
    lib = _need()
    h = lib.oslam_image_load(path.encode())
    if not h:
        raise IOError(f"failed to decode PNG: {path}")
    try:
        width = lib.oslam_image_width(h)
        height = lib.oslam_image_height(h)
        channels = lib.oslam_image_channels(h)
        depth = lib.oslam_image_bit_depth(h)
        nbytes = width * height * channels * (depth // 8)
        # one copy out of the library's buffer, into a writable array
        arr = np.ctypeslib.as_array(lib.oslam_image_data(h),
                                    shape=(nbytes,)).copy().view(
            np.uint16 if depth == 16 else np.uint8)
        if channels == 1:
            return arr.reshape(height, width)
        return arr.reshape(height, width, channels)
    finally:
        lib.oslam_image_free(h)


def write_png(path: str, image: np.ndarray) -> None:
    """Encode an 8-bit (H, W[, C]) array as a PNG (fast, low
    compression)."""
    lib = _need()
    img = np.ascontiguousarray(image, dtype=np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    rc = lib.oslam_png_write(
        path.encode(), img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        w, h, c)
    if rc != 0:
        raise IOError(f"png write failed ({rc}): {path}")


class FramePrefetcher:
    """In-order threaded RGB-D frame decoder: next() returns (depth_mm
    uint16 [H, W], rgb uint8 [H, W, 3]), or None at the end of the stream;
    a decode error raises. Use as a context manager."""

    def __init__(self, depth_paths: Sequence[str], rgb_paths: Sequence[str],
                 width: int, height: int, depth_to_mm: float = 1.0,
                 n_threads: int = 3, capacity: int = 8):
        lib = _need()
        self._lib = lib
        self._h = lib.oslam_prefetch_create(
            "\n".join(depth_paths).encode(), "\n".join(rgb_paths).encode(),
            width, height, depth_to_mm, n_threads, capacity)
        if not self._h:
            raise ValueError("prefetcher create failed (bad paths/shapes)")
        self.width, self.height = width, height

    def __len__(self):
        return self._lib.oslam_prefetch_len(self._h)

    def next(self):
        depth = np.empty((self.height, self.width), np.uint16)
        rgb = np.empty((self.height, self.width, 3), np.uint8)
        rc = self._lib.oslam_prefetch_next(
            self._h, depth.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if rc == 1:
            return None
        if rc != 0:
            raise IOError(f"frame decode failed (status {rc})")
        return depth, rgb

    def close(self):
        if self._h:
            self._lib.oslam_prefetch_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def load_obj_arrays(path: str):
    """Parse an OBJ natively -> (vertices, normals, faces, uvs, lo, hi)."""
    lib = _need()
    h = lib.oslam_obj_load(path.encode())
    if not h:
        raise IOError(f"failed to parse OBJ: {path}")
    try:
        nv = lib.oslam_obj_num_vertices(h)
        nf = lib.oslam_obj_num_faces(h)

        def grab(fn, n, dtype):
            if not n:
                return np.zeros(0, dtype)
            ct = ctypes.c_int32 if dtype == np.int32 else ctypes.c_float
            return np.frombuffer(bytes(ctypes.cast(
                fn(h), ctypes.POINTER(ct * n)).contents), dtype=dtype).copy()

        v = grab(lib.oslam_obj_vertices, nv * 3, np.float32).reshape(nv, 3)
        n = grab(lib.oslam_obj_normals, nv * 3, np.float32).reshape(nv, 3)
        f = grab(lib.oslam_obj_faces, nf * 3, np.int32).reshape(nf, 3)
        uv = grab(lib.oslam_obj_uvs, nf * 6, np.float32).reshape(nf, 3, 2)
        bbox = grab(lib.oslam_obj_bbox, 6, np.float32)
        return v, n, f, uv, bbox[:3], bbox[3:]
    finally:
        lib.oslam_obj_free(h)
