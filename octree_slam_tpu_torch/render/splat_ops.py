"""The splat's packed z-buffer as a hand-written CUDA kernel (csrc/splat.cu;
counterpart: splat_zbuffer of octree_slam_tpu/render/splat.py, plain XLA
and no Pallas kernel).

  splat_zbuffer   key decode, unpack, occupancy, world-to-camera,
                  projection, depth quantisation, RGB565 pack and
                  scatter-min of the registry's live rows in one launch
                  -> csrc kernel splat_zbuffer

Its plain version is render/splat.py's `splat_zbuffer`, which the CPU runs;
render/splat.py chooses between the two (`_splat_kernel`). The kernel's
z-buffer equals the plain version's on the card word for word.

A CUDA tensor launches the kernel (building it on first use); anything else
raises, and nothing falls back. The wrapper fills the image with EMPTY (one
launch), reads nothing back and launches on the current stream. `LAUNCHES`
counts kernel launches, so a run can show that its splat went through the
kernel.
"""

from __future__ import annotations

import torch

from octree_slam_tpu_torch import _build
from octree_slam_tpu_torch.render.points import DEPTH_INF

KERNEL = "splat_zbuffer"
# kernel name -> launches since the last reset_launches()
LAUNCHES = {KERNEL: 0}
# the deepest key the kernel takes (kMaxDepth in splat.cu)
MAX_DEPTH = 10


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    """Raise unless t has `dtype` and `shape` and is contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{KERNEL}: expected {name} of {dtype}, got "
                        f"{t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{KERNEL}: expected {name} of shape "
                         f"{tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{KERNEL}: {name} must be contiguous")


def splat_zbuffer(vals: torch.Tensor, keys: torch.Tensor,
                  count: torch.Tensor | None, center: torch.Tensor,
                  half_size: torch.Tensor, world_T_cam: torch.Tensor,
                  fx: float, fy: float, *, width: int, height: int,
                  depth: int, max_range: float = 10.0,
                  count_stats: bool = False):
    """The packed z-buffer of the rows [0, count) whose key is >= 0 (every
    row's where count is None): vals and keys i32[N], count an i32[] on
    the device, the pool's center f32[3] and half_size f32[], world_T_cam
    f32[4, 4] (any strides). Returns (buf i32[H*W], stats): stats is, with
    count_stats, an int64[2] of the live rows and the rows that issued an
    atomicMin, else None."""
    n = keys.shape[0] if keys.ndim == 1 else -1
    _check("keys", keys, torch.int32, (n,))
    _check("vals", vals, torch.int32, (n,))
    if count is not None:
        _check("count", count, torch.int32, ())
    _check("center", center, torch.float32, (3,))
    _check("half_size", half_size, torch.float32, ())
    if (world_T_cam.dtype != torch.float32
            or tuple(world_T_cam.shape) != (4, 4)):
        raise TypeError(f"{KERNEL}: expected world_T_cam f32[4, 4], got "
                        f"{world_T_cam.dtype}{list(world_T_cam.shape)}")
    if not 1 <= depth <= MAX_DEPTH:
        raise ValueError(f"{KERNEL}: depth {depth} outside 1..{MAX_DEPTH}")
    if width <= 0 or height <= 0:
        raise ValueError(f"{KERNEL}: image {width}x{height}")
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError(f"{KERNEL}: expected CUDA tensors, got {dev}")
    for t in (vals, count, center, half_size, world_T_cam):
        if t is not None and t.device != dev:
            raise ValueError(f"{KERNEL}: tensors on {t.device} and {dev}")
    buf = torch.full((width * height,), DEPTH_INF, dtype=torch.int32,
                     device=dev)
    stats = (torch.zeros((2,), dtype=torch.int64, device=dev)
             if count_stats else None)
    # the Python scalars as PyTorch hands them to its kernels (rounded to
    # float32 by ctypes): the plain version's width / 2.0, height / 2.0 and
    # 32766.0 / max_range
    args = (keys.data_ptr(), vals.data_ptr(),
            count.data_ptr() if count is not None else None, n,
            center.data_ptr(), half_size.data_ptr(), world_T_cam.data_ptr(),
            world_T_cam.stride(0), world_T_cam.stride(1), fx, fy,
            width / 2.0, height / 2.0, width, height, depth, max_range,
            32766.0 / max_range, buf.data_ptr(),
            stats.data_ptr() if stats is not None else None)
    fn = _build.launcher(KERNEL)
    if dev.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, KERNEL)
    LAUNCHES[KERNEL] += 1
    return buf, stats
