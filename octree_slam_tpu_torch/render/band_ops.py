"""The hybrid's band march as a hand-written CUDA kernel (csrc/band_march.cu;
counterpart: the lax.while_loop of octree_slam_tpu/render/hybrid.py:420,
which is no Pallas kernel).

  band_march   the fixed-trip, single-sample march of the band's lanes:
               every trip of a lane in one thread's registers, one launch
               for all of them -> csrc kernel band_march

Its plain version is the eager loop of render/hybrid.py (`_trips_eager`),
which render/hybrid.py runs on the CPU, for the compacting march and for
crawl > 1; it chooses between the two (`_band_kernel`). The kernel's
outputs equal the plain version's on the card word for word.

A CUDA tensor launches the kernel (building it on first use); anything else
raises, and nothing falls back. The wrapper allocates the outputs, reads
nothing back and launches on the current stream. `LAUNCHES` counts kernel
launches, so a run can show that its band went through the kernel.
"""

from __future__ import annotations

import torch

from octree_slam_tpu_torch import _build
from octree_slam_tpu_torch.map import mips

KERNEL = "band_march"
# kernel name -> launches since the last reset_launches()
LAUNCHES = {KERNEL: 0}
# the deepest leaf level the kernel takes (kMaxDepth in band_march.cu)
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


def band_march(origin: torch.Tensor, dirs: torch.Tensor,
               inv_dirs: torch.Tensor, limit: torch.Tensor,
               start: torch.Tensor, miss: torch.Tensor,
               cache: mips.RenderCache, center: torch.Tensor,
               half_size: torch.Tensor, *, depth: int, dist_level: int,
               max_range: float, band_iters: int, fused_dist: bool,
               count_live: bool = False):
    """March C lanes `band_iters` trips through the dense mirror's leaf
    level: origin f32[3] (any stride), dirs and inv_dirs f32[C, 3], the
    lanes' range limit and start f32[C] and miss bool[C], the mirror
    `cache` (values i32; dist i32, read without fused_dist), the pool's
    center f32[3] and half_size f32[]. Returns (rgb f32[C, 3], w f32[C],
    active bool[C], live): live is, with count_live, an int64[] of the
    lane-trips that marched, else None."""
    n = dirs.shape[0] if dirs.ndim == 2 else -1
    _check("dirs", dirs, torch.float32, (n, 3))
    _check("inv_dirs", inv_dirs, torch.float32, (n, 3))
    for name, t, dtype in (("limit", limit, torch.float32),
                           ("start", start, torch.float32),
                           ("miss", miss, torch.bool)):
        _check(name, t, dtype, (n,))
    _check("cache.values", cache.values, torch.int32, cache.values.shape)
    _check("cache.dist", cache.dist, torch.int32, cache.dist.shape)
    _check("center", center, torch.float32, (3,))
    _check("half_size", half_size, torch.float32, ())
    if origin.dtype != torch.float32 or tuple(origin.shape) != (3,):
        raise TypeError(f"{KERNEL}: expected origin f32[3], got "
                        f"{origin.dtype}{list(origin.shape)}")
    if not 1 <= depth <= MAX_DEPTH or not 0 <= dist_level <= depth:
        raise ValueError(f"{KERNEL}: depth {depth} / dist_level "
                         f"{dist_level} outside 1..{MAX_DEPTH} / 0..depth")
    if cache.values.numel() < mips.total_cells(depth):
        raise ValueError(f"{KERNEL}: the mirror holds "
                         f"{cache.values.numel()} cells, depth {depth} "
                         f"needs {mips.total_cells(depth)}")
    if cache.dist.numel() != 1 << (3 * dist_level):
        raise ValueError(f"{KERNEL}: dist holds {cache.dist.numel()} "
                         f"cells, dist_level {dist_level} needs "
                         f"{1 << (3 * dist_level)}")
    if band_iters < 0:
        raise ValueError(f"{KERNEL}: band_iters {band_iters} < 0")
    dev = dirs.device
    if dev.type != "cuda":
        raise ValueError(f"{KERNEL}: expected CUDA tensors, got {dev}")
    for t in (origin, inv_dirs, limit, start, miss, cache.values,
              cache.dist, center, half_size):
        if t.device != dev:
            raise ValueError(f"{KERNEL}: tensors on {t.device} and {dev}")
    rgb = torch.empty((n, 3), dtype=torch.float32, device=dev)
    w = torch.empty((n,), dtype=torch.float32, device=dev)
    active = torch.empty((n,), dtype=torch.bool, device=dev)
    live = (torch.zeros((), dtype=torch.int64, device=dev) if count_live
            else None)
    args = (dirs.data_ptr(), inv_dirs.data_ptr(), limit.data_ptr(),
            start.data_ptr(), miss.data_ptr(), cache.values.data_ptr(),
            cache.dist.data_ptr(), origin.data_ptr(), origin.stride(0),
            center.data_ptr(), half_size.data_ptr(), n, depth, dist_level,
            band_iters, max_range, int(fused_dist), rgb.data_ptr(),
            w.data_ptr(), active.data_ptr(),
            live.data_ptr() if live is not None else None)
    fn = _build.launcher(KERNEL)
    if dev.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, KERNEL)
    LAUNCHES[KERNEL] += 1
    return rgb, w, active, live
