"""Voxel cone tracing: the exact marchers (counterpart:
octree_slam_tpu/render/raycast.py).

Per-step semantics follow coneTrace (cone_tracing_kernels.cu:53-146):
  * cone LOD: target depth = ceil(log2(oct_size / pix_size)) from the pixel
    footprint pix_size = ray_len * pix_scale (:68-69);
  * front-to-back accumulation with alpha = max(0, node_alpha - 127) and
    rgb += (alpha/127) * node_rgb, ending when the accumulated alpha
    reaches 127 (:106-122);
  * rays past the range limit get their colour rescaled by 127/w and
    finish (:131-139).

`cone_trace_dense` marches the dense mirror of map/mips.py: two gathers per
step (one distance-field lookup, one value sample at any level of detail)
and (dist - 1)-cell skips through empty space. `cone_trace` marches the
node pool itself by a stackless root-down descent (:76-103) with a step of
the reached node's half size (:126-129); an `AccelGrid` caches the deepest
existing ancestor of every level-L cell, which cuts the descent from
max_depth gathers to 1 + (max_depth - L). Accumulation is float32 (the
reference adds into uint8 channels, which wrap, :110-112).

All lanes march together under an active-ray mask. The reference package
ends its loops by a test on the device (`lax.while_loop`); here each such
test is a host read, so the loops read it only every `EXIT_CHECK_EVERY`
trips. A trip on which no lane is live writes nothing (every write is
masked by the lane's liveness), so the image is bit-identical to testing
every trip; only the count of trips run differs, and `debug_iters` reports
the count of trips that were needed, kept on the device.

`cone_trace_dense` compacts its live rays as the reference does, and as
the original program relaunches coneTrace over the rays that
thrust::remove_if left live (cone_tracing_kernels.cu:157-198): once the
live count, read at an exit test at or after `compact_after` trips, fits
`compact_cap` lanes, the live lanes are packed into that many lanes, the
tail marches there and its results scatter back. A lane's arithmetic does
not depend on the lanes beside it, so the image is the all-lanes march's
bit for bit.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from octree_slam_tpu_torch.core import packing
from octree_slam_tpu_torch.map import mips
from octree_slam_tpu_torch.map.svo import SVONodePool
from octree_slam_tpu_torch.utils import compaction

# trips between two host reads of a march loop's exit test
EXIT_CHECK_EVERY = 4
# the per-lane state of a march, which compaction gathers and scatters back
LANES = ("ray_len", "rgb", "w", "active")


class AccelGrid(NamedTuple):
    """Dense per-cell entry points at a fixed octree level."""

    entry: torch.Tensor  # i32[G^3] packed (node_idx << 4) | reached_depth

    @property
    def level(self) -> int:
        g3 = self.entry.shape[0]
        level = max(1, round((g3.bit_length() - 1) / 3))
        if (1 << (3 * level)) != g3:
            raise ValueError(f"entry grid of {g3} cells is not a cube of 2^L")
        return level


def build_accel(pool: SVONodePool, *, level: int) -> AccelGrid:
    """Descend every level-L cell to its deepest existing ancestor."""
    g = 1 << level
    cap = pool.capacity
    lin = torch.arange(g * g * g, dtype=torch.int32, device=pool.child.device)
    x = lin & (g - 1)
    y = (lin >> level) & (g - 1)
    z = lin >> (2 * level)

    def octant(l):
        s = level - l
        return (((x >> s) & 1) | (((y >> s) & 1) << 1)
                | (((z >> s) & 1) << 2))

    cur = octant(1)
    d = torch.ones_like(cur)
    for l in range(1, level):
        tile = pool.child[cur]
        go = tile > 0
        cur = torch.where(go, tile + octant(l + 1), cur)
        d = torch.where(go, l + 1, d)
    return AccelGrid(entry=(torch.clamp(cur, max=cap - 1) << 4) | d)


def make_rays(world_T_cam: torch.Tensor, fx, fy, width: int, height: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel unit ray directions in world space (createRays,
    cone_tracing_kernels.cu:29-51, with per-camera focal lengths).
    Returns (origin f32[3], dirs f32[H*W, 3])."""
    dev = world_T_cam.device
    y, x = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev),
        torch.arange(width, dtype=torch.float32, device=dev), indexing="ij")
    d_cam = torch.stack(
        [(x - width / 2.0) / fx, (height / 2.0 - y) / fy,
         torch.ones_like(x)], dim=-1).reshape(-1, 3)
    d_cam = d_cam / torch.linalg.norm(d_cam, dim=-1, keepdim=True)
    return world_T_cam[:3, 3], d_cam @ world_T_cam[:3, :3].T


def _ray_box(origin, dirs, inv_dirs, lo, hi):
    """Slab-method ray/AABB interval per ray: (t_enter f32[N], t_exit
    f32[N]). Axis-parallel rays outside the slab get an empty interval."""
    o = origin[None, :]
    ta = (lo[None, :] - o) * inv_dirs
    tb = (hi[None, :] - o) * inv_dirs
    par = dirs.abs() <= 1e-9
    inside = (o >= lo[None, :]) & (o <= hi[None, :])
    inf = torch.inf
    tmin = torch.where(par, torch.where(inside, -inf, inf),
                       torch.minimum(ta, tb))
    tmax = torch.where(par, torch.where(inside, inf, -inf),
                       torch.maximum(ta, tb))
    return tmin.amax(dim=-1), tmax.amin(dim=-1)


def _start_rays(center, half_size, world_T_cam, fx, fy, width, height,
                max_range, start_dist):
    """Rays clipped to the octree volume: rays that start outside advance
    to their entry face, rays that miss it finish with full alpha and no
    colour, and every ray ends where it leaves the volume (past it the
    position quantization would clamp samples onto boundary cells).
    Returns (origin, dirs, inv_dirs, limit, state)."""
    origin, dirs = make_rays(world_T_cam, fx, fy, width, height)
    inv_dirs = torch.where(dirs.abs() > 1e-9, 1.0 / dirs, torch.inf)
    t0, t1 = _ray_box(origin, dirs, inv_dirs, center - half_size,
                      center + half_size)
    miss = (t0 > t1) | (t1 < 0.0) | (t0 > max_range)
    start = torch.clamp(torch.where(t0 > 0.0, t0 + 1e-4, 0.0),
                        min=start_dist)
    limit = torch.clamp(t1, max=max_range)
    state = dict(
        ray_len=torch.where(miss, max_range, start),
        rgb=torch.zeros_like(dirs),
        w=torch.where(miss, 255.0, 0.0),
        active=~miss,
    )
    return origin, dirs, inv_dirs, limit, state


def _march(body, state, flag: str, max_iters: int, check_every: int):
    """Run `body` until state[flag] reads false on the host, looked at
    after every `check_every` trips, or `max_iters` trips are done."""
    for i in range(1, max_iters + 1):
        state = body(state)
        if i % check_every == 0 and i < max_iters and not bool(state[flag]):
            break
    return state


def _accumulate(s, value, alpha, step, limit):
    """One march sample for every lane, written only to the active ones:
    add the sample, saturate at 127 (:115-121), advance by `step`, and
    rescale and finish past `limit` (:131-139).
    Returns (ray_len, rgb, w, active)."""
    r, g, b, _ = packing.unpack_rgba8(value)
    contrib = (alpha / 127.0)[:, None] * torch.stack(
        [r, g, b], dim=-1).to(torch.float32)
    active = s["active"]
    rgb = torch.where(active[:, None], s["rgb"] + contrib, s["rgb"])
    w_new = s["w"] + torch.where(active, alpha, 0.0)
    saturated = active & (w_new >= 127.0)
    w_out = torch.where(saturated, 255.0, w_new)
    ray_len = torch.where(active, s["ray_len"] + step, s["ray_len"])
    oor = active & ~saturated & (ray_len > limit)
    scale = 127.0 / torch.clamp(w_out, min=1.0)
    rgb = torch.where(oor[:, None], rgb * scale[:, None], rgb)
    w_out = torch.where(oor, 255.0, w_out)
    return ray_len, rgb, w_out, active & ~saturated & ~oor


def _framebuffer(state, height: int, width: int) -> torch.Tensor:
    rgb = torch.clamp(state["rgb"], 0.0, 255.0) / 255.0
    a = torch.clamp(state["w"], 0.0, 255.0) / 255.0
    return torch.cat([rgb, a[:, None]], dim=-1).reshape(height, width, 4)


def _cone_lod(oct_size, ray_len, pix_scale, max_depth: int) -> torch.Tensor:
    """Octree level whose cells match the pixel footprint at ray_len."""
    pix_size = ray_len * pix_scale
    lod = torch.ceil(torch.log2(torch.clamp(
        oct_size / torch.clamp(pix_size, min=1e-9), min=1.0)))
    return torch.clamp(lod.to(torch.int32), 1, max_depth)


def _quantize(pool: SVONodePool, targets: torch.Tensor, max_depth: int):
    """Integer leaf-grid coordinates of world points, clipped to the volume
    (boundary clamping matches the reference's unbounded octant walk)."""
    n_leaf = 1 << max_depth
    bbox0 = pool.center - pool.half_size
    cell = (2.0 * pool.half_size) / n_leaf
    q = torch.floor((targets - bbox0) / cell).to(torch.int32)
    return torch.clamp(q, 0, n_leaf - 1)


def _octant_bits(q: torch.Tensor, max_depth: int, level: int) -> torch.Tensor:
    s = max_depth - level
    return (((q[:, 0] >> s) & 1) | (((q[:, 1] >> s) & 1) << 1)
            | (((q[:, 2] >> s) & 1) << 2))


def _descend(pool: SVONodePool, targets: torch.Tensor, lod_depth: torch.Tensor,
             max_depth: int, accel: AccelGrid | None, accel_level: int):
    """Vectorized stackless descent to min(lod, deepest existing node).
    Returns (value i32[N], reached i32[N])."""
    cap = pool.capacity
    q = _quantize(pool, targets, max_depth)

    if accel is not None:
        shift = max_depth - accel_level
        cx = q[:, 0] >> shift
        cy = q[:, 1] >> shift
        cz = q[:, 2] >> shift
        e = accel.entry[(cz << (2 * accel_level)) | (cy << accel_level) | cx]
        cur = e >> 4
        reached = e & 15
        start = accel_level
        going = (reached == accel_level) & (lod_depth > accel_level)
    else:
        cur = _octant_bits(q, max_depth, 1)
        reached = torch.ones_like(cur)
        start = 1
        going = lod_depth > 1

    for level in range(start, max_depth):
        tile = pool.child[cur]
        go = going & (tile > 0)
        cur = torch.where(go, tile + _octant_bits(q, max_depth, level + 1),
                          cur)
        reached = torch.where(go, level + 1, reached)
        going = go & (lod_depth > level + 1)
    return pool.value[torch.clamp(cur, max=cap - 1)], reached


def cone_trace(pool: SVONodePool, world_T_cam: torch.Tensor, fx, fy, *,
               width: int, height: int, max_depth: int,
               max_iters: int = 96, max_range: float = 10.0,
               start_dist: float = 0.002,
               accel: AccelGrid | None = None,
               accel_level: int = 6,
               exit_check_every: int = EXIT_CHECK_EVERY) -> torch.Tensor:
    """Render the node pool to f32[height, width, 4]: rgb in [0,1], alpha =
    accumulated opacity in [0,1] (1 = ray finished, the uchar4 PBO's 255).
    With an entry grid, rays whose cone LOD is shallower than its level
    sample at that level instead."""
    origin, dirs, _, limit, state = _start_rays(
        pool.center, pool.half_size, world_T_cam, fx, fy, width, height,
        max_range, start_dist)
    pix_scale = 1.0 / fy  # per-pixel angular footprint (replaces :171)
    oct_size = pool.half_size
    state["any"] = state["active"].any()

    def body(s):
        ray_len = s["ray_len"]
        target = origin + dirs * ray_len[:, None]
        lod = _cone_lod(oct_size, ray_len, pix_scale, max_depth)
        value, reached = _descend(pool, target, lod, max_depth, accel,
                                  accel_level)
        alpha = torch.clamp(packing.alpha_of(value) - 127,
                            min=0).to(torch.float32)
        # march by the reached node's half size (:126-129)
        step = oct_size / torch.exp2(reached.to(torch.float32))
        ray_len, rgb, w, active = _accumulate(s, value, alpha, step, limit)
        return dict(ray_len=ray_len, rgb=rgb, w=w, active=active,
                    any=active.any())

    state = _march(body, state, "any", max_iters, exit_check_every)
    return _framebuffer(state, height, width)


@functools.lru_cache(maxsize=4)
def _spread3(bits: int, device: str) -> torch.Tensor:
    """i32[2^bits] on the device: every value with its bits spread to
    every third position, so that interleave3(x, y, z) is three look-ups
    and two shifts instead of a loop over the bits."""
    v = torch.arange(1 << bits, dtype=torch.int32, device=device)
    zero = torch.zeros_like(v)
    return mips.interleave3(v, zero, zero, bits)


def cone_trace_dense(cache, center: torch.Tensor, half_size, world_T_cam,
                     fx, fy, *, width: int, height: int, max_depth: int,
                     dist_level: int = 6, max_iters: int = 48,
                     max_range: float = 10.0, start_dist: float = 0.002,
                     max_skip: int = 7, debug_iters: bool = False,
                     compact_after: int = 12,
                     compact_cap: int | None = None,
                     exit_check_every: int = EXIT_CHECK_EVERY):
    """Cone trace the dense value-mip render cache (map/mips.py): the
    accumulation of cone_trace with two gathers per step in place of the
    per-level descent, and empty space crossed in (dist - 1)-cell skips.

    Phase 1 only skips: it advances rays through free space (one gather
    per step; free cells contribute no alpha) until every live ray sits in
    an occupied dist cell or has left the range. Phase 2 samples and steps
    until no ray is live. Each phase runs at most `max_iters` trips.

    Phase 2 runs over all lanes until an exit test at or after
    `compact_after` trips reads a live count of at most C lanes (C is
    `compact_cap`, else max(128, n // 4)); then the live lanes are packed
    into C lanes (compaction.live_first), the tail marches there and its
    results scatter back. The image is the all-lanes march's bit for bit.
    The live count takes the place of the exit test's flag: one host read
    either way. No compaction when C >= n, compact_after >= max_iters or
    with debug_iters, whose per-pixel `fin` wants every lane.

    `max_skip` is accepted for the reference's signature and not used: the
    skip length comes from `cache.dist`, saturated where map/mips.py
    makes it.
    debug_iters=True also returns dict(p1_trips, p2_trips, fin): the trips
    each phase needed and, per pixel, the phase-2 trip on which its ray
    finished."""
    origin, dirs, inv_dirs, limit, state = _start_rays(
        center, half_size, world_T_cam, fx, fy, width, height, max_range,
        start_dist)
    dev = dirs.device
    n = dirs.shape[0]
    pix_scale = 1.0 / fy

    n_leaf = 1 << max_depth
    bbox0 = center - half_size
    leaf_cell = (2.0 * half_size) / n_leaf
    cell_l = (2.0 * half_size) / (1 << dist_level)  # dist-grid cell edge
    oct_size = half_size
    shift_l = max_depth - dist_level
    eps = 0.05 * leaf_cell
    min_step = 0.25 * leaf_cell
    linf = torch.clamp(dirs.abs().amax(dim=-1), min=1e-6)
    moves = dirs.abs() > 1e-9
    forward = dirs > 0
    spread = _spread3(max_depth, str(dev))

    def quantize(pos):
        return torch.clamp(torch.floor((pos - bbox0) / leaf_cell)
                           .to(torch.int32), 0, n_leaf - 1)

    def dist_at(q):
        c = q >> shift_l
        return cache.dist[(c[:, 2] << (2 * dist_level))
                          | (c[:, 1] << dist_level) | c[:, 0]]

    def make_cell_exit(inv_, moves_, forward_):
        def cell_exit(pos, q, shift, cell):
            """Ray length to the exit of the cell of edge `cell` (leaf
            cells >> shift) that holds pos; shift and cell are scalars or
            [N, 1]."""
            corner = bbox0 + (q >> shift).to(torch.float32) * cell
            t_axis = torch.where(
                moves_,
                torch.where(forward_, corner + cell - pos, corner - pos)
                * inv_,
                torch.inf)  # axis-parallel rays never leave through this face
            return torch.clamp(t_axis.amin(dim=-1), min=0.0)
        return cell_exit

    cell_exit = make_cell_exit(inv_dirs, moves, forward)
    zero = torch.zeros((), dtype=torch.int32, device=dev)

    def skip_body(s):
        ray_len = s["ray_len"]
        pos = origin + dirs * ray_len[:, None]
        q = quantize(pos)
        d = dist_at(q)
        free = s["active"] & (d > 0)
        t_exit = cell_exit(pos, q, shift_l, cell_l)
        skip = (d - 1).to(torch.float32) * cell_l / linf
        step = torch.maximum(t_exit + skip + eps, min_step)
        ray_len = torch.where(free, ray_len + step, ray_len)
        oor = s["active"] & (ray_len > limit)
        nxt = dict(ray_len=ray_len, rgb=s["rgb"],
                   w=torch.where(oor, 255.0, s["w"]),
                   active=s["active"] & ~oor, moving=(free & ~oor).any())
        if debug_iters:
            nxt["it"] = s["it"] + s["moving"]
        return nxt

    state["moving"] = torch.ones((), dtype=torch.bool, device=dev)
    if debug_iters:
        state["it"] = zero
    state = _march(skip_body, state, "moving", max_iters, exit_check_every)
    if debug_iters:
        p1_trips = state["it"]
        state["it"] = zero
        state["fin"] = torch.where(state["active"], max_iters, 0).to(
            torch.int32)

    def make_body(dirs_, inv_, linf_, limit_, moves_, forward_):
        """Phase 2's trip over a set of lanes, the whole frame or the live
        lanes packed: the per-lane arithmetic is the same either way."""
        exit_ = make_cell_exit(inv_, moves_, forward_)

        def body(s):
            ray_len = s["ray_len"]
            pos = origin + dirs_ * ray_len[:, None]
            q = quantize(pos)

            # distance-field lookup (gather 1)
            d = dist_at(q)
            free = d > 0

            # value sample at the cone's level of detail (gather 2)
            lod = _cone_lod(oct_size, ray_len, pix_scale, max_depth)
            shift = max_depth - lod
            c = spread[(q >> shift[:, None]).to(torch.int64)]
            m = c[:, 0] | (c[:, 1] << 1) | (c[:, 2] << 2)
            value = cache.values[mips.level_offsets(lod) + m]
            alpha = torch.where(free, 0.0, torch.clamp(
                packing.alpha_of(value) - 127, min=0).to(torch.float32))

            # step: the exact exit of the current cell, plus dist - 1
            # cells of the guaranteed-empty L-infinity ball when in free
            # space
            s_lod = oct_size * 2.0 / torch.exp2(lod.to(torch.float32))
            lev_cell = torch.where(free, cell_l, s_lod)
            lev_shift = torch.where(free, shift_l, shift)
            t_exit = exit_(pos, q, lev_shift[:, None], lev_cell[:, None])
            skip = torch.where(
                free, (d - 1).to(torch.float32) * cell_l / linf_, 0.0)
            step = torch.maximum(t_exit + skip + eps, min_step)
            ray_len, rgb, w, live = _accumulate(s, value, alpha, step,
                                                limit_)
            nxt = dict(ray_len=ray_len, rgb=rgb, w=w, active=live,
                       n_act=live.sum(dtype=torch.int32))
            if debug_iters:
                nxt["it"] = s["it"] + (s["n_act"] > 0)
                nxt["fin"] = torch.where(s["active"] & ~live, nxt["it"],
                                         s["fin"])
            return nxt

        return body

    cap = compact_cap if compact_cap is not None else max(128, n // 4)
    compacts = not debug_iters and cap < n and compact_after < max_iters
    body = make_body(dirs, inv_dirs, linf, limit, moves, forward)
    state["n_act"] = state["active"].sum(dtype=torch.int32)
    full = sel = None
    for i in range(1, max_iters + 1):
        state = body(state)
        if i % exit_check_every or i == max_iters:
            continue
        if compacts and sel is None and i >= compact_after:
            n_act = int(state["n_act"])
            if n_act == 0:
                break
            if n_act <= cap:
                # lanes outside `sel` finished already and keep their
                # values in `full`
                full, sel = state, compaction.live_first(state["active"],
                                                         cap)
                state = {k: full[k][sel] for k in LANES}
                state["n_act"] = full["n_act"]
                body = make_body(dirs[sel], inv_dirs[sel], linf[sel],
                                 limit[sel], moves[sel], forward[sel])
        elif not bool(state["n_act"]):
            break
    if sel is not None:
        for k in LANES:
            full[k].index_copy_(0, sel, state[k])
        state = full
    fb = _framebuffer(state, height, width)
    if debug_iters:
        return fb, dict(p1_trips=p1_trips, p2_trips=state["it"],
                        fin=state["fin"].reshape(height, width))
    return fb


def to_u8(framebuffer: torch.Tensor) -> torch.Tensor:
    """f32 [0,1] rgba -> u8, the PBO-style output."""
    return torch.round(torch.clamp(framebuffer, 0.0, 1.0) * 255.0).to(
        torch.uint8)
