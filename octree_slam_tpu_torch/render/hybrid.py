"""Hybrid cone renderer: slab composite plus a seeded exact march of the
edge band (counterpart: octree_slam_tpu/render/hybrid.py).

The slab compositor (render/conesplat.py) is close to the exact per-ray
march everywhere but in the edge band: pixels at luminance gradients,
dilated a few pixels, where grazing halos and sub-leaf assignment at
silhouettes carry most of its error. The exact march
(raycast.cone_trace_dense) renders those pixels right but spends most of
its trips crossing empty space towards the first surface. This module
joins the two:

  1. Render the slab image and take, per pixel, the near boundary of the
     first slab that contributed (render_cone_splat, want_aux).
  2. Select the `band_cap` pixels of highest priority (the slab image's
     luminance gradient, max-pooled over a (2*grad_dilate+1)^2 window) and
     compact them into march lanes, in raster order.
  3. March only those rays, each seeded at the slab's own conservative
     first-hit depth (the minimum of z_first over a (2*seed_halo+1)^2
     window, less one leaf): the slab image is the march's acceleration
     structure. The march runs a fixed `band_iters` trips with no exit
     test, so it reads nothing back to the host.
  4. Write the marched colours over the slab image: finished rays as they
     are; rays still active at the cap composite their partial front onto
     the slab pixel, which stands in for the tail that was not marched (a
     capped ray with w == 0 is the slab pixel).

Samples read the leaf level of the dense mirror always: at SLAM ranges the
cone's footprint is below a leaf (z < fx * leaf_size), which is the sample
the full march takes, and it lets lazy frames keep the mirror current with
one leaf scatter and one occupancy scatter (pipeline._fuse_once,
leaf_mirror). With `fused_dist` the trip is one gather: free leaf cells
carry their covering dist cell's distance in the low byte
(mips.encode_free_dist), and occupied leaves sit in distance-0 cells, so
the word gives the cell's class exactly as the second gather of
`cache.dist` would; the two give bit-identical images.

Where the image departs from the full exact march: pixels outside the band
keep the slab image; capped rays blend with the slab pixel; samples beyond
the leaf-LOD range read leaves where the full march reads a coarser level;
and a ray whose seed window shows nothing at any slab although geometry
lies nearer starts past that geometry.

The reference's four experimental knobs, all off by default, are here
as its SLAMConfig fields set them:
  * `depth_prio > 0` maxes a depth-jump term into the priority before the
    dilation: the jump of z_first against the left and upper neighbour
    relative to the nearer depth (+inf read as 4 z_far), saturating at
    30% of it, times depth_prio;
  * `sel_decimate` takes the top C/4 of the priorities max-pooled at
    stride 2 and expands each 2x2 block to its pixels (when C % 4 == 0
    and the image's sides are even; the full top-C otherwise);
  * `crawl = K > 1` takes K leaf samples a trip with one gather of the
    values; it applies to the fixed-trip march only;
  * `compact_after < band_iters` (with C2 = max(128, C // 4) lanes
    below C) selects the reference's compacting march: single samples
    until no lane is live or band_iters trips, its live lanes packed into
    C2 lanes (compaction.live_first) once at least compact_after trips are
    done and the live count fits, and scattered back before the merge. A
    lane's arithmetic does not depend on the lanes beside it, so the image
    is the all-lanes march's bit for bit. The exit is tested every
    raycast.EXIT_CHECK_EVERY trips, one host read each (the live count
    from compact_after on), and debug_band's `trips` counts the trips that
    had a live lane, as the reference's does (its `packed_at`: the trip
    after which the lanes were packed, 0 if they were not).
The reference's authors measured each of them on their TPU and kept them
off; chip_smoke.py's `[knobs]` phase reads each one's PSNR and render time
on the card.

Where the trips run (`_band_kernel`, by what the call observes): on a
CUDA device the fixed-trip march with crawl 1 is one launch of the
hand-written kernel band_ops.band_march, one thread a lane with every trip
in registers, equal word for word to the eager loop on the card; the CPU,
the compacting march and crawl > 1 run the eager loop (`_trips_eager`),
~78 PyTorch launches a trip on a card. The ray set-up (seeds, rays, the
box, start and limit) is PyTorch on both paths.

`band_march_merge` is three spans (utils/spans.py): "band.select" (the
priorities and the top-C selection), "band.march" (seeds, ray set-up and
the trips) and "band.merge". It counts the lanes marched (`band_lanes`,
C), the trips run (`band_trips`; the compacting march's device count), the
path the trips took (`band_kernel` or `band_eager`, one a call) and,
while the recorder is on, the lane-trips that still marched
(`band_live_lane_trips`: the live lanes summed over the trips on the
device, read at the recorder's stop()).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from octree_slam_tpu_torch.core import packing
from octree_slam_tpu_torch.map import mips
from octree_slam_tpu_torch.render import band_ops, conesplat
from octree_slam_tpu_torch.render.conesplat import SlabSpec
from octree_slam_tpu_torch.render.raycast import (EXIT_CHECK_EVERY,
                                                  _ray_box, _spread3,
                                                  make_rays)
from octree_slam_tpu_torch.render.splat import LeafList
from octree_slam_tpu_torch.utils import compaction, spans


def render_cone_hybrid(leaves: LeafList, cache, center: torch.Tensor,
                       half_size, world_T_cam: torch.Tensor, fx, fy, *,
                       spec: SlabSpec, depth: int, dist_level: int,
                       max_range: float = 10.0, start_dist: float = 0.002,
                       band_cap: int = 0, band_iters: int = 12,
                       compact_after: int = 999, grad_dilate: int = 2,
                       seed_halo: int = 4, crawl: int = 1,
                       fused_dist: bool = False, depth_prio: float = 0.0,
                       dilate: int = 1, debug_band: bool = False,
                       sel_decimate: bool = False):
    """Slab image with the edge band re-rendered by the seeded exact march.

    `cache` is the dense mirror (mips.RenderCache); only its leaf level and
    the dist field are read. Returns f32[H, W, 4]; with debug_band also a
    dict of band diagnostics."""
    fb, _, z_first = conesplat.render_cone_splat(
        leaves, center, half_size, world_T_cam, fx, fy, spec=spec,
        depth=depth, dilate=dilate, want_aux=True)
    return band_march_merge(
        fb, z_first, cache, center, half_size, world_T_cam, fx, fy,
        spec=spec, depth=depth, dist_level=dist_level, max_range=max_range,
        start_dist=start_dist, band_cap=band_cap, band_iters=band_iters,
        compact_after=compact_after, grad_dilate=grad_dilate,
        seed_halo=seed_halo, crawl=crawl, fused_dist=fused_dist,
        depth_prio=depth_prio, debug_band=debug_band,
        sel_decimate=sel_decimate)


def _pool_max(img: torch.Tensor, half: int) -> torch.Tensor:
    """Maximum of f32[H, W] over a (2*half+1)^2 window, outside the image
    counting as -inf (for an image >= 0 that is the reference's pad of 0)."""
    return F.max_pool2d(img[None, None], 2 * half + 1, stride=1,
                        padding=half)[0, 0]


def _pool_min(img: torch.Tensor, half: int) -> torch.Tensor:
    """Minimum over the same window, outside the image counting as +inf:
    the negated max-pool of the negated image."""
    return -_pool_max(-img, half)


def band_march_merge(fb, z_first, cache, center: torch.Tensor, half_size,
                     world_T_cam: torch.Tensor, fx, fy, *, spec: SlabSpec,
                     depth: int, dist_level: int, max_range: float = 10.0,
                     start_dist: float = 0.002, band_cap: int = 0,
                     band_iters: int = 12, compact_after: int = 999,
                     grad_dilate: int = 2, seed_halo: int = 4,
                     crawl: int = 1, fused_dist: bool = False,
                     depth_prio: float = 0.0, debug_band: bool = False,
                     sel_decimate: bool = False):
    """Steps 2-4 of the hybrid (band select, seeded march, merge) on a slab
    image and its z_first (conesplat's want_aux outputs). `fb` is not
    written; the result is a new image. The knobs are the reference's (see
    the module docstring)."""
    n = spec.width * spec.height
    C = min(band_cap if band_cap > 0 else max(128, n // 4), n)
    C2 = max(128, C // 4)
    spans.count("band_lanes", C)
    with spans.span("band.select"):
        sel = _select(fb, z_first, spec, C, grad_dilate, depth_prio,
                      sel_decimate)
    with spans.span("band.march"):
        rgb, w, active, trips, packed_at, start = _march(
            sel, z_first, cache, center, half_size, world_T_cam, fx, fy,
            spec=spec, depth=depth, dist_level=dist_level,
            max_range=max_range, start_dist=start_dist, band_iters=band_iters,
            compact_after=compact_after, seed_halo=seed_halo, crawl=crawl,
            fused_dist=fused_dist, C=C, C2=C2)
    with spans.span("band.merge"):
        out = _merge(fb, sel, rgb, w, active)
    if debug_band:
        return out, dict(sel=sel, use_march=~active | (w > 0.0),
                         trips=int(trips), capped=active, seed_t=start, w=w,
                         packed_at=packed_at)
    return out


def _select(fb, z_first, spec: SlabSpec, C: int, grad_dilate: int,
            depth_prio: float, sel_decimate: bool) -> torch.Tensor:
    """The band's C pixel indices, in raster order."""
    W, H = spec.width, spec.height
    dev = fb.device

    # --- band selection: the slab image's luminance gradient against the
    # left and upper neighbour (with depth_prio, maxed with the relative
    # jump of z_first), max-pooled so that the band reaches grad_dilate
    # pixels to each side of an edge. The stable descending sort resolves
    # the many exact ties of the pooled priorities (every flat region reads
    # 0) by index, as the reference's does; the selected lanes are then
    # put in raster order, so that adjacent lanes gather adjacent cells. ---
    lum = fb[..., 0] * 0.299 + fb[..., 1] * 0.587 + fb[..., 2] * 0.114
    gx = (lum - torch.cat([lum[:, :1], lum[:, :-1]], dim=1)).abs()
    gy = (lum - torch.cat([lum[:1, :], lum[:-1, :]], dim=0)).abs()
    grad = torch.maximum(gx, gy)
    if depth_prio > 0.0:
        # occlusion boundaries between surfaces of one colour leave no
        # luminance edge: the jump of z_first relative to the nearer
        # depth, saturating at 30% of it (one slab of the ladder)
        zf = torch.where(torch.isfinite(z_first), z_first, spec.z_far * 4.0)
        left = torch.cat([zf[:, :1], zf[:, :-1]], dim=1)
        up = torch.cat([zf[:1, :], zf[:-1, :]], dim=0)
        znear2 = torch.minimum(zf, torch.minimum(left, up))
        gz = torch.maximum((zf - left).abs(), (zf - up).abs()) \
            / torch.clamp(znear2 * 0.3, min=1e-3)
        grad = torch.maximum(grad, depth_prio * torch.clamp(gz, 0.0, 1.0))
    if sel_decimate and C % 4 == 0 and W % 2 == 0 and H % 2 == 0:
        # the top C/4 of the pooled priorities at stride 2, each 2x2 block
        # expanded to its four pixels. XLA's "SAME" window at stride 2
        # pads (k - 2) // 2 before and the rest after; the priorities are
        # >= 0, so a pad of 0 is the reference's init value
        k = 2 * grad_dilate + 1
        lo = max(k - 2, 0) // 2
        hi = max(k - 2, 0) - lo
        priob = F.max_pool2d(F.pad(grad, (lo, hi, lo, hi))[None, None], k,
                             stride=2)[0, 0]
        wb = priob.shape[1]
        selb = torch.argsort(-priob.reshape(-1), stable=True)[:C // 4]
        by = torch.div(selb, wb, rounding_mode="floor")
        bx = selb % wb
        px = ((2 * by) * W + 2 * bx)[:, None] + torch.tensor(
            [0, 1, W, W + 1], dtype=selb.dtype, device=dev)[None, :]
        sel = torch.sort(px.reshape(-1)).values
    else:
        prio = _pool_max(grad, grad_dilate)
        sel = torch.sort(torch.argsort(-prio.reshape(-1),
                                       stable=True)[:C]).values
    return sel


def _band_kernel(device: torch.device, C: int, C2: int, compact_after: int,
                 band_iters: int, crawl: int) -> bool:
    """The band's trips run as band_ops' CUDA kernel: on a CUDA device, in
    the fixed-trip shape (no lane packing) with one sample a trip. The CPU,
    the compacting march and crawl > 1 run the eager loop."""
    return (device.type == "cuda" and _fixed_trips(C, C2, compact_after,
                                                   band_iters)
            and crawl == 1)


def _fixed_trips(C: int, C2: int, compact_after: int, band_iters: int
                 ) -> bool:
    """The march runs band_iters trips over all C lanes, with no exit test:
    the production shape, which reads nothing back to the host."""
    return C2 >= C or compact_after >= band_iters


def _march(sel, z_first, cache, center, half_size, world_T_cam, fx, fy, *,
           spec: SlabSpec, depth: int, dist_level: int, max_range: float,
           start_dist: float, band_iters: int, compact_after: int,
           seed_halo: int, crawl: int, fused_dist: bool, C: int, C2: int):
    """The seeded march of the band's lanes `sel`. Returns (rgb, w, active,
    trips, packed_at, start): the lanes' accumulated colour and weight,
    the lanes still active at the trip cap, the trips (an int, or the
    compacting march's device count), the trip after which the lanes were
    packed (0: not) and each lane's start."""
    dev = z_first.device
    # the kernel reads the pool's 0-d half_size on the device; both paths
    # derive the march's constants from it alike
    half_size = torch.as_tensor(half_size, dtype=torch.float32, device=dev)
    origin, dirs, inv_dirs, limit, start, miss = _rays(
        sel, z_first, center, half_size, world_T_cam, fx, fy, spec=spec,
        depth=depth, max_range=max_range, start_dist=start_dist,
        seed_halo=seed_halo)

    count_live = spans.recording()
    if _band_kernel(dev, C, C2, compact_after, band_iters, crawl):
        spans.count("band_kernel")
        rgb, w, active, live = band_ops.band_march(
            origin, dirs, inv_dirs, limit, start, miss, cache, center,
            half_size, depth=depth, dist_level=dist_level,
            max_range=max_range, band_iters=band_iters,
            fused_dist=fused_dist, count_live=count_live)
        trips, packed_at = band_iters, 0
    else:
        spans.count("band_eager")
        rgb, w, active, trips, packed_at, live = _trips_eager(
            origin, dirs, inv_dirs, limit, start, miss, cache, center,
            half_size, depth=depth, dist_level=dist_level,
            max_range=max_range, band_iters=band_iters,
            compact_after=compact_after, crawl=crawl, fused_dist=fused_dist,
            C2=C2, count_live=count_live)
    if isinstance(trips, int):
        spans.count("band_trips", trips)
    else:
        spans.count_device("band_trips", trips)
    if count_live:
        spans.count_device("band_live_lane_trips", live)
    return rgb, w, active, trips, packed_at, start


def _rays(sel, z_first, center, half_size, world_T_cam, fx, fy, *,
          spec: SlabSpec, depth: int, max_range: float, start_dist: float,
          seed_halo: int):
    """The band lanes' rays, clipped to the octree volume and seeded from
    the slab image: (origin f32[3], dirs and inv_dirs f32[C, 3], limit and
    start f32[C], miss bool[C])."""
    W, H = spec.width, spec.height

    # --- seeds: one leaf before the nearest first-contributing slab
    # boundary of the pixel's neighbourhood (z_first is +inf where no slab
    # contributed) ---
    leaf_cell = (2.0 * half_size) / (1 << depth)
    seed_z = torch.clamp(_pool_min(z_first, seed_halo) - leaf_cell,
                         min=0.0).reshape(-1)[sel]

    origin, dirs_all = make_rays(world_T_cam, fx, fy, W, H)
    dirs = dirs_all[sel]
    # camera-space z per unit of ray length: z = t * dz
    xr = ((sel % W).to(torch.float32) - W / 2.0) / fx
    yr = (H / 2.0 - torch.div(sel, W, rounding_mode="floor")
          .to(torch.float32)) / fy
    dz = 1.0 / torch.sqrt(xr * xr + yr * yr + 1.0)

    inv_dirs = torch.where(dirs.abs() > 1e-9, 1.0 / dirs, torch.inf)
    t0, t1 = _ray_box(origin, dirs, inv_dirs, center - half_size,
                      center + half_size)
    miss = (t0 > t1) | (t1 < 0.0) | (t0 > max_range)
    start = torch.clamp(torch.where(t0 > 0.0, t0 + 1e-4, 0.0),
                        min=start_dist)
    t_seed = torch.where(torch.isfinite(seed_z), seed_z / dz, 0.0)
    limit = torch.clamp(t1, max=max_range)
    start = torch.minimum(torch.maximum(start, t_seed), limit)
    return origin, dirs, inv_dirs, limit, start, miss


def _trips_eager(origin, dirs, inv_dirs, limit, start, miss, cache, center,
                 half_size, *, depth: int, dist_level: int, max_range: float,
                 band_iters: int, compact_after: int, crawl: int,
                 fused_dist: bool, C2: int, count_live: bool):
    """The march's trips over the lanes (rays from `origin` along `dirs`,
    from `start` to `limit`; `miss` lanes finish at once) in PyTorch
    launches: the plain version of band_ops.band_march, and the only
    version of the compacting march and of crawl > 1. Returns (rgb, w,
    active, trips, packed_at, live): live is, with count_live, the 0-d
    count of the lane-trips that marched, else 0."""
    dev = dirs.device
    C = dirs.shape[0]
    live = 0

    # --- seeded exact march over the band lanes: cone_trace_dense's body
    # at the fixed leaf level, the same accumulation and ending rules ---
    n_leaf = 1 << depth
    bbox0 = center - half_size
    leaf_cell = (2.0 * half_size) / (1 << depth)
    cell_l = (2.0 * half_size) / (1 << dist_level)
    shift_l = depth - dist_level
    leaf_off = mips.level_offset(depth)
    eps = 0.05 * leaf_cell
    min_step = 0.25 * leaf_cell
    spread = _spread3(depth, str(dev))
    moves = dirs.abs() > 1e-9
    forward = dirs > 0
    linf = torch.clamp(dirs.abs().amax(dim=-1), min=1e-6)

    def quantize(pos):
        return torch.clamp(torch.floor((pos - bbox0) / leaf_cell)
                           .to(torch.int32), 0, n_leaf - 1)

    def leaf_index(q):
        c = spread[q.to(torch.int64)]
        return leaf_off + (c[..., 0] | (c[..., 1] << 1) | (c[..., 2] << 2))

    def dist_at(q):
        cq = q >> shift_l
        return cache.dist[(cq[:, 2] << (2 * dist_level))
                          | (cq[:, 1] << dist_level) | cq[:, 0]]

    def lane_march(dirs, inv_dirs, linf, limit, moves, forward):
        """The single-sample and the crawl trip over a set of lanes (the
        band, or its live lanes packed): the per-lane arithmetic is the
        same either way."""

        def exit_len(pos, corner, cell):
            """Ray length from `pos` to the exit of the cell at `corner`."""
            t_axis = torch.where(
                moves,
                torch.where(forward, corner + cell - pos, corner - pos)
                * inv_dirs, torch.inf)
            return torch.clamp(t_axis.amin(dim=-1), min=0.0)

        def take(t, rgb, w, active, alpha, col, t_next):
            """One sample of alpha and colour `col` into the live lanes,
            which then move to t_next: the march's accumulation, its
            saturation at w >= 127 and its 127/w rescale of a ray that
            leaves the range."""
            rgb = torch.where(active[:, None],
                              rgb + (alpha / 127.0)[:, None] * col, rgb)
            w_new = w + torch.where(active, alpha, 0.0)
            saturated = active & (w_new >= 127.0)
            w = torch.where(saturated, 255.0, w_new)
            t = torch.where(active, t_next, t)
            oor = active & ~saturated & (t_next > limit)
            scale = 127.0 / torch.clamp(w, min=1.0)
            rgb = torch.where(oor[:, None], rgb * scale[:, None], rgb)
            w = torch.where(oor, 255.0, w)
            return t, rgb, w, active & ~saturated & ~oor

        def trip(t, rgb, w, active):
            """One sample a lane, then a step to the exit of its cell,
            plus the guaranteed-empty skip when the cell is free."""
            pos = origin + dirs * t[:, None]
            q = quantize(pos)
            r, g, b, a = packing.unpack_rgba8(cache.values[leaf_index(q)])
            if fused_dist:
                d = torch.where(a > packing.OCCUPIED_ALPHA, 0, r)
            else:
                d = dist_at(q)
            free = d > 0
            # free cells read alpha 0 either way: EMPTY_VALUE's byte is 127
            # and a stamped free cell's is 0
            alpha = torch.where(
                free, 0.0, torch.clamp(a - 127, min=0).to(torch.float32))
            shift = (free.to(torch.int32) * shift_l)[:, None]
            cell = torch.where(free, cell_l, leaf_cell)[:, None]
            t_exit = exit_len(
                pos, bbox0 + (q >> shift).to(torch.float32) * cell, cell)
            skip = torch.where(
                free, (d - 1).to(torch.float32) * cell_l / linf, 0.0)
            return take(t, rgb, w, active, alpha,
                        torch.stack([r, g, b], dim=-1).to(torch.float32),
                        t + torch.maximum(t_exit + skip + eps, min_step))

        def crawl_trip(t, rgb, w, active):
            """`crawl` leaf samples a lane in one gather of the values:
            the sample positions are successive leaf-cell exits, pure ray
            geometry; the last sample's t is the larger of the crawled
            extent and the dist field's guaranteed-free advance (read from
            `cache.dist` even with fused_dist). A free leaf cell reads
            alpha 0: an empty cell's byte is 127, a stamped one's 0."""
            pos0 = origin + dirs * t[:, None]
            q0 = quantize(pos0)
            d = dist_at(q0)
            exit_l = exit_len(
                pos0, bbox0 + (q0 >> shift_l).to(torch.float32) * cell_l,
                cell_l)
            skip = (d - 1).to(torch.float32) * cell_l / linf
            t_skip = torch.where(
                d > 0, t + torch.maximum(exit_l + skip + eps, min_step), 0.0)
            tts, qs, tt = [], [], t
            for _ in range(crawl):
                ppos = origin + dirs * tt[:, None]
                qq = quantize(ppos)
                qs.append(qq)
                tt = tt + torch.maximum(
                    exit_len(ppos, bbox0 + qq.to(torch.float32) * leaf_cell,
                             leaf_cell) + eps, min_step)
                tts.append(tt)
            tts[-1] = torch.maximum(tts[-1], t_skip)
            r, g, b, a = packing.unpack_rgba8(
                cache.values[leaf_index(torch.stack(qs, dim=1))])
            alpha_k = torch.clamp(a - 127, min=0).to(torch.float32)
            rgb_k = torch.stack([r, g, b], dim=-1).to(torch.float32)
            for i in range(crawl):
                t, rgb, w, active = take(t, rgb, w, active, alpha_k[:, i],
                                         rgb_k[:, i], tts[i])
            return t, rgb, w, active

        return trip, crawl_trip

    geometry = (dirs, inv_dirs, linf, limit, moves, forward)
    trip, crawl_trip = lane_march(*geometry)
    lanes = (torch.where(miss, max_range, start),
             torch.zeros((C, 3), dtype=torch.float32, device=dev),
             torch.where(miss, 255.0, 0.0), ~miss)
    if _fixed_trips(C, C2, compact_after, band_iters):
        # the fixed-trip march, the production shape: band_iters trips
        # with no exit test, so it reads nothing back to the host; only
        # this shape takes `crawl` (band_iters then counts trips of up to
        # `crawl` samples)
        body = crawl_trip if crawl > 1 else trip
        for _ in range(band_iters):
            if count_live:
                live = live + lanes[3].sum()
            lanes = body(*lanes)
        trips, packed_at = band_iters, 0
    else:
        # the reference's compacting march: single samples until no lane
        # is live or band_iters trips, the live lanes packed into C2 lanes
        # at the first exit test at or after compact_after trips where
        # they fit. `trips` counts, on the device, the trips that had a
        # live lane, the reference's count
        needed = torch.zeros((), dtype=torch.int32, device=dev)
        full = sub = None
        packed_at = 0
        for i in range(1, band_iters + 1):
            needed = needed + lanes[3].any().to(torch.int32)
            if count_live:
                live = live + lanes[3].sum()
            lanes = trip(*lanes)
            if i % EXIT_CHECK_EVERY or i == band_iters:
                continue
            if sub is None and i >= compact_after:
                n_act = int(lanes[3].sum())
                if n_act == 0:
                    break
                if n_act <= C2:
                    # lanes outside `sub` finished already and keep their
                    # values in `full`
                    full, sub = lanes, compaction.live_first(lanes[3], C2)
                    packed_at = i
                    lanes = tuple(x[sub] for x in full)
                    trip, _ = lane_march(*(g[sub] for g in geometry))
            elif not bool(lanes[3].any()):
                break
        if sub is not None:
            lanes = tuple(x.index_copy_(0, sub, y)
                          for x, y in zip(full, lanes))
        trips = needed
    _, rgb, w, active = lanes
    return rgb, w, active, trips, packed_at, live


def _merge(fb, sel, rgb, w, active) -> torch.Tensor:
    """The band's marched colours written over the slab image (a new
    image)."""
    H, W = fb.shape[:2]
    n = H * W

    # --- merge. Finished rays are the exact march. Rays still active at
    # the trip cap (grazers that crawl leaf by leaf through occupied dist
    # cells) composite their partial front onto the slab pixel, the
    # march's own front-to-back rule with the slab as the tail. ---
    capped = active
    out = fb.reshape(n, 4).clone()
    front01 = torch.clamp(rgb, 0.0, 255.0) / 255.0
    rem = torch.clamp(1.0 - w / 127.0, 0.0, 1.0)
    blended = torch.clamp(front01 + rem[:, None] * out[sel, :3], 0.0, 1.0)
    merged_rgb = torch.where(capped[:, None], blended, front01)
    merged_a = torch.where(capped, 1.0, torch.clamp(w, 0.0, 255.0) / 255.0)
    out[sel] = torch.cat([merged_rgb, merged_a[:, None]], dim=-1)
    return out.reshape(H, W, 4)
