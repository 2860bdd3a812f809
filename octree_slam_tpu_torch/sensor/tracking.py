"""Point-to-plane ICP camera tracking over an image pyramid (counterpart:
octree_slam_tpu/sensor/tracking.py).

Same estimator as the reference package: projective association by pixel
index, the symmetric point-to-plane residual with Huber IRLS weights (the
config defaults), a 6x6 normal-equation solve by Cholesky and an SE(3)
exponential update, coarse to fine with cfg.pyramid_iters. The Gram
products are strict float32 (the JAX code's Precision.HIGHEST): callers on
a GPU keep torch.backends.cuda.matmul.allow_tf32 False, its default.

Divergence handling: torch.linalg.cholesky_ex reports a matrix that is not
positive definite through `info` instead of NaNs, so the solve maps
info > 0 to NaN and the update is frozen exactly as in the JAX code. The
Gauss-Newton loop reads nothing back to the host.

With cfg.w_rgbd > 0 every iteration adds the photometric term
(`rgbd_normal_equations`); `track(..., init_T=)` seeds the iterations for
keyframe anchoring.

On a CUDA device the whole coarse-to-fine solve of one frame is one CUDA
graph (`_track_graph`): the eager loop captured once per key (the shapes,
the device and the configuration fields the loop reads) and replayed on
every later call, so the ~2,500 small kernels of 19 iterations cost one
launch. Shapes and iteration counts are fixed by the configuration and
nothing in the loop reads the host, so the replay runs the eager loop's
kernels on the same data and gives its bits. `CALLS` counts the calls by
path.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import torch

from octree_slam_tpu_torch.config import SLAMConfig
from octree_slam_tpu_torch.core import se3
from octree_slam_tpu_torch.core.types import PyramidLevel
from octree_slam_tpu_torch.sensor import image_ops
from octree_slam_tpu_torch.utils import spans


class TrackStats(NamedTuple):
    inliers: torch.Tensor    # i32[levels] inlier count at final iter per level
    residual: torch.Tensor   # f32[levels] mean |r| at final iter per level
    diverged: torch.Tensor   # bool[] any failed solve


def build_pyramid(depth_mm: torch.Tensor, color: torch.Tensor,
                  cfg: SLAMConfig, row0: int = 0,
                  full_height: int | None = None) -> List[PyramidLevel]:
    """Bilateral filter + intensity + per-level vertex/normal maps
    (rgbd_camera.cpp:61-93). Level 0 is full resolution; levels finer than
    every consumer (track_finest_level, fuse_level) carry 1x1 INF
    placeholders like the reference package.

    depth_mm may carry a leading batch [B, H, W] (color [B, H, W, 3]):
    then every map has it too, and the batch still takes one bilateral
    launch and one gated-pyramid launch. Relocalization builds its K
    candidates' pyramids that way, where the reference package maps one
    build over them.

    A row slab of the frame (rows row0.. of a full_height-row image, row0
    a multiple of 2^(pyramid_depth-1)) gets the slab's maps: every
    level's vertex rows take their place in the whole level
    (parallel/distributed.py builds the row-sharded pyramid this way)."""
    filtered = image_ops.bilateral_filter(
        depth_mm, kernel_size=cfg.bilateral_kernel_size,
        sigma_spatial=cfg.bilateral_sigma_spatial,
        sigma_depth=cfg.bilateral_sigma_depth)
    intensity = image_ops.color_to_intensity(color, cfg.intensity_ratio)
    depths = [filtered] + image_ops.subsample_depth_levels(
        filtered, cfg.pyramid_depth - 1, cfg.bilateral_sigma_depth)
    levels = []
    inten = intensity
    min_map_level = min(cfg.track_finest_level, cfg.fuse_level)
    for i, d in enumerate(depths):
        if i >= min_map_level:
            vertex = image_ops.generate_vertex_map(
                d, cfg.focal_x, cfg.focal_y, (cfg.width, cfg.height),
                row0=row0 >> i,
                level_height=(None if full_height is None
                              else full_height >> i))
            normal = image_ops.generate_normal_map(vertex)
        else:
            vertex = torch.full(d.shape[:-2] + (1, 1, 3), torch.inf,
                                device=d.device)
            normal = torch.full_like(vertex, torch.inf)
        levels.append(PyramidLevel(vertex=vertex, normal=normal,
                                   intensity=inten))
        if i != cfg.pyramid_depth - 1:
            inten = image_ops.subsample(inten)
    return levels


def icp_normal_equations(v1: torch.Tensor, n1: torch.Tensor,
                         v2: torch.Tensor, n2: torch.Tensor,
                         cfg: SLAMConfig):
    """Build (A = sum w J J^T, b = sum w r J) over same-index
    correspondences. v1/n1: last-frame maps, v2/n2: current maps already
    in the last frame. Gates per localization_kernels.cu:186-204.
    Returns (A f32[6,6], b f32[6], inlier_count i32[], mean_abs_residual)."""
    A, b, count, res_sum = icp_sums(v1, n1, v2, n2, cfg)
    return A, b, count, res_sum / torch.clamp(count.to(torch.float32),
                                              min=1.0)


def icp_sums(v1: torch.Tensor, n1: torch.Tensor, v2: torch.Tensor,
             n2: torch.Tensor, cfg: SLAMConfig):
    """icp_normal_equations' sums: (A, b, inlier_count, sum of |r| w).
    Every one adds over pixels, so row slabs of a frame add theirs (the
    mean residual is the summed numerator over the summed count)."""
    v1 = v1.reshape(-1, 3)
    n1 = n1.reshape(-1, 3)
    v2 = v2.reshape(-1, 3)
    n2 = n2.reshape(-1, 3)

    finite = (torch.isfinite(v1).all(-1) & torch.isfinite(v2).all(-1)
              & torch.isfinite(n1).all(-1) & torch.isfinite(n2).all(-1))
    fm = finite[:, None]
    v1c = torch.where(fm, v1, 0.0)
    v2c = torch.where(fm, v2, 0.0)
    n1c = torch.where(fm, n1, 0.0)
    n2c = torch.where(fm, n2, 0.0)

    z_ok = ((v1c[:, 2] > cfg.icp_z_min) & (v2c[:, 2] > cfg.icp_z_min)
            & (v1c[:, 2] < cfg.icp_z_max) & (v2c[:, 2] < cfg.icp_z_max))
    diff = v2c - v1c
    dist_ok = torch.sum(diff * diff, dim=-1) <= cfg.icp_dist_thresh ** 2
    norm_ok = torch.sum(n2c * n1c, dim=-1) >= cfg.icp_norm_thresh
    mask = finite & z_ok & dist_ok & norm_ok

    # symmetric point-to-plane (Rusinkiewicz 2019) projects the residual on
    # both normals; the one-sided form is the reference estimator
    ns = n1c + n2c if cfg.icp_symmetric else n1c
    J = torch.cat([torch.linalg.cross(v2c, ns, dim=-1), ns], dim=-1)
    r = torch.sum(ns * (v1c - v2c), dim=-1)
    w = mask.to(torch.float32)
    if cfg.icp_huber_k > 0.0:
        w = w * torch.clamp(
            cfg.icp_huber_k / torch.clamp(torch.abs(r), min=1e-9), max=1.0)
    A = (J * w[:, None]).T @ J
    b = (r * w) @ J
    return A, b, mask.sum(dtype=torch.int32), torch.sum(torch.abs(r) * w)


def rgbd_normal_equations(last: PyramidLevel, cur_vertex: torch.Tensor,
                          cur_intensity: torch.Tensor, cfg: SLAMConfig):
    """Photometric (direct) alignment term: warp the current frame's
    points (already in the last camera's frame) into the last image,
    compare intensities and linearise through the last image's gradient.
    For a residual r(xi) ~ r0 + [v x m, m] . xi with m = dpi^T grad it
    accumulates J = -[v x m, m], so the ICP term's (A, b) convention
    holds. The current maps may be a row slab of the frame: the last
    level is whole, and sets the level's size.
    Returns (A f32[6,6], b f32[6], count i32[])."""
    h, w = last.intensity.shape
    img_w, img_h = cfg.width, cfg.height
    sx = w / img_w  # the level's pixel scale
    sy = h / img_h
    dev = cur_intensity.device

    i1 = last.intensity
    # central differences; the roll wraps at the borders, so the border
    # ring is zeroed: a point warped there adds no photometric force
    # instead of a biased one
    interior = torch.zeros_like(i1)
    interior[1:-1, 1:-1] = 1.0
    gx = 0.5 * (torch.roll(i1, -1, 1) - torch.roll(i1, 1, 1)) * interior
    gy = 0.5 * (torch.roll(i1, -1, 0) - torch.roll(i1, 1, 0)) * interior

    v = cur_vertex.reshape(-1, 3)
    finite = torch.isfinite(v).all(-1)
    vc = torch.where(finite[:, None], v, 1.0)
    X, Y, Z = vc[:, 0], vc[:, 1], vc[:, 2]
    z_ok = (Z > cfg.icp_z_min) & (Z < cfg.icp_z_max)

    px = (cfg.focal_x * X / Z + img_w / 2.0) * sx
    py = (img_h / 2.0 - cfg.focal_y * Y / Z) * sy
    x0 = torch.floor(px).to(torch.int32)
    y0 = torch.floor(py).to(torch.int32)
    inb = finite & z_ok & (x0 >= 0) & (x0 < w - 1) & (y0 >= 0) & (y0 < h - 1)
    x0c = torch.clamp(x0, 0, w - 2)
    y0c = torch.clamp(y0, 0, h - 2)
    fxp = px - x0c
    fyp = py - y0c
    base = (y0c * w + x0c).to(torch.int64)

    def bilinear(img):
        flat = img.reshape(-1)
        return (flat[base] * (1 - fxp) * (1 - fyp)
                + flat[base + 1] * fxp * (1 - fyp)
                + flat[base + w] * (1 - fxp) * fyp
                + flat[base + w + 1] * fxp * fyp)

    warped = bilinear(i1)
    g_u = bilinear(gx)
    g_v = bilinear(gy)

    r0 = warped - cur_intensity.reshape(-1)
    mask = inb & (r0.abs() < 0.3) & torch.isfinite(r0) \
        & torch.isfinite(g_u) & torch.isfinite(g_v)

    # m = dpi^T grad: the residual's change per unit motion of the point
    fx_l = cfg.focal_x * sx
    fy_l = cfg.focal_y * sy
    mx = g_u * fx_l / Z
    my = -g_v * fy_l / Z
    mz = -g_u * fx_l * X / (Z * Z) + g_v * fy_l * Y / (Z * Z)
    m = torch.stack([mx, my, mz], dim=-1)
    J = -torch.cat([torch.linalg.cross(vc, m, dim=-1), m], dim=-1)
    wgt = mask.to(torch.float32)
    A = (J * wgt[:, None]).T @ J
    b = (r0 * wgt) @ J
    return A, b, mask.sum(dtype=torch.int32)


def solve_normal_equations(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b by Cholesky with tiny Tikhonov damping. A matrix that
    is not positive definite yields NaN, as jax.scipy's cho_factor does."""
    eye = torch.eye(6, dtype=A.dtype, device=A.device)
    damped = A + 1e-6 * torch.trace(A) * eye + 1e-12 * eye
    L, info = torch.linalg.cholesky_ex(damped)
    x = torch.cholesky_solve(b[:, None], L)[:, 0]
    return torch.where(info > 0, torch.nan, x)


def _identity(xs):
    """The psum of one slab: its own sums."""
    return xs


def _track_level(last: PyramidLevel, cur, update_T, iters: int,
                 cfg: SLAMConfig, psum=_identity):
    """`iters` Gauss-Newton iterations at one pyramid level. `cur` is the
    current frame's level, or its row slabs at this level as a list of
    (first row, PyramidLevel), each on its own device: each slab pairs
    with the same rows of `last`, adds its sums, and `psum` adds the
    slabs' (the first slab's device solves)."""
    slabs = [(0, cur)] if isinstance(cur, PyramidLevel) else cur
    T = update_T
    diverged = torch.zeros((), dtype=torch.bool, device=T.device)
    zero = torch.zeros(6, dtype=T.dtype, device=T.device)
    pairs = []
    for r0, cur in slabs:
        dev = cur.vertex.device
        r1 = r0 + cur.vertex.shape[-3]
        pairs.append((last.vertex[r0:r1].to(dev), last.normal[r0:r1].to(dev),
                      PyramidLevel(*(x.to(dev) for x in last)), cur))
    count = res = None
    for _ in range(iters):
        parts = []
        for v1, n1, last_d, cur in pairs:
            Td = T.to(v1.device)
            v2t = image_ops.transform_vertex_map(cur.vertex, Td)
            n2t = image_ops.transform_normal_map(cur.normal, Td)
            A, b, count, res_sum = icp_sums(v1, n1, v2t, n2t, cfg)
            if cfg.w_rgbd > 0.0:
                Ar, br, _ = rgbd_normal_equations(last_d, v2t, cur.intensity,
                                                  cfg)
                A = A + cfg.w_rgbd * Ar
                b = b + cfg.w_rgbd * br
            parts.append((A, b, count, res_sum))
        A, b, count, res_sum = (psum(list(p))[0] for p in zip(*parts))
        res = res_sum / torch.clamp(count.to(torch.float32), min=1.0)
        x = solve_normal_equations(A, b)
        bad = ~torch.isfinite(x).all() | (count < 6)
        # twist is [omega, v] = [x[:3], x[3:]] by the Jacobian layout
        T = se3.exp_se3(torch.where(bad, zero, x)) @ T
        diverged = diverged | bad
    return T, diverged, count, res


def track(last_pyramid: List[PyramidLevel],
          current_pyramid: List[PyramidLevel],
          cfg: SLAMConfig, init_T: torch.Tensor | None = None
          ) -> Tuple[torch.Tensor, TrackStats]:
    """Coarse-to-fine ICP: returns cam_{t-1}_T_cam_t (the transform
    aligning the current camera frame onto the last one) and health stats
    (rgbd_camera.cpp:102-170 schedule). `init_T` seeds the Gauss-Newton
    iterations (identity when omitted, the frame-to-frame case); keyframe
    anchoring passes the previous frame's transform against the keyframe,
    so that the solver starts one frame from the optimum, not one
    keyframe."""
    return track_slabs(last_pyramid, [(0, current_pyramid)], cfg,
                       init_T=init_T)


def track_slabs(last_pyramid: List[PyramidLevel], slabs, cfg: SLAMConfig,
                init_T: torch.Tensor | None = None, *, psum=_identity
                ) -> Tuple[torch.Tensor, TrackStats]:
    """`track` with the current frame given as row slabs: slabs is a list
    of (first row at level 0, slab pyramid), each slab on its own device,
    its rows a multiple of 2^(pyramid_depth-1) apart. Each Gauss-Newton
    iteration adds the slabs' normal-equation sums with `psum` (a list of
    per-slab tensors -> the sum on each slab's device) and solves once on
    the first slab's device (one slab needs no psum: that is `track`).
    The whole frame as one slab on a CUDA device with no psum replays the
    loop's CUDA graph (`_track_graph`, in a `track.graph` span); anything
    else runs it eagerly, each level in a `track.level<L>` span
    (utils/spans.py)."""
    if _graph_eligible(slabs, psum):
        return _track_graph(last_pyramid, slabs[0][1], cfg, init_T)
    _tally("track_eager")
    return _track_eager(last_pyramid, slabs, cfg, init_T, psum)


def _track_eager(last_pyramid: List[PyramidLevel], slabs, cfg: SLAMConfig,
                 init_T: torch.Tensor | None, psum
                 ) -> Tuple[torch.Tensor, TrackStats]:
    """track_slabs' Gauss-Newton loop, launch by launch."""
    dev = slabs[0][1][0].intensity.device
    update_T = (torch.eye(4, dtype=torch.float32, device=dev)
                if init_T is None else init_T.to(dev, torch.float32))
    diverged = torch.zeros((), dtype=torch.bool, device=dev)
    inliers, residuals = [], []
    tfl = cfg.track_finest_level
    if len(cfg.pyramid_iters) < cfg.pyramid_depth - tfl:
        raise ValueError(
            f"pyramid_iters needs {cfg.pyramid_depth - tfl} entries for "
            f"pyramid_depth={cfg.pyramid_depth}, track_finest_level={tfl}")
    for level in range(cfg.pyramid_depth - 1, tfl - 1, -1):
        with spans.span(f"track.level{level}"):
            update_T, div, count, res = _track_level(
                last_pyramid[level], [(r0 >> level, pyr[level])
                                      for r0, pyr in slabs],
                update_T, cfg.pyramid_iters[level - tfl], cfg, psum)
        diverged = diverged | div
        inliers.append(count)
        residuals.append(res)
    # skipped finer levels report the finest tracked level's stats
    for _ in range(tfl):
        inliers.append(inliers[-1])
        residuals.append(residuals[-1])
    return update_T, TrackStats(inliers=torch.stack(inliers),
                                residual=torch.stack(residuals),
                                diverged=diverged)


# calls of track_slabs by path since the last reset_calls(); each also adds
# to the frame's counter of the same name (utils/spans.py)
CALLS = {"track_graph_captures": 0, "track_graph_replays": 0,
         "track_eager": 0}

# what the Gauss-Newton loop reads of the configuration: a graph captured
# under one value of each is replayed only under the same values
GRAPH_FIELDS = ("pyramid_depth", "pyramid_iters", "track_finest_level",
                "icp_symmetric", "icp_huber_k", "icp_dist_thresh",
                "icp_norm_thresh", "icp_z_min", "icp_z_max", "w_rgbd",
                "focal_x", "focal_y", "width", "height")


def reset_calls() -> None:
    for k in CALLS:
        CALLS[k] = 0


def _tally(name: str) -> None:
    CALLS[name] += 1
    spans.count(name)


def _graph_eligible(slabs, psum) -> bool:
    """The whole frame as one slab on a CUDA device, with no psum."""
    return (len(slabs) == 1 and slabs[0][0] == 0 and psum is _identity
            and slabs[0][1][0].intensity.device.type == "cuda")


def graph_key(last_pyramid: List[PyramidLevel],
              current_pyramid: List[PyramidLevel], cfg: SLAMConfig):
    """What a captured graph holds fixed: the device, every map's shape
    and type (the 1x1 INF placeholders included) and GRAPH_FIELDS."""
    maps = tuple((tuple(x.shape), x.dtype)
                 for pyr in (last_pyramid, current_pyramid)
                 for lvl in pyr for x in lvl)
    return ((current_pyramid[0].intensity.device, len(last_pyramid), maps)
            + tuple(getattr(cfg, f) for f in GRAPH_FIELDS))


class _TrackGraph:
    """One capture of `_track_eager` on static inputs: the last and the
    current tracked levels' vertex and normal maps (and intensities when
    cfg.w_rgbd > 0) and the seed T0. A call copies its maps in (device to
    device, 18.5 MB at 640x480), replays, and clones the outputs, since the
    caller keeps them past the next replay (the step's stats are read one
    frame late)."""

    def __init__(self, last_pyramid, current_pyramid, cfg: SLAMConfig,
                 init_T: torch.Tensor | None):
        dev = current_pyramid[0].intensity.device
        used = ("vertex", "normal") + (("intensity",) if cfg.w_rgbd > 0.0
                                       else ())
        tracked = range(cfg.track_finest_level, cfg.pyramid_depth)
        unused = torch.empty(0, device=dev)

        def static(pyr):
            return [PyramidLevel(*(
                torch.empty(x.shape, dtype=x.dtype, device=dev)
                if i in tracked and f in used else unused
                for f, x in zip(PyramidLevel._fields, lvl)))
                for i, lvl in enumerate(pyr)]
        self.last, self.cur = static(last_pyramid), static(current_pyramid)
        self.eye = torch.eye(4, dtype=torch.float32, device=dev)
        self.T0 = torch.empty(4, 4, dtype=torch.float32, device=dev)
        self.load(last_pyramid, current_pyramid, init_T)

        def run():
            return _track_eager(self.last, [(0, self.cur)], cfg, self.T0,
                                _identity)
        # PyTorch's recipe: one eager call on a side stream first (library
        # handles, workspaces, lazily loaded kernels), then the capture;
        # thread_local, so that another thread's copies (a prefetching
        # reader) cannot break it
        with torch.cuda.device(dev):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                run()
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph,
                                  capture_error_mode="thread_local"):
                self.out = run()

    def load(self, last_pyramid, current_pyramid, init_T) -> None:
        for dst_pyr, src_pyr in ((self.last, last_pyramid),
                                 (self.cur, current_pyramid)):
            for dst, src in zip(dst_pyr, src_pyr):
                for d, x in zip(dst, src):
                    if d.numel():
                        d.copy_(x)
        self.T0.copy_(self.eye if init_T is None else init_T)

    def replay(self) -> Tuple[torch.Tensor, TrackStats]:
        self.graph.replay()
        update_T, stats = self.out
        return update_T.clone(), TrackStats(*(x.clone() for x in stats))


# the captured graphs by graph_key, at most MAX_GRAPHS (the oldest goes
# first: each holds its own memory pool, ~120 MB at 640x480)
_GRAPHS: Dict[tuple, _TrackGraph] = {}
MAX_GRAPHS = 8


def _track_graph(last_pyramid, current_pyramid, cfg: SLAMConfig,
                 init_T: torch.Tensor | None
                 ) -> Tuple[torch.Tensor, TrackStats]:
    """track on a CUDA device: the key's graph, captured on its first
    call and replayed on every later one."""
    key = graph_key(last_pyramid, current_pyramid, cfg)
    with spans.span("track.graph"):
        g = _GRAPHS.get(key)
        if g is None:
            while len(_GRAPHS) >= MAX_GRAPHS:
                del _GRAPHS[next(iter(_GRAPHS))]
            g = _GRAPHS[key] = _TrackGraph(last_pyramid, current_pyramid,
                                           cfg, init_T)
            _tally("track_graph_captures")
        else:
            g.load(last_pyramid, current_pyramid, init_T)
            _tally("track_graph_replays")
        return g.replay()
