"""Reference views of a map's leaf set, the program's two renders written
out from its semantics (render/splat.py; render/conesplat.py and
render/hybrid.py at the configurations' settings):

  * `splat`: each occupied leaf's centre projected to the nearest pixel,
    the nearest leaf per pixel by a scatter-min of one
    (depth q15 << 16 | rgb565) word, two rounds of 3x3 hole filling;
  * `cone_hybrid`: the slab cone (leaves binned into 16 geometric depth
    slabs, each slab's raster decimated to the leaf footprint, the nearest
    confident leaf per slab cell, front-to-back composite with the march's
    saturation and 127/w exit rescale, hole repair) with the pixels of
    its luminance-gradient band re-rendered by a march of `band_iters`
    fixed trips through the dense leaf table, seeded at the slab's first
    contributing depth.

Every projection is a matrix product through `Arith.mm`. Only the
settings the configurations use are here: `check_config` refuses the
band knobs and slab modes at other values.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import Arith
from .fusion import decode_centers, unpack

DEPTH_INF = 0x7FFFFFFF


def check_config(slam: dict, render: str) -> None:
    if render not in ("splat", "cone_hybrid"):
        raise ValueError(f"the reference renders splat and cone_hybrid, "
                         f"not {render!r}")
    if render == "cone_hybrid":
        fixed = {"cone_band_crawl": 1, "cone_band_depth_prio": 0.0,
                 "cone_band_sel_decimate": False, "cone_band_fused_dist": True,
                 "cone_band_compact_after": 999, "cone_scale": 1,
                 "use_dense_mips": True}
        for key, want in fixed.items():
            if slam.get(key, want) != want:
                raise ValueError(f"the reference's hybrid follows "
                                 f"{key}={want!r} only, got {slam[key]!r}")
        if slam["cone_band_compact_after"] < slam["cone_band_iters"]:
            raise ValueError("the reference's band march has fixed trips")


def _rgb565(r, g, b):
    return ((r >> 3) << 11) | ((g >> 2) << 5) | (b >> 3)


def _unrgb565(v):
    r5 = (v >> 11) & 0x1F
    g6 = (v >> 5) & 0x3F
    b5 = v & 0x1F
    return (r5 << 3) | (r5 >> 2), (g6 << 2) | (g6 >> 4), (b5 << 3) | (b5 >> 2)


def splat_zbuffer(keys, words, center, half_size, pose, slam: dict,
                  ar: Arith) -> torch.Tensor:
    """i32[H, W] packed (depth q15 << 16 | rgb565) words of the leaves
    (keys, words) seen from `pose`: each occupied leaf's centre at its
    nearest pixel, the nearest by a scatter-min, DEPTH_INF where none."""
    W, H = slam["width"], slam["height"]
    fx, fy = slam["focal_x"], slam["focal_y"]
    max_range = slam["max_range"]
    centers = decode_centers(keys, center, half_size, slam["max_depth"])
    r, g, b, a = unpack(words)
    occupied = a > 127
    cam = ar.mm(centers - pose[:3, 3], pose[:3, :3])
    z = cam[:, 2]
    in_front = occupied & (z > 1e-3) & (z < max_range)
    zs = torch.where(in_front, z, 1.0)
    px = torch.round(fx * cam[:, 0] / zs + W / 2.0).to(torch.int32)
    py = torch.round(H / 2.0 - fy * cam[:, 1] / zs).to(torch.int32)
    inb = in_front & (px >= 0) & (px < W) & (py >= 0) & (py < H)
    qz = torch.clamp(z * (32766.0 / max_range), 0, 32766).to(torch.int32)
    word = (qz << 16) | _rgb565(r, g, b)
    n = W * H
    idx = torch.where(inb, py * W + px, n)
    buf = torch.full((n + 1,), DEPTH_INF, dtype=torch.int32,
                     device=words.device)
    buf.scatter_reduce_(0, idx.to(torch.int64),
                        torch.where(inb, word, DEPTH_INF), reduce="amin")
    return buf[:n].reshape(H, W)


def fill_holes(img: torch.Tensor, rounds: int) -> torch.Tensor:
    """`rounds` rounds of 3x3 hole filling: a DEPTH_INF pixel takes the
    least word of its neighbourhood (outside the image is DEPTH_INF)."""
    H, W = img.shape
    for _ in range(rounds):
        pad = F.pad(img, (1, 1, 1, 1), value=DEPTH_INF)
        best = img
        for dy in range(3):
            for dx in range(3):
                best = torch.minimum(best, pad[dy:dy + H, dx:dx + W])
        img = torch.where(img == DEPTH_INF, best, img)
    return img


def splat(keys, words, center, half_size, pose, slam: dict,
          ar: Arith) -> torch.Tensor:
    """f32[H, W, 4] splat view of the leaves (keys, words) from `pose`."""
    img = fill_holes(splat_zbuffer(keys, words, center, half_size, pose, slam,
                                   ar), 2)
    hit = img != DEPTH_INF
    rr, gg, bb = _unrgb565(torch.where(hit, img, 0) & 0xFFFF)
    rgb = torch.stack([rr, gg, bb], dim=-1).to(torch.float32) / 255.0
    alpha = hit.to(torch.float32)
    return torch.cat([rgb * alpha[..., None], alpha[..., None]], dim=-1)


# --- the slab cone -------------------------------------------------------

class _Slabs:
    """The slab pyramid's static geometry: per slab its raster scale (a
    power of two, at least the leaf footprint at the slab's mid depth, at
    most cone_max_scale) and its offset in one flat cell buffer."""

    def __init__(self, slam: dict):
        self.W, self.H = slam["width"], slam["height"]
        self.z_near, self.z_far = slam["cone_znear"], slam["max_range"]
        self.n = slam["cone_slabs"]
        self.ratio = (self.z_far / self.z_near) ** (1.0 / self.n)
        self.scales, self.offsets, total = [], [], 0
        for k in range(self.n):
            z_mid = self.z_near * (self.ratio ** (k + 0.5))
            fp = slam["focal_x"] * slam["voxel_resolution"] / z_mid
            s = 1 << max(0, math.ceil(math.log2(max(fp, 1.0))))
            s = max(1, min(slam["cone_max_scale"], s))
            while self.W % s or self.H % s:
                s //= 2
            self.scales.append(s)
            self.offsets.append(total)
            total += (self.W // s) * (self.H // s)
        self.total = total


def _min_words(keys, words, center, half_size, pose, slam, sp: _Slabs,
               ar: Arith) -> torch.Tensor:
    """The nearest confident leaf of every slab cell as one packed
    (prio9 | 127 - (alpha - 128) | rgb555) word, DEPTH_INF where none."""
    W, H, K = sp.W, sp.H, sp.n
    fx, fy = slam["focal_x"], slam["focal_y"]
    dev = words.device
    centers = decode_centers(keys, center, half_size, slam["max_depth"])
    r8, g8, b8, a8 = unpack(words)
    w_leaf = torch.clamp(a8 - 127, min=0)
    cam = ar.mm(centers - pose[:3, 3], pose[:3, :3])
    z = cam[:, 2]
    ok = (w_leaf > 0) & (z > 1e-3) & (z < sp.z_far)
    zc = torch.clamp(z, sp.z_near * 1.0001, sp.z_far * 0.9999)
    zs = torch.where(ok, z, 1.0)
    px = torch.floor(fx * cam[:, 0] / zs + W / 2.0).to(torch.int32)
    py = torch.floor(H / 2.0 - fy * cam[:, 1] / zs).to(torch.int32)
    ok = ok & (px >= 0) & (px < W) & (py >= 0) & (py < H)
    log_r = math.log(sp.ratio)
    k = torch.floor(torch.log(zc / sp.z_near) / log_r).to(torch.int32)
    k = torch.clamp(k, 0, K - 1)
    tables = torch.tensor([sp.scales, sp.offsets,
                           [W // s for s in sp.scales]], dtype=torch.int32,
                          device=dev)
    s, off, sw = tables[:, k.to(torch.int64)]
    cell = off + torch.div(py, s, rounding_mode="floor") * sw \
        + torch.div(px, s, rounding_mode="floor")
    idx = torch.where(ok, cell, sp.total).to(torch.int64)

    z0k = sp.z_near * torch.exp(k.to(torch.float32) * log_r)
    slab_w = z0k * (sp.ratio - 1.0)
    zrel = torch.clamp((z - z0k) / torch.clamp(slab_w, min=1e-6), 0.0, 1.0)
    deficit_m = (255 - a8).to(torch.float32) * (4.0 * sp.z_far / 32766.0)
    prio = torch.clamp((zrel * 511.0 + deficit_m * 512.0 /
                        torch.clamp(slab_w, min=1e-6)).to(torch.int32),
                       0, 510)
    inv_a7 = 127 - torch.clamp(a8 - 128, 0, 127)
    rgb555 = ((r8 >> 3) << 10) | ((g8 >> 3) << 5) | (b8 >> 3)
    word = (prio << 22) | (inv_a7 << 15) | rgb555
    buf = torch.full((sp.total + 1,), DEPTH_INF, dtype=torch.int32,
                     device=dev)
    buf.scatter_reduce_(0, idx, torch.where(ok, word, DEPTH_INF),
                        reduce="amin")
    return buf[:sp.total]


def _neighbours(img, axis):
    n = img.shape[axis]
    prev = torch.cat([img.narrow(axis, 0, 1), img.narrow(axis, 0, n - 1)],
                     dim=axis)
    nxt = torch.cat([img.narrow(axis, 1, n - 1), img.narrow(axis, n - 1, 1)],
                    dim=axis)
    return prev, nxt


def _tent(img, axis):
    prev, nxt = _neighbours(img, axis)
    return 0.5 * img + 0.25 * (prev + nxt)


def _cap(sl):
    return sl * (torch.clamp(sl[..., :1], max=128.0)
                 / torch.clamp(sl[..., :1], min=1e-6))


def _field(buf, o, hh, ww):
    """A slab's words -> premultiplied [w, w r, w g, w b] f32[hh, ww, 4]."""
    w = buf[o:o + hh * ww].reshape(hh, ww)
    occ = (w != DEPTH_INF).to(torch.float32)
    alpha = occ * (128 - ((w >> 15) & 0x7F)).to(torch.float32)
    rr = (w >> 10) & 0x1F
    gg = (w >> 5) & 0x1F
    bb = w & 0x1F
    rgb_s = torch.stack([(rr << 3) | (rr >> 2), (gg << 3) | (gg >> 2),
                         (bb << 3) | (bb >> 2)], dim=-1).to(torch.float32)
    return torch.cat([alpha[..., None], alpha[..., None] * rgb_s], dim=-1)


def cone_slab(keys, words, center, half_size, pose, slam, ar: Arith):
    """The slab composite: (f32[H, W, 4], z_first f32[H, W]), z_first the
    near boundary of each pixel's first contributing slab, inf where
    none contributed."""
    sp = _Slabs(slam)
    buf = _min_words(keys, words, center, half_size, pose, slam, sp, ar)
    H, W = sp.H, sp.W
    for kk in range(sp.n):
        sc = sp.scales[kk]
        hh, ww = H // sc, W // sc
        sl = _field(buf, sp.offsets[kk], hh, ww)
        if kk == 0:
            w_acc = sl.new_zeros((H, W))
            rgb_acc = sl.new_zeros((H, W, 3))
            z_first = sl.new_full((H, W), torch.inf)
        t = _tent(_tent(sl, 0), 1)       # one round of empty-cell borrowing
        sl = torch.where(sl[..., :1] <= 0.0, t, sl)
        sl = _cap(sl)
        if sc > 1:
            sl = sl[:, None, :, None, :].expand(hh, sc, ww, sc, 4).reshape(
                H, W, 4)
        w = sl[..., 0]
        gate = ((w > 0.0) & (w_acc < 127.0)).to(torch.float32)
        z_first = torch.where((w_acc == 0.0) & (w > 0.0),
                              sp.z_near * (sp.ratio ** kk), z_first)
        rgb_acc = rgb_acc + gate[..., None] * sl[..., 1:]
        w_acc = w_acc + gate * w
    for _ in range(2):                   # hole repair
        pw = F.pad(w_acc, (1, 1, 1, 1))
        pr = F.pad(rgb_acc, (0, 0, 1, 1, 1, 1))
        best_w = w_acc
        best_rgb = rgb_acc
        for dy in (0, 1, 2):
            for dx in (0, 1, 2):
                if dy == 1 and dx == 1:
                    continue
                nw = pw[dy:dy + H, dx:dx + W]
                better = nw > best_w
                best_w = torch.where(better, nw, best_w)
                best_rgb = torch.where(better[..., None],
                                       pr[dy:dy + H, dx:dx + W], best_rgb)
        hole = (best_w > 8.0) & (w_acc * 4.0 < best_w)
        w_acc = torch.where(hole, best_w, w_acc)
        rgb_acc = torch.where(hole[..., None], best_rgb, rgb_acc)
    scale = torch.where(w_acc >= 127.0, 1.0,
                        127.0 / torch.clamp(w_acc, min=1.0))
    rgb = torch.clamp(rgb_acc * scale[..., None] / 127.0, 0.0, 255.0) / 255.0
    return torch.cat([rgb, torch.ones_like(w_acc)[..., None]], dim=-1), \
        z_first


# --- the band march ------------------------------------------------------

def _interleave(x, y, z, bits):
    m = torch.zeros_like(x)
    for b in range(bits):
        m = m | (((x >> b) & 1) << (3 * b))
        m = m | (((y >> b) & 1) << (3 * b + 1))
        m = m | (((z >> b) & 1) << (3 * b + 2))
    return m


def _deinterleave(m, bits):
    """Morton code -> (x, y, z) integer coordinates."""
    x = torch.zeros_like(m)
    y = torch.zeros_like(m)
    z = torch.zeros_like(m)
    for b in range(bits):
        x = x | (((m >> (3 * b)) & 1) << b)
        y = y | (((m >> (3 * b + 1)) & 1) << b)
        z = z | (((m >> (3 * b + 2)) & 1) << b)
    return x, y, z


def _dist_from_occ(occ3d: torch.Tensor, max_skip: int) -> torch.Tensor:
    """Chebyshev distance (cells, saturated at max_skip) to the nearest
    occupied cell, by log rounds of dilated 3^3 window minima."""
    dist = torch.where(occ3d, 0, max_skip).to(torch.int32)
    n = dist.shape
    j = 0
    while (1 << j) <= max_skip:
        w = 1 << j
        pooled = dist
        for axis in range(3):
            pad = [0, 0, 0, 0, 0, 0]
            pad[2 * (2 - axis)] = pad[2 * (2 - axis) + 1] = w
            p = F.pad(pooled, pad, value=max_skip)
            pooled = torch.minimum(
                torch.minimum(p.narrow(axis, 0, n[axis]),
                              p.narrow(axis, 2 * w, n[axis])), pooled)
        dist = torch.minimum(dist, pooled + w)
        j += 1
    return torch.clamp(dist, max=max_skip)


def stamped_leaf_level(table_words: torch.Tensor, keys: torch.Tensor,
                       words: torch.Tensor, slam: dict) -> torch.Tensor:
    """The band march's one-gather leaf level: the leaf table with every
    free cell's word set to the Chebyshev distance of its covering
    dist-level cell (written in place over `table_words`)."""
    depth = slam["max_depth"]
    lvl = max(1, min(slam["accel_level"], depth - 2))
    g = 1 << lvl
    occ = torch.zeros((g ** 3,), dtype=torch.bool, device=keys.device)
    cell = keys[(words >> 24) & 0xFF > 127] >> (3 * (depth - lvl))
    x, y, z = _deinterleave(cell, lvl)
    occ[((z << (2 * lvl)) | (y << lvl) | x).to(torch.int64)] = True
    dist = _dist_from_occ(occ.reshape(g, g, g),
                          slam["dist_max_skip"]).reshape(-1)
    # dist in Morton order of the dist-level cells
    mx, my, mz = _deinterleave(
        torch.arange(g ** 3, dtype=torch.int64, device=keys.device), lvl)
    dist_m = dist[mz * g * g + my * g + mx]
    lv = table_words.view(-1, 1 << (3 * (depth - lvl)))
    torch.where(lv < 0, lv, dist_m[:, None].to(torch.int32), out=lv)
    return table_words


def _pool_max(img, half):
    return F.max_pool2d(img[None, None], 2 * half + 1, stride=1,
                        padding=half)[0, 0]


def band_merge(fb, z_first, leaf_level, center, half_size, pose, slam,
               ar: Arith) -> torch.Tensor:
    """Re-render the slab image's edge band by the seeded fixed-trip march
    through the stamped leaf level; f32[H, W, 4]."""
    W, H = slam["width"], slam["height"]
    fx, fy = slam["focal_x"], slam["focal_y"]
    depth = slam["max_depth"]
    max_range, start_dist = slam["max_range"], slam["start_dist"]
    n = W * H
    dev = fb.device
    cap = slam["cone_band_cap"]
    C = min(cap if cap > 0 else max(128, n // 4), n)

    lum = fb[..., 0] * 0.299 + fb[..., 1] * 0.587 + fb[..., 2] * 0.114
    gx = (lum - torch.cat([lum[:, :1], lum[:, :-1]], dim=1)).abs()
    gy = (lum - torch.cat([lum[:1, :], lum[:-1, :]], dim=0)).abs()
    prio = _pool_max(torch.maximum(gx, gy), 2)
    sel = torch.sort(torch.argsort(-prio.reshape(-1), stable=True)[:C]).values

    leaf_cell = (2.0 * half_size) / (1 << depth)
    seed_z = torch.clamp(-_pool_max(-z_first, 4) - leaf_cell,
                         min=0.0).reshape(-1)[sel]

    yy, xx = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev),
        torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
    d_cam = torch.stack([(xx - W / 2.0) / fx, (H / 2.0 - yy) / fy,
                         torch.ones_like(xx)], dim=-1).reshape(-1, 3)
    d_cam = d_cam / torch.linalg.norm(d_cam, dim=-1, keepdim=True)
    origin = pose[:3, 3]
    dirs = ar.mm(d_cam, pose[:3, :3].T)[sel]
    xr = ((sel % W).to(torch.float32) - W / 2.0) / fx
    yr = (H / 2.0 - torch.div(sel, W, rounding_mode="floor")
          .to(torch.float32)) / fy
    dz = 1.0 / torch.sqrt(xr * xr + yr * yr + 1.0)

    moves = dirs.abs() > 1e-9
    forward = dirs > 0
    inv_dirs = torch.where(moves, 1.0 / dirs, torch.inf)
    linf = torch.clamp(dirs.abs().amax(dim=-1), min=1e-6)
    lo, hi = center - half_size, center + half_size
    o = origin[None, :]
    ta = (lo[None, :] - o) * inv_dirs
    tb = (hi[None, :] - o) * inv_dirs
    par = dirs.abs() <= 1e-9
    inside = (o >= lo[None, :]) & (o <= hi[None, :])
    tmin = torch.where(par, torch.where(inside, -torch.inf, torch.inf),
                       torch.minimum(ta, tb))
    tmax = torch.where(par, torch.where(inside, torch.inf, -torch.inf),
                       torch.maximum(ta, tb))
    t0, t1 = tmin.amax(dim=-1), tmax.amin(dim=-1)
    miss = (t0 > t1) | (t1 < 0.0) | (t0 > max_range)
    start = torch.clamp(torch.where(t0 > 0.0, t0 + 1e-4, 0.0),
                        min=start_dist)
    t_seed = torch.where(torch.isfinite(seed_z), seed_z / dz, 0.0)
    limit = torch.clamp(t1, max=max_range)
    start = torch.minimum(torch.maximum(start, t_seed), limit)

    n_leaf = 1 << depth
    lvl = max(1, min(slam["accel_level"], depth - 2))
    cell_l = (2.0 * half_size) / (1 << lvl)
    shift_l = depth - lvl
    eps = 0.05 * leaf_cell
    min_step = 0.25 * leaf_cell
    v = torch.arange(n_leaf, dtype=torch.int32, device=dev)
    zero = torch.zeros_like(v)
    spread = _interleave(v, zero, zero, depth)

    t = torch.where(miss, max_range, start)
    rgb = torch.zeros((C, 3), dtype=torch.float32, device=dev)
    w = torch.where(miss, 255.0, 0.0)
    active = ~miss
    for _ in range(slam["cone_band_iters"]):
        pos = origin + dirs * t[:, None]
        q = torch.clamp(torch.floor((pos - lo) / leaf_cell).to(torch.int32),
                        0, n_leaf - 1)
        c = spread[q.to(torch.int64)]
        r, g, b, a = unpack(leaf_level[c[..., 0] | (c[..., 1] << 1)
                                       | (c[..., 2] << 2)])
        d = torch.where(a > 127, 0, r)
        free = d > 0
        alpha = torch.where(free, 0.0,
                            torch.clamp(a - 127, min=0).to(torch.float32))
        shift = (free.to(torch.int32) * shift_l)[:, None]
        cell = torch.where(free, cell_l, leaf_cell)[:, None]
        corner = lo + (q >> shift).to(torch.float32) * cell
        t_axis = torch.where(
            moves, torch.where(forward, corner + cell - pos, corner - pos)
            * inv_dirs, torch.inf)
        t_exit = torch.clamp(t_axis.amin(dim=-1), min=0.0)
        skip = torch.where(free, (d - 1).to(torch.float32) * cell_l / linf,
                           0.0)
        t_next = t + torch.maximum(t_exit + skip + eps, min_step)
        col = torch.stack([r, g, b], dim=-1).to(torch.float32)
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
        active = active & ~saturated & ~oor

    out = fb.reshape(n, 4).clone()
    front01 = torch.clamp(rgb, 0.0, 255.0) / 255.0
    rem = torch.clamp(1.0 - w / 127.0, 0.0, 1.0)
    blended = torch.clamp(front01 + rem[:, None] * out[sel, :3], 0.0, 1.0)
    merged_rgb = torch.where(active[:, None], blended, front01)
    merged_a = torch.where(active, 1.0, torch.clamp(w, 0.0, 255.0) / 255.0)
    out[sel] = torch.cat([merged_rgb, merged_a[:, None]], dim=-1)
    return out.reshape(H, W, 4)


def view(render: str, table, keys, words, pose, slam: dict,
         ar: Arith) -> torch.Tensor:
    """The cell's render of the reference map from `pose`. The hybrid
    stamps the free cells of `table.words` (call it last)."""
    if render == "splat":
        return splat(keys, words, table.center, table.half_size, pose, slam,
                     ar)
    fb, z_first = cone_slab(keys, words, table.center, table.half_size, pose,
                            slam, ar)
    leaf_level = stamped_leaf_level(table.words, keys, words, slam)
    return band_merge(fb, z_first, leaf_level, table.center, table.half_size,
                      pose, slam, ar)
