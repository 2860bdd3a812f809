"""Cone-traced map rendering as slab-volume splatting (counterpart:
octree_slam_tpu/render/conesplat.py).

The reference system's cone tracer is a per-ray march: sample the octree at
the cone's level of detail, accumulate front to back with
alpha = max(node_alpha - 127, 0), stop at saturation (w >= 127) or at the
range limit, and rescale the colour by 127/w for rays that leave
unsaturated (coneTrace, cone_tracing_kernels.cu:53-146). This module
computes the same accumulation by scattering: the per-ray work is regrouped
per leaf voxel, of which the pipeline keeps a registry (render/splat.py).

  1. Project every occupied leaf once.
  2. Bin it into a geometric depth slab k (z in [z0 r^k, z0 r^(k+1))) and
     scatter-min one packed (slab-relative depth | alpha | rgb555) word
     into that slab's raster: the nearest leaf per slab cell wins, the
     scatter-space form of "the march samples each surface crossing once".
  3. Each slab's raster is decimated by a power-of-two scale matched to
     the projected leaf footprint at the slab's depth (fx * leaf / z
     pixels, rounded up so that a contiguous surface puts at least one
     leaf centre into every cell): the cone footprint rule
     (cone_tracing_kernels.cu:68-69) as raster resolution.
  4. The K slabs are composited front to back per pixel with the march's
     per-sample rule: while unsaturated add the full (alpha/127) * rgb
     contribution, then apply the 127/w exit rescale to unsaturated pixels.

`dilate` rounds of empty-cell borrowing (`_borrow_empty`) reproduce the
march's full-colour halo one footprint past every silhouette.

The reference's three modes are all here; the default is its production
one:
  * accumulate=False (default): the packed scatter-min above, the nearest
    confident leaf of each cell;
  * accumulate=True: one float32 scatter-add of [w, w*r, w*g, w*b]
    (`slab_scatter_add`), the cell's colour the weight-averaged mean of
    every leaf in it, its weight capped at one march sample's (128). Every
    term is an integer of at most 128 * 255 and every cell's sum stays
    below 2^24, so the sums are exact in float32 and the order of the adds
    does not matter: the word buffer equals the reference's;
  * blend in (0, 1]: the nearest-leaf field mixed with the capped mean,
    (1 - blend) * min + blend * mean (both scatters run);
  * bilinear=True: each slab's field is upsampled by repeated 2x tent
    steps (`_double_bilinear`, rows first) instead of nearest copies.
The reference's authors measured the additive mode about 3 dB below the
min, the blend within 0.1 dB of it and the tent below nearest on their
TPU's scenes; the port renders each, and chip_smoke.py's `[knobs]` phase
reads each one's PSNR against the exact march on the card.

Where the slab image departs from the march (the exact marchers are in
render/raycast.py): a leaf contributes to the pixels its centre projects
into, not to every ray crossing its cell; and of two surfaces in one slab
cell only the nearer confident one is kept.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from octree_slam_tpu_torch.core import packing
from octree_slam_tpu_torch.map import morton
from octree_slam_tpu_torch.render.splat import LeafList

EMPTY = 0x7FFFFFFF  # no leaf landed: sorts after every packed word


class SlabSpec(NamedTuple):
    """Static geometry of the slab pyramid."""

    z_near: float
    z_far: float
    n_slabs: int
    scales: tuple          # int per slab: raster decimation (power of two)
    offsets: tuple         # int per slab: start cell in the flat buffer
    total_cells: int
    width: int
    height: int

    @property
    def ratio(self) -> float:
        return (self.z_far / self.z_near) ** (1.0 / self.n_slabs)


def make_slab_spec(*, width: int, height: int, fx: float, leaf_size: float,
                   z_near: float = 0.25, z_far: float = 10.0,
                   n_slabs: int = 16, max_scale: int = 8) -> SlabSpec:
    """Per-slab raster scales such that one grid cell >= one projected leaf:
    scale_k = 2^ceil(log2(fx * leaf / z_mid)) clamped to [1, max_scale],
    the footprint of a leaf at the slab's mid depth in pixels, rounded up
    to a power of two that divides the image."""
    r = (z_far / z_near) ** (1.0 / n_slabs)
    scales = []
    offsets = []
    total = 0
    for k in range(n_slabs):
        z_mid = z_near * (r ** (k + 0.5))
        fp = fx * leaf_size / z_mid
        s = 1 << max(0, math.ceil(math.log2(max(fp, 1.0))))
        s = max(1, min(max_scale, s))
        while width % s or height % s:
            s //= 2
        scales.append(s)
        offsets.append(total)
        total += (width // s) * (height // s)
    return SlabSpec(z_near=z_near, z_far=z_far, n_slabs=n_slabs,
                    scales=tuple(scales), offsets=tuple(offsets),
                    total_cells=total, width=width, height=height)


@functools.lru_cache(maxsize=8)
def _slab_tables(spec: SlabSpec, device: str) -> torch.Tensor:
    """i32[3, K] on the device: per slab its scale, its offset and its
    raster width. Kept per (spec, device), so only a spec's first frame
    pays the host-to-device copy."""
    return torch.tensor(
        [spec.scales, spec.offsets,
         [spec.width // sc for sc in spec.scales]],
        dtype=torch.int32, device=device)


def _neighbours(img: torch.Tensor, axis: int):
    """(previous, next) entry of every entry along `axis`, edges
    clamped."""
    n = img.shape[axis]
    prev = torch.cat([img.narrow(axis, 0, 1), img.narrow(axis, 0, n - 1)],
                     dim=axis)
    nxt = torch.cat([img.narrow(axis, 1, n - 1), img.narrow(axis, n - 1, 1)],
                    dim=axis)
    return prev, nxt


def _tent(img: torch.Tensor, axis: int) -> torch.Tensor:
    """[0.25, 0.5, 0.25] along `axis`, edges clamped."""
    prev, nxt = _neighbours(img, axis)
    return 0.5 * img + 0.25 * (prev + nxt)


def _borrow_empty(sl: torch.Tensor) -> torch.Tensor:
    """Empty slab cells adopt their tent-filtered 3x3 neighbourhood.

    The march paints a full-colour halo about one leaf footprint past
    every silhouette: a ray that merely grazes a shell leaf accumulates
    its sample, and the 127/w exit rescale brings any non-zero
    accumulation to full strength (cone_tracing_kernels.cu:106-139).
    Leaf-centre binning stops at the silhouette. Borrowing into empty
    cells only extends coverage by one cell, the march's grazing reach,
    while occupied cells keep their own value. Separable tent on the
    premultiplied fields [hh, ww, 4]."""
    t = _tent(_tent(sl, 0), 1)
    return torch.where(sl[..., :1] <= 0.0, t, sl)


def _double_bilinear(img: torch.Tensor, axis: int) -> torch.Tensor:
    """2x upsample along `axis` with half-pixel-centred linear weights:
    out[2i] = 0.75*in[i] + 0.25*in[i-1], out[2i+1] = 0.75*in[i] +
    0.25*in[i+1], edges clamped (the align_corners=False tent)."""
    prev, nxt = _neighbours(img, axis)
    even = 0.75 * img + 0.25 * prev
    odd = 0.75 * img + 0.25 * nxt
    shape = list(img.shape)
    shape[axis] *= 2
    return torch.stack([even, odd], dim=axis + 1).reshape(shape)


def _upsample(img: torch.Tensor, scale: int,
              bilinear: bool = False) -> torch.Tensor:
    """(h, w, c) -> (h*scale, w*scale, c) for a power-of-two scale:
    nearest (one copy), or with `bilinear` a 2x tent along the rows and
    then the columns until the scale is reached."""
    if scale == 1:
        return img
    if bilinear:
        while scale > 1:
            img = _double_bilinear(_double_bilinear(img, 0), 1)
            scale //= 2
        return img
    h, w, c = img.shape
    return img[:, None, :, None, :].expand(h, scale, w, scale, c).reshape(
        h * scale, w * scale, c)


def slab_scatter_min(vals: torch.Tensor, keys: torch.Tensor,
                     live: torch.Tensor, center: torch.Tensor, half_size,
                     world_T_cam: torch.Tensor, fx, fy, *,
                     spec: SlabSpec, depth: int) -> torch.Tensor:
    """The scatter half of the slab render over raw leaf arrays: project
    every live leaf, bin it into its depth slab, scatter-min the packed
    (prio9 | inv_alpha7 | rgb555) word. Returns the i32[total_cells] word
    buffer, EMPTY where nothing landed."""
    return _min_words(_slab_bins(vals, keys, live, center, half_size,
                                 world_T_cam, fx, fy, spec=spec,
                                 depth=depth), spec)


def slab_scatter_add(vals: torch.Tensor, keys: torch.Tensor,
                     live: torch.Tensor, center: torch.Tensor, half_size,
                     world_T_cam: torch.Tensor, fx, fy, *,
                     spec: SlabSpec, depth: int) -> torch.Tensor:
    """The scatter half of the additive slab render: project and bin every
    live leaf as slab_scatter_min does and scatter-add its
    [w, w*r8, w*g8, w*b8] (w = alpha - 127) into its cell. Returns the
    f32[total_cells, 4] sums, exact (see the module docstring)."""
    return _add_sums(_slab_bins(vals, keys, live, center, half_size,
                                world_T_cam, fx, fy, spec=spec, depth=depth),
                     spec)


def composite_min_words(buf: torch.Tensor, *, spec: SlabSpec,
                        bilinear: bool = False, dilate: int = 1,
                        want_aux: bool = False):
    """The composite half of the slab render: decode a packed word buffer
    (slab_scatter_min) into per-slab premultiplied fields and composite
    them front to back."""
    return _composite_fields(
        lambda o, hh, ww: _decode_min_field(buf, o, hh, ww), spec, dilate,
        want_aux=want_aux, bilinear=bilinear)


def _cap(sl: torch.Tensor) -> torch.Tensor:
    """Premultiplied [w, w*r, w*g, w*b] fields with each cell's vector
    scaled so that its weight is at most one march sample's (128): the
    colour stays the cell's."""
    return sl * (torch.clamp(sl[..., :1], max=128.0)
                 / torch.clamp(sl[..., :1], min=1e-6))


def _capped_sum_field(abuf, o, hh, ww):
    """A slab's scatter-add sums -> capped premultiplied f32[hh, ww, 4]
    (the blend mixes it with the min field at that scale)."""
    return _cap(abuf[o:o + hh * ww].reshape(hh, ww, 4))


def _decode_min_field(buf, o, hh, ww):
    """Packed words -> premultiplied [alpha, alpha*r, alpha*g, alpha*b]
    f32[hh, ww, 4] (empty cells all zero); weight = alpha - 127 =
    (127 - inv_a7) + 1."""
    w = buf[o:o + hh * ww].reshape(hh, ww)
    occ = (w != EMPTY).to(torch.float32)
    alpha = occ * (128 - ((w >> 15) & 0x7F)).to(torch.float32)
    # expand 5-bit channels to 8 bits (the top bits repeat in the low 3)
    rr = (w >> 10) & 0x1F
    gg = (w >> 5) & 0x1F
    bb = w & 0x1F
    rgb_s = torch.stack([(rr << 3) | (rr >> 2), (gg << 3) | (gg >> 2),
                         (bb << 3) | (bb >> 2)], dim=-1).to(torch.float32)
    return torch.cat([alpha[..., None], alpha[..., None] * rgb_s], dim=-1)


class _Bins(NamedTuple):
    """Every leaf's cell and what the two scatters write."""

    idx: torch.Tensor     # i64[L] cell, total_cells for a dropped leaf
    ok: torch.Tensor      # bool[L] the leaf lands in a cell
    k: torch.Tensor       # i32[L] slab
    z: torch.Tensor       # f32[L] camera-space depth
    rgba: tuple           # (r8, g8, b8, a8), i32[L] each
    w_leaf: torch.Tensor  # i32[L] alpha - 127, at least 0


def _slab_bins(vals, keys, live, center, half_size, world_T_cam, fx, fy, *,
               spec: SlabSpec, depth: int) -> _Bins:
    """Projection and binning of every leaf."""
    W, H = spec.width, spec.height
    K = spec.n_slabs

    keys = torch.where(live, keys, 0)
    centers = morton.decode_centers(keys, center, half_size, depth)
    r8, g8, b8, a8 = packing.unpack_rgba8(vals)
    w_leaf = torch.clamp(a8 - 127, min=0)

    R = world_T_cam[:3, :3]
    t = world_T_cam[:3, 3]
    cam = (centers - t) @ R
    z = cam[:, 2]
    ok = live & (w_leaf > 0) & (z > 1e-3) & (z < spec.z_far)
    zc = torch.clamp(z, spec.z_near * 1.0001, spec.z_far * 0.9999)

    zs = torch.where(ok, z, 1.0)
    px = torch.floor(fx * cam[:, 0] / zs + W / 2.0).to(torch.int32)
    py = torch.floor(H / 2.0 - fy * cam[:, 1] / zs).to(torch.int32)
    ok = ok & (px >= 0) & (px < W) & (py >= 0) & (py < H)

    log_r = math.log(spec.ratio)
    k = torch.floor(torch.log(zc / spec.z_near) / log_r).to(torch.int32)
    k = torch.clamp(k, 0, K - 1)

    s, off, sw = _slab_tables(spec, str(vals.device))[:, k.to(torch.int64)]
    cell = off + torch.div(py, s, rounding_mode="floor") * sw \
        + torch.div(px, s, rounding_mode="floor")
    idx = torch.where(ok, cell, spec.total_cells).to(torch.int64)
    return _Bins(idx=idx, ok=ok, k=k, z=z, rgba=(r8, g8, b8, a8),
                 w_leaf=w_leaf)


def _add_sums(bins: _Bins, spec: SlabSpec) -> torch.Tensor:
    """The scatter-add of [w, w*r8, w*g8, w*b8] over the bins; one guard
    row past the buffer takes every dropped leaf."""
    r8, g8, b8, _ = bins.rgba
    wf = torch.where(bins.ok, bins.w_leaf.to(torch.float32), 0.0)
    terms = torch.stack([wf, wf * r8.to(torch.float32),
                         wf * g8.to(torch.float32),
                         wf * b8.to(torch.float32)], dim=-1)
    abuf = terms.new_zeros((spec.total_cells + 1, 4))
    abuf.index_add_(0, bins.idx, terms)
    return abuf[:spec.total_cells]


def _min_words(bins: _Bins, spec: SlabSpec) -> torch.Tensor:
    """The packed-word scatter-min over the bins."""
    k, z, ok = bins.k, bins.z, bins.ok
    r8, g8, b8, a8 = bins.rgba
    log_r = math.log(spec.ratio)
    # Nearest-leaf-per-cell resolve in one packed scatter-min word:
    #   bit 22..30  prio9: z quantized relative to the leaf's slab (a slab
    #               spans a ~1.2x depth ratio, so 9 bits resolve ~0.05% of
    #               depth; order within a slab cell is all the min needs),
    #               biased by the alpha deficit: a freshly observed speck
    #               (alpha ~129, colour still half blended) must not shadow
    #               the mature surface just behind it. The march composites
    #               both; a min keeps one, so keep the confident one. The
    #               bias is ~1.2 mm per deficit step.
    #   bit 15..21  127 - (alpha - 128): inverted, so that prio ties (the
    #               clip at 510 saturates for near slabs, where the bias
    #               can exceed the slab width) resolve toward the highest
    #               alpha.
    #   bit  0..14  rgb555.
    # prio9 stops at 510 so that the largest word stays below EMPTY.
    z0k = spec.z_near * torch.exp(k.to(torch.float32) * log_r)
    slab_w = z0k * (spec.ratio - 1.0)
    zrel = torch.clamp((z - z0k) / torch.clamp(slab_w, min=1e-6), 0.0, 1.0)
    deficit_m = (255 - a8).to(torch.float32) * (4.0 * spec.z_far / 32766.0)
    prio = torch.clamp((zrel * 511.0 + deficit_m * 512.0 /
                        torch.clamp(slab_w, min=1e-6)).to(torch.int32),
                       0, 510)
    inv_a7 = 127 - torch.clamp(a8 - 128, 0, 127)
    rgb555 = ((r8 >> 3) << 10) | ((g8 >> 3) << 5) | (b8 >> 3)
    word = (prio << 22) | (inv_a7 << 15) | rgb555
    # one guard slot past the buffer takes every dropped leaf
    buf = torch.full((spec.total_cells + 1,), EMPTY, dtype=torch.int32,
                     device=word.device)
    buf.scatter_reduce_(0, bins.idx, torch.where(ok, word, EMPTY),
                        reduce="amin")
    return buf[:spec.total_cells]


def render_cone_splat(leaves: LeafList, center: torch.Tensor, half_size,
                      world_T_cam: torch.Tensor, fx, fy, *,
                      spec: SlabSpec, depth: int, accumulate: bool = False,
                      bilinear: bool = False, dilate: int = 1,
                      blend: float = 0.0, want_aux: bool = False):
    """Cone-composite the occupied leaf set to f32[H, W, 4].

    The output convention is raycast.cone_trace's: rgb in [0, 1]
    accumulated front to back in (alpha/127)*rgb8 units then /255, alpha =
    1 (every ray finishes: saturation or range exit).

    want_aux=True also returns (w_acc, z_first): the per-pixel accumulated
    march weight before the image-space hole repair, and the near boundary
    (camera-space z, metres) of the first slab that contributed, inf where
    none did; the contributing leaf's centre lies at z >= z_first.

    `accumulate`, `blend` and `bilinear` select the modes of the module
    docstring."""
    lc = leaves.keys.shape[0]
    live = (torch.arange(lc, device=leaves.keys.device) < leaves.count) \
        & (leaves.keys >= 0)
    bins = _slab_bins(leaves.vals, leaves.keys, live, center, half_size,
                      world_T_cam, fx, fy, spec=spec, depth=depth)
    if accumulate or blend > 0.0:
        abuf = _add_sums(bins, spec)
    if accumulate:
        return _composite_fields(
            lambda o, hh, ww: _capped_sum_field(abuf, o, hh, ww), spec,
            dilate, want_aux=want_aux, bilinear=bilinear)
    buf = _min_words(bins, spec)
    if blend > 0.0:
        # the nearest-leaf sample mixed with the cell's weighted mean
        def field_of_slab(o, hh, ww):
            return ((1.0 - blend) * _decode_min_field(buf, o, hh, ww)
                    + blend * _capped_sum_field(abuf, o, hh, ww))

        return _composite_fields(field_of_slab, spec, dilate,
                                 want_aux=want_aux, bilinear=bilinear)
    return composite_min_words(buf, spec=spec, bilinear=bilinear,
                               dilate=dilate, want_aux=want_aux)


def _composite_fields(field_of_slab, spec: SlabSpec, dilate: int,
                      want_aux: bool = False, bilinear: bool = False):
    """Front-to-back composite of per-slab premultiplied fields.

    field_of_slab(offset, hh, ww) -> f32[hh, ww, 4] of [w, w*r8, w*g8,
    w*b8] per cell (zero when empty). The per-slab rule mirrors coneTrace
    (cone_tracing_kernels.cu:106-122): add while w_acc < 127. A cell's
    contribution is capped at one march sample's weight (alpha - 127 <=
    128): the cell is the footprint the march samples once. The cap is a
    no-op for the min word, whose alpha is <= 128 by construction, and
    for the scatter-add's fields, capped already, but for the cells that
    `_borrow_empty` filled. `bilinear` upsamples each slab by the tent
    (`_upsample`)."""
    H, W = spec.height, spec.width
    for kk in range(spec.n_slabs):
        sc = spec.scales[kk]
        hh, ww = H // sc, W // sc
        sl = field_of_slab(spec.offsets[kk], hh, ww)
        if kk == 0:
            w_acc = sl.new_zeros((H, W))
            rgb_acc = sl.new_zeros((H, W, 3))
            z_first = sl.new_full((H, W), torch.inf)
        for _ in range(dilate):
            sl = _borrow_empty(sl)
        # the one-sample cap before upsampling
        sl = _upsample(_cap(sl), sc, bilinear)
        w = sl[..., 0]
        gate = ((w > 0.0) & (w_acc < 127.0)).to(torch.float32)
        if want_aux:
            # near boundary of this pixel's first contributing slab (leaf
            # centres in slab k have z >= z_near * ratio^k)
            z_first = torch.where((w_acc == 0.0) & (w > 0.0),
                                  spec.z_near * (spec.ratio ** kk), z_first)
        rgb_acc = rgb_acc + gate[..., None] * sl[..., 1:]
        w_acc = w_acc + gate * w
    if want_aux:
        return _finish(w_acc, rgb_acc, H, W), w_acc, z_first
    return _finish(w_acc, rgb_acc, H, W)


def _finish(w_acc: torch.Tensor, rgb_acc: torch.Tensor, H: int,
            W: int) -> torch.Tensor:
    """Shared composite tail: hole repair + exit rescale -> f32[H, W, 4]."""
    # Image-space hole repair. A curved surface spreads adjacent leaves
    # across slabs, so a slab cell on a sphere limb can stay empty and the
    # ray "tunnels" (black speckles). Borrow the accumulation of the
    # strongest 3x3 neighbour when this pixel is far weaker.
    for _ in range(2):
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

    # exit rescale for unsaturated rays (cone_tracing_kernels.cu:131-139):
    # rgb was accumulated in (alpha * rgb8) units; the march divides each
    # contribution by 127, folded in here, then /255 for the [0,1] image
    scale = torch.where(w_acc >= 127.0, 1.0,
                        127.0 / torch.clamp(w_acc, min=1.0))
    rgb = torch.clamp(rgb_acc * scale[..., None] / 127.0, 0.0, 255.0) / 255.0
    return torch.cat([rgb, torch.ones_like(w_acc)[..., None]], dim=-1)
