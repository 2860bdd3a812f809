"""The splat's z-buffer kernel (render/splat_ops.py, csrc/splat.cu) against
its plain version, render/splat.py's splat_zbuffer, on the card: registries
from a short orbit at kinect1cm_splat's settings (640x480, 1 cm leaves at
depth 9) seen from the orbit's poses and from general ones, and synthetic
registries at depths 9 and 6 with count below the capacity and stale keys
past it, -1 holes, unoccupied words, leaves behind the camera, out of view
and past max_range, thousands of leaves on one pixel, count 0 and count
equal to the capacity; render_splat's framebuffer, the step's, the
recovery's model pyramid and the sharded splat on one card against their
plain paths; one launch a call.
Marked `cuda`: without a CUDA device every test skips. The repository's
conftest imports jax, which the card's machine lacks, so run these there
with

    python -m pytest tests/test_torch_cuda_splat_kernel.py --noconftest -q

Tolerances: none. The kernel repeats the plain version's float32
arithmetic op for op (the camera transform as the fused multiply-add chain
of cuBLAS's SIMT sgemm), and a minimum does not depend on the order of the
atomics, so the z-buffer words, framebuffers and pyramids are equal word
for word (torch.equal) and the live-row count exactly."""

import json
from pathlib import Path

import pytest
import torch

from octree_slam_tpu_torch import SLAMConfig, pipeline, relocalize
from octree_slam_tpu_torch.core import packing
from octree_slam_tpu_torch.map import morton
from octree_slam_tpu_torch.parallel import distributed
from octree_slam_tpu_torch.render import splat, splat_ops
from octree_slam_tpu_torch.sensor import sources
from octree_slam_tpu_torch.utils import spans

pytestmark = pytest.mark.cuda

_SLAM = json.loads((Path(__file__).resolve().parent.parent / "slambench"
                    / "configs" / "kinect1cm_splat.json").read_text())["slam"]
# kinect1cm_splat: 640x480, Kinect focals, 1 cm leaves at depth 9
CFG = SLAMConfig(**{k: tuple(v) if isinstance(v, list) else v
                    for k, v in _SLAM.items()})
FRAMES = 4
STEP = 0.0136               # rad a frame: the benchmark orbit's 0.78 deg
KERNEL = splat_ops.KERNEL


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the splat kernel runs only there")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def mapped(card):
    """(state, the last step's output, the splat launches, the frames'
    counters) after FRAMES splat frames along the orbit."""
    scene = sources.default_scene(card)
    poses = [sources.orbit_pose(i * STEP, radius=2.0, device=card)
             for i in range(FRAMES)]
    state = pipeline.init_state(CFG, initial_pose=poses[0], device=card)
    before = splat_ops.LAUNCHES[KERNEL]
    spans.start()
    for i, pose in enumerate(poses):
        frame = sources.render_frame(scene, pose, CFG.focal_x, CFG.focal_y,
                                     width=CFG.width, height=CFG.height)
        with spans.frame(i):
            state, out = pipeline.step(state, frame, CFG, render="splat")
    rec = spans.stop()
    torch.cuda.synchronize()
    return state, out, splat_ops.LAUNCHES[KERNEL] - before, rec


def _plain(monkeypatch):
    monkeypatch.setattr(splat, "_splat_kernel", lambda device: False)


def _live(keys, count):
    rows = torch.arange(keys.shape[0], device=keys.device)
    return (rows < count) & (keys >= 0)


def _both(vals, keys, count, center, half_size, pose, *, depth,
          width=CFG.width, height=CFG.height, fx=CFG.focal_x,
          fy=CFG.focal_y, max_range=CFG.max_range):
    """(kernel z-buffer, plain z-buffer, stats); the kernel launched once."""
    before = splat_ops.LAUNCHES[KERNEL]
    half = torch.as_tensor(half_size, dtype=torch.float32,
                           device=keys.device)
    got, stats = splat_ops.splat_zbuffer(
        vals, keys, count, center, half, pose, fx, fy, width=width,
        height=height, depth=depth, max_range=max_range, count_stats=True)
    assert splat_ops.LAUNCHES[KERNEL] == before + 1
    live = keys >= 0 if count is None else _live(keys, count)
    want = splat.splat_zbuffer(vals, keys, live, center, half_size, pose, fx,
                               fy, width=width, height=height, depth=depth,
                               max_range=max_range)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert int(stats[0]) == int(live.sum())
    return got, want, stats


def _rotation(gen, dev):
    """A random rotation (QR of a Gaussian matrix, det +1)."""
    q, r = torch.linalg.qr(torch.randn(3, 3, generator=gen,
                                       dtype=torch.float64))
    q = q * torch.sign(torch.diagonal(r))
    if torch.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q.to(torch.float32).to(dev)


def _poses(state, dev):
    """The last orbit pose, three general ones around the map and one
    inside it, each a world_T_cam f32[4, 4]."""
    gen = torch.Generator().manual_seed(23)
    out = [state.pose]
    for k in range(4):
        T = torch.eye(4, dtype=torch.float32, device=dev)
        T[:3, :3] = _rotation(gen, dev)
        # the camera 1.5-2.5 m from the centre, looking at it, or (k == 3)
        # at the centre itself looking anywhere
        if k < 3:
            back = T[:3, 2] * (1.5 + 0.5 * k)
            T[:3, 3] = state.pool.center - back
        else:
            T[:3, 3] = state.pool.center
        out.append(T)
    return out


def test_step_launches_once_a_frame(mapped):
    """The step's splat frames each launch the kernel once, count
    splat_kernel once and never splat_eager."""
    _, _, launches, rec = mapped
    assert launches == FRAMES
    assert rec.counter("splat_kernel") == {i: 1 for i in range(FRAMES)}
    assert set(rec.counter("splat_eager").values()) <= {0}
    assert rec.counter("splat_live_rows")[FRAMES - 1] > 10_000


def test_step_framebuffer_equals_the_plain_path(mapped, monkeypatch):
    """The last step's framebuffer equals render_splat on the plain path,
    word for word, and the plain path launches nothing."""
    state, out, _, _ = mapped
    _plain(monkeypatch)
    before = splat_ops.LAUNCHES[KERNEL]
    want = splat.render_splat(state.pool, state.leaves, state.pose,
                              CFG.focal_x, CFG.focal_y, width=CFG.width,
                              height=CFG.height, depth=CFG.max_depth,
                              max_range=CFG.max_range)
    assert splat_ops.LAUNCHES[KERNEL] == before
    assert torch.equal(out.framebuffer, want)
    assert float(want[..., 3].mean()) > 0.3


def test_orbit_registry_equals_plain(mapped, card):
    """The orbit's registry from the last pose and four general ones, one
    of them inside the map: equal word for word; render_splat's
    framebuffer equal too. A strided view of the pose gives the same
    z-buffer."""
    state, _, _, _ = mapped
    lv = state.leaves
    for k, pose in enumerate(_poses(state, card)):
        got, want, stats = _both(lv.vals, lv.keys, lv.count,
                                 state.pool.center, state.pool.half_size,
                                 pose, depth=CFG.max_depth)
        assert torch.equal(got, want), k
        hits = int((want != splat.EMPTY).sum())
        assert hits <= int(stats[1]) <= int(stats[0])
        if k == 0:
            assert hits > 1000
        wide = torch.zeros((4, 8), device=card)
        wide[:, 2:6] = pose
        strided, _ = splat_ops.splat_zbuffer(
            lv.vals, lv.keys, lv.count, state.pool.center,
            state.pool.half_size, wide[:, 2:6], CFG.focal_x, CFG.focal_y,
            width=CFG.width, height=CFG.height, depth=CFG.max_depth,
            max_range=CFG.max_range)
        assert torch.equal(strided, want), k
        fb = splat.render_splat(state.pool, lv, pose, CFG.focal_x,
                                CFG.focal_y, width=CFG.width,
                                height=CFG.height, depth=CFG.max_depth,
                                max_range=CFG.max_range)
        assert torch.equal(fb, splat.finish_zbuffer(
            want, width=CFG.width, height=CFG.height)), k


def _synthetic(dev, depth, lc, gen):
    """A registry of capacity lc at `depth` in a 2.56 m cube at the
    origin: keys of random points in the cube (so leaves behind the
    camera, out of view and past a short max_range), 5% -1 holes, 20%
    unoccupied words, 4,096 rows of one key near the optical axis with
    other colours (all on one pixel), and stale keys past `count`.
    Returns (keys, vals, half_size, the pile's key)."""
    half = 1.28
    pts = (torch.rand((lc, 3), generator=gen, device=dev) * 2 - 1) * half
    keys, _ = morton.encode(pts, torch.zeros(3, device=dev), half, depth)
    rgba = torch.randint(0, 256, (lc, 4), generator=gen, device=dev)
    vals = packing.pack_rgba8(rgba[:, 0], rgba[:, 1], rgba[:, 2],
                              128 + rgba[:, 3] % 128)
    unocc = torch.rand(lc, generator=gen, device=dev) < 0.2
    vals = torch.where(unocc, vals & 0x00FFFFFF | (127 << 24), vals)
    pile = min(4096, max(lc // 4, 1))
    axis, _ = morton.encode(torch.tensor([[0.01, 0.01, 0.3]], device=dev),
                            torch.zeros(3, device=dev), half, depth)
    keys[:pile] = axis
    vals[:pile] = packing.pack_rgba8(rgba[:pile, 0], rgba[:pile, 1],
                                     rgba[:pile, 2],
                                     torch.full_like(rgba[:pile, 0], 200))
    holes = torch.rand(lc, generator=gen, device=dev) < 0.05
    keys = torch.where(holes, -1, keys)
    return keys.contiguous(), vals.contiguous(), half, axis


@pytest.mark.parametrize("depth", [9, 6])
@pytest.mark.parametrize("case", ["count_below_lc", "count_0",
                                  "count_lc_short_range", "no_count"])
def test_synthetic_registry_equals_plain(card, depth, case):
    """Synthetic registries: the kernel's z-buffer equals the plain
    version's word for word, the stale rows past count change nothing,
    and the pile of one key's rows lands on one pixel."""
    gen = torch.Generator(device=card).manual_seed(depth * 7 + len(case))
    lc = 1 << 18
    count = {"count_below_lc": lc * 3 // 5, "count_0": 0,
             "count_lc_short_range": lc, "no_count": None}[case]
    keys, vals, half, axis = _synthetic(card, depth, lc, gen)
    cnt = (None if count is None
           else torch.tensor(count, dtype=torch.int32, device=card))
    center = torch.zeros(3, device=card)
    # the camera at the cube's -z face looking along +z: the cube's far
    # side is past a short max_range, the near side behind the camera
    pose = torch.eye(4, device=card)
    pose[2, 3] = -0.2
    max_range = 1.0 if case == "count_lc_short_range" else CFG.max_range
    got, want, stats = _both(vals, keys, cnt, center, half, pose,
                             depth=depth, max_range=max_range)
    assert torch.equal(got, want)
    if count == 0:
        assert bool((want == splat.EMPTY).all()) and int(stats[0]) == 0
        return
    assert int((want != splat.EMPTY).sum()) > 1000
    # the pile's pixel holds the least of its words
    c = morton.decode_centers(axis, center, half, depth)
    z = float(c[0, 2] + 0.2)
    px = round(CFG.focal_x * float(c[0, 0]) / z + CFG.width / 2)
    py = round(CFG.height / 2 - CFG.focal_y * float(c[0, 1]) / z)
    assert int(want[py * CFG.width + px]) != splat.EMPTY
    if count is not None and count < lc:
        # stale keys past count: the same z-buffer as with them freed
        freed = torch.where(torch.arange(lc, device=card) < count, keys, -1)
        again, _ = splat_ops.splat_zbuffer(
            vals, freed, None, center, torch.tensor(half, device=card),
            pose, CFG.focal_x, CFG.focal_y, width=CFG.width,
            height=CFG.height, depth=depth, max_range=max_range)
        assert torch.equal(again, want)


def test_relocalize_model_pyramid_equals_eager(mapped, monkeypatch):
    """The recovery's model pyramid from the orbit's registry: the kernel
    path's equals the plain path's word for word, one launch a call."""
    state, _, _, _ = mapped
    args = (state.leaves, state.pool.center, state.pool.half_size,
            state.pose, CFG)
    before = splat_ops.LAUNCHES[KERNEL]
    got = relocalize.model_pyramid(*args)
    assert splat_ops.LAUNCHES[KERNEL] == before + 1
    _plain(monkeypatch)
    want = relocalize.model_pyramid(*args)
    assert splat_ops.LAUNCHES[KERNEL] == before + 1
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert torch.equal(a, b)


def test_sharded_splat_on_one_card(mapped, card, monkeypatch):
    """The 2-D loop's sharded z-buffer over three shards of the orbit's
    registry (rows dealt round-robin, -1 elsewhere), all on one card: one
    launch a shard, equal to the plain path and to the whole registry's
    z-buffer."""
    state, _, _, _ = mapped
    lv = state.leaves
    n = int(lv.count)
    rows = torch.arange(lv.keys.shape[0], device=card)
    shards = [torch.where((rows % 3 == s) & (rows < n), lv.keys, -1)
              for s in range(3)]
    args = ([lv.vals] * 3, shards, state.pool.center, state.pool.half_size,
            state.pose, CFG.focal_x, CFG.focal_y, CFG)
    before = splat_ops.LAUNCHES[KERNEL]
    got = distributed._zbuffer_sharded(*args)
    assert splat_ops.LAUNCHES[KERNEL] == before + 3
    _plain(monkeypatch)
    want = distributed._zbuffer_sharded(*args)
    assert torch.equal(got, want)
    whole = splat.splat_zbuffer(
        lv.vals, lv.keys, _live(lv.keys, lv.count), state.pool.center,
        state.pool.half_size, state.pose, CFG.focal_x, CFG.focal_y,
        width=CFG.width, height=CFG.height, depth=CFG.max_depth,
        max_range=CFG.max_range)
    assert torch.equal(got, whole)


def test_counters_under_the_recorder(mapped):
    """Under the recorder a kernel call counts its live rows (equal to the
    plain live mask's sum) and its atomics (at most the live rows)."""
    state, _, _, _ = mapped
    lv = state.leaves
    spans.start()
    with spans.frame(0):
        splat.render_splat(state.pool, lv, state.pose, CFG.focal_x,
                           CFG.focal_y, width=CFG.width, height=CFG.height,
                           depth=CFG.max_depth, max_range=CFG.max_range)
    c = spans.stop().counters[0]
    assert c["splat_kernel"] == 1 and "splat_eager" not in c
    assert c["splat_live_rows"] == int(_live(lv.keys, lv.count).sum())
    assert 0 < c["splat_atomics"] <= c["splat_live_rows"]


def test_the_wrapper_raises_on_the_card(card):
    """A registry split across devices or a key depth past 10 raises
    before anything launches."""
    keys = torch.zeros(8, dtype=torch.int32, device=card)
    kw = dict(width=64, height=48, depth=9)
    args = [keys, keys, None, torch.zeros(3, device=card),
            torch.tensor(1.0, device=card), torch.eye(4, device=card),
            50.0, 50.0]
    before = splat_ops.LAUNCHES[KERNEL]
    with pytest.raises(ValueError, match="tensors on"):
        splat_ops.splat_zbuffer(*args[:3], torch.zeros(3), *args[4:], **kw)
    with pytest.raises(ValueError, match="depth 11"):
        splat_ops.splat_zbuffer(*args, **dict(kw, depth=11))
    assert splat_ops.LAUNCHES[KERNEL] == before
