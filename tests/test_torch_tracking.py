"""Port parity: pyramid and point-to-plane ICP against the JAX package.

On the CPU every call takes the eager loop: the CUDA graph's eligibility
rule and its cache key are held here, the graph itself on the card
(tests/test_torch_cuda_track_graph.py).

Tolerances: pyramid maps within 1e-6 with identical INF masks (depth and
intensity levels bit-exact, see test_torch_image_ops for the filter's
+-1 mm bound); the 19-iteration track pose within 1e-5 with equal inlier
counts and an equal divergence flag (the 6x6 Gram sums 4800 products in
another order, a few float32 ulps)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from torch_parity import orbit_frames, port_config, to_t

from octree_slam_tpu.config import SLAMConfig
from octree_slam_tpu.core import se3 as jse3
from octree_slam_tpu.sensor import sources as jsources, tracking as jtracking
from octree_slam_tpu_torch.core.types import PyramidLevel
from octree_slam_tpu_torch.sensor import tracking

# tests/test_tracking.py's small config with the production 3-level
# {10, 5, 4} schedule: 19 Gauss-Newton iterations
CFG = SLAMConfig(width=80, height=60, focal_x=70.0, focal_y=70.0)
TCFG = port_config(CFG)


def _to_port(pyr):
    return [PyramidLevel(*(to_t(np.asarray(x)) for x in lvl)) for lvl in pyr]


def _pyramids(cfg, angle_a, angle_b):
    """synth_pyramids (tests/test_tracking.py) from the same frames."""
    scene = jsources.default_scene()
    out = []
    for ang in (angle_a, angle_b):
        f = jsources.render_frame(scene, jsources.orbit_pose(ang, radius=2.0),
                                  cfg.focal_x, cfg.focal_y, width=cfg.width,
                                  height=cfg.height)
        out.append(jtracking.build_pyramid(f.depth, f.color, cfg))
    return out


class TestPyramid:
    def test_pyramid_maps_match(self):
        depth, color, _ = orbit_frames(CFG, 1)
        jp = jtracking.build_pyramid(jnp.asarray(depth[0]),
                                     jnp.asarray(color[0]), CFG)
        tp = tracking.build_pyramid(to_t(depth[0]), to_t(color[0]), TCFG)
        assert len(tp) == len(jp) == CFG.pyramid_depth
        for jl, tl in zip(jp, tp):
            for name in ("vertex", "normal", "intensity"):
                ref = np.asarray(getattr(jl, name))
                out = getattr(tl, name).numpy()
                assert out.shape == ref.shape, name
                np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
                np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6,
                                           err_msg=name)


class TestTrack:
    def test_track_pose_matches(self):
        pa, pb = _pyramids(CFG, 0.0, 0.02)
        jT, jst = jtracking.track(pa, pb, CFG)
        tT, tst = tracking.track(_to_port(pa), _to_port(pb), TCFG)
        np.testing.assert_allclose(tT.numpy(), np.asarray(jT), atol=1e-5)
        np.testing.assert_array_equal(tst.inliers.numpy(),
                                      np.asarray(jst.inliers))
        np.testing.assert_allclose(tst.residual.numpy(),
                                   np.asarray(jst.residual), rtol=1e-4)
        assert bool(tst.diverged) == bool(jst.diverged) is False
        # and it recovers the true motion like the reference does
        gt = np.asarray(jse3.inverse(jsources.orbit_pose(0.0))
                        @ jsources.orbit_pose(0.02))
        assert np.linalg.norm(tT.numpy()[:3, 3] - gt[:3, 3]) < 0.01

    def test_garbage_frame_diverges_in_both(self):
        h, w = CFG.height, CFG.width
        lvls = [jtracking.PyramidLevel(
            vertex=jnp.full((h >> i, w >> i, 3), jnp.inf),
            normal=jnp.full((h >> i, w >> i, 3), jnp.inf),
            intensity=jnp.zeros((h >> i, w >> i)))
            for i in range(CFG.pyramid_depth)]
        jT, jst = jtracking.track(lvls, lvls, CFG)
        tT, tst = tracking.track(_to_port(lvls), _to_port(lvls), TCFG)
        assert bool(jst.diverged) and bool(tst.diverged)
        np.testing.assert_array_equal(tT.numpy(), np.eye(4))
        np.testing.assert_array_equal(tT.numpy(), np.asarray(jT))

    def test_non_positive_definite_system_freezes_update(self):
        # not positive definite: cho_factor yields NaN in JAX; the port
        # maps cholesky_ex's info > 0 to NaN instead of raising
        A = -np.eye(6, dtype=np.float32)
        b = np.ones(6, np.float32)
        jx = np.asarray(jtracking.solve_normal_equations(jnp.asarray(A),
                                                         jnp.asarray(b)))
        tx = tracking.solve_normal_equations(to_t(A), to_t(b)).numpy()
        assert not np.isfinite(jx).all() and not np.isfinite(tx).all()
        # a level whose every system is degenerate keeps T fixed, flagged
        lvl = PyramidLevel(vertex=torch.full((6, 8, 3), torch.inf),
                           normal=torch.full((6, 8, 3), torch.inf),
                           intensity=torch.zeros(6, 8))
        T0 = torch.eye(4)
        T, div, count, _ = tracking._track_level(lvl, lvl, T0, 3, TCFG)
        assert torch.equal(T, T0) and bool(div) and int(count) == 0

    def test_normal_equations_match(self):
        rng = np.random.default_rng(0)
        n = 500
        v1 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        v1[:, 2] = rng.uniform(0.3, 3.0, n)
        v2 = v1 + rng.normal(0, 0.02, (n, 3)).astype(np.float32)
        n1 = rng.normal(size=(n, 3)).astype(np.float32)
        n1 /= np.linalg.norm(n1, axis=1, keepdims=True)
        n2 = n1 + rng.normal(0, 0.05, (n, 3)).astype(np.float32)
        n2 /= np.linalg.norm(n2, axis=1, keepdims=True)
        v1[3] = np.inf
        v2[7, 2] = 0.01
        for sym, huber in ((True, 0.02), (False, 0.0)):
            cfg = SLAMConfig(icp_symmetric=sym, icp_huber_k=huber)
            jA, jb, jc, jr = jtracking.icp_normal_equations(
                *(jnp.asarray(x) for x in (v1, n1, v2, n2)), cfg)
            tA, tb, tc, tr = tracking.icp_normal_equations(
                *(to_t(x) for x in (v1, n1, v2, n2)), port_config(cfg))
            assert int(tc) == int(jc)
            np.testing.assert_allclose(tA.numpy(), np.asarray(jA),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(tb.numpy(), np.asarray(jb),
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(float(tr), float(jr), rtol=1e-5)


class _OnCard:
    """Stands for a map on a CUDA device: the eligibility rule reads only
    the device."""
    device = torch.device("cuda", 0)


def _card_pyramid():
    return [PyramidLevel(_OnCard(), _OnCard(), _OnCard())
            for _ in range(CFG.pyramid_depth)]


class TestGraphRule:
    @pytest.mark.parametrize("case", ["one_slab", "two_slabs", "offset_slab",
                                      "psum", "cpu"])
    def test_eligibility(self, case, monkeypatch):
        """Only the whole frame as one slab on a CUDA device with the
        default psum replays the graph; CPU tensors, several slabs and a
        custom psum run the eager loop."""
        card = _card_pyramid()
        slabs, psum = {
            "one_slab": ([(0, card)], tracking._identity),
            "two_slabs": ([(0, card), (32, card)], tracking._identity),
            "offset_slab": ([(32, card)], tracking._identity),
            "psum": ([(0, card)], lambda xs: xs),
            "cpu": (None, tracking._identity)}[case]
        if slabs is not None:
            assert tracking._graph_eligible(slabs, psum) is (
                case == "one_slab")
            return
        # a real call on the CPU: the eager loop, counted, no graph
        def no_graph(*a, **k):
            raise AssertionError("the CPU took the graph")
        monkeypatch.setattr(tracking, "_track_graph", no_graph)
        tracking.reset_calls()
        pa, pb = _pyramids(CFG, 0.0, 0.02)
        T, st = tracking.track(_to_port(pa), _to_port(pb), TCFG)
        assert tracking.CALLS == {"track_graph_captures": 0,
                                  "track_graph_replays": 0,
                                  "track_eager": 1}
        assert not bool(st.diverged) and T.shape == (4, 4)

    @pytest.mark.parametrize("change", ["shape", "icp", "schedule",
                                        "photometric", "unread"])
    def test_cache_key(self, change):
        """The key differs when a map's shape, an icp_* field, the
        schedule or w_rgbd and the camera differ, and is equal when only
        fields the Gauss-Newton loop does not read differ."""
        def pyramid(h, w):
            # the key reads shapes, types and the device, not values
            return [PyramidLevel(torch.zeros(h >> i, w >> i, 3),
                                 torch.zeros(h >> i, w >> i, 3),
                                 torch.zeros(h >> i, w >> i))
                    for i in range(CFG.pyramid_depth)]
        pa, pb = pyramid(60, 80), pyramid(60, 80)
        key = tracking.graph_key(pa, pb, TCFG)
        assert tracking.graph_key(pa, pb, TCFG) == key
        if change == "shape":
            small = pyramid(30, 40)
            assert tracking.graph_key(pa, small, TCFG) != key
            assert tracking.graph_key(small, pb, TCFG) != key
            placeholder = list(pb)
            placeholder[0] = PyramidLevel(torch.full((1, 1, 3), torch.inf),
                                          torch.full((1, 1, 3), torch.inf),
                                          pb[0].intensity)
            assert tracking.graph_key(pa, placeholder, TCFG) != key
            return

        def other(v):
            if isinstance(v, bool):
                return not v
            if isinstance(v, tuple):
                return v[:-1] + (v[-1] + 1,)
            return v + 1
        fields = {
            "icp": [f.name for f in dataclasses.fields(TCFG)
                    if f.name.startswith("icp_")],
            "schedule": ["pyramid_depth", "pyramid_iters",
                         "track_finest_level"],
            "photometric": ["w_rgbd", "focal_x", "focal_y", "width",
                            "height"],
            "unread": ["voxel_resolution", "max_depth", "track_keyframe",
                       "bilateral_kernel_size", "insert_unique_cap",
                       "fuse_level", "relocalize"]}[change]
        for f in fields:
            cfg = dataclasses.replace(TCFG, **{f: other(getattr(TCFG, f))})
            assert (tracking.graph_key(pa, pb, cfg) == key) is (
                change == "unread"), f
