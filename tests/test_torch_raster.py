"""Port parity for render/points.py and render/raster.py against the JAX
package: the packed point z-buffer word for word, the voxel splats, the
triangle rasterizer for each shading with and without a texture, culled
and not, the wireframe and the vertex passes, and a voxel-cube mesh whose
faces tie in depth, resolved by the port's tie rule.

Tolerances: coverage (alpha) equal on every pixel; the packed point words,
the splat images and the wireframe and vertex images equal bit for bit;
triangle colours within 1e-5 except on at most 0.5% of the covered pixels
of the random soup, and within 1e-4 there. The reason for those few: the
reference's projection of all corners is one [3F, 4] x [4, 4] matrix
product, which XLA:CPU runs through an Eigen kernel whose summation order
depends on the shape; the port's fused chain equals it on most values and
lands an ulp apart on the rest, and the barycentrics of thin, slanted
triangles magnify that ulp. The cube meshes match to 1e-5 everywhere."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity  # noqa: F401  (pins torch to one thread)
from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)

from octree_slam_tpu.core import camera as jcamera
from octree_slam_tpu.core.types import BoundingBox as JBox
from octree_slam_tpu.core.types import Mesh as JMesh
from octree_slam_tpu.core.types import VoxelGrid as JGrid
from octree_slam_tpu.map import voxelization as jvox
from octree_slam_tpu.render import points as jpoints
from octree_slam_tpu.render import raster as jraster
from octree_slam_tpu_torch.core.types import BoundingBox, Camera, Mesh
from octree_slam_tpu_torch.render import points, raster
from octree_slam_tpu_torch.utils import compaction

W, H = 80, 60
EYES = [(1.5, 1.2, 2.0), (-0.3, 2.2, 0.9)]
TEX = np.random.default_rng(7).uniform(0, 1, (16, 16, 3)).astype(np.float32)


def _cube_mesh(seed=1):
    """voxel_grid_to_mesh of about half a 5^3 block: neighbouring cubes'
    faces coincide, so their fragments tie in depth."""
    rng = np.random.default_rng(seed)
    cen = np.stack(np.meshgrid(*[np.arange(-2, 3)] * 3, indexing="ij"),
                   -1).reshape(-1, 3).astype(np.float32) * 0.2
    cen = cen[rng.random(len(cen)) < 0.5]
    grid = JGrid(jnp.asarray(cen),
                 jnp.asarray(rng.uniform(0, 1, (len(cen), 4))
                             .astype(np.float32)),
                 jnp.int32(len(cen)), jnp.float32(0.1),
                 JBox(jnp.zeros(3), jnp.ones(3)))
    return jvox.voxel_grid_to_mesh(grid)


def _soup_mesh(n=200, seed=1):
    rng = np.random.default_rng(seed)
    v = (rng.uniform(-0.8, 0.8, (n, 1, 3))
         + rng.normal(0, 0.2, (n, 3, 3))).reshape(-1, 3).astype(np.float32)
    return JMesh(jnp.asarray(v),
                 jnp.asarray(rng.normal(0, 1, v.shape).astype(np.float32)),
                 jnp.asarray(rng.uniform(0, 1, v.shape).astype(np.float32)),
                 jnp.asarray(np.arange(3 * n, dtype=np.int32).reshape(n, 3)),
                 jnp.asarray(rng.uniform(0, 1, (n, 3, 2)).astype(np.float32)),
                 JBox(jnp.zeros(3), jnp.ones(3)))


MESHES = {"cube": _cube_mesh, "soup": _soup_mesh}


def _t(x):
    return torch.from_numpy(np.array(x))


def _camera(eye):
    jc = jcamera.make_camera(jnp.asarray(eye), jnp.zeros(3),
                             jnp.asarray([0.0, 1.0, 0.0]), 50.0, W / H)
    return jc, Camera(*(_t(getattr(jc, f)) for f in jc._fields))


def _port_mesh(jm):
    return raster.RasterMesh(*(_t(x) for x in jraster.assemble(jm)))


def _assert_image(tf, jf, allowed_share):
    covered = jf[..., 3] > 0
    np.testing.assert_array_equal(tf[..., 3], jf[..., 3])
    err = np.abs(tf[..., :3] - jf[..., :3]).max(-1)
    assert err.max() <= 1e-4, err.max()
    over = int((err > 1e-5).sum())
    assert over <= allowed_share * covered.sum(), (over, covered.sum())
    return over


@pytest.mark.parametrize("name", sorted(MESHES))
@pytest.mark.parametrize("eye,shading,textured,cull", [
    (EYES[0], "diffuse", False, True), (EYES[1], "color", False, False),
    (EYES[1], "phong", True, True), (EYES[0], "color", True, False)],
    ids=["diffuse", "color_nocull", "phong_tex", "color_tex_nocull"])
def test_rasterize_matches_reference(name, eye, shading, textured, cull,
                                     monkeypatch):
    jm = MESHES[name]()
    jc, tc = _camera(eye)
    tex = TEX if textured else None
    jf = np.asarray(jraster.rasterize(
        jraster.assemble(jm), jc.mvp, width=W, height=H, frag_budget=512,
        texture=None if tex is None else jnp.asarray(tex), shading=shading,
        cull_backfaces=cull, eye_pos=eye))
    # chunks of 37 triangles: the passes span chunk boundaries
    monkeypatch.setattr(compaction, "CHUNK_LANES", 512 * 37)
    tf = raster.rasterize(
        _port_mesh(jm), tc.mvp, width=W, height=H, frag_budget=512,
        texture=None if tex is None else _t(tex), shading=shading,
        cull_backfaces=cull, eye_pos=eye).numpy()
    assert (jf[..., 3] > 0).sum() > 300
    _assert_image(tf, jf, 0.0 if name == "cube" else 0.005)


def test_depth_ties_take_the_last_lane():
    """On the voxel-cube mesh, fragments of coinciding faces tie at the
    quantised depth. The reference writes every winner and XLA:CPU keeps
    the last lane's write; the port writes the largest lane alone. The
    test checks that ties occur where the tied winners' colours differ,
    and that the image is the reference's."""
    jm = _cube_mesh()
    jc, tc = _camera(EYES[0])
    rm = _port_mesh(jm)
    budget = 512
    scr = raster._screen(rm, tc.mvp, W, H, False)
    f = raster._fragments(scr, 0, rm.pos.shape[0], W, H, budget)
    zbuf = torch.full((W * H + 1,), points.DEPTH_INF, dtype=torch.int32)
    zbuf.scatter_reduce_(0, f.idx.reshape(-1).long(),
                         torch.where(f.hit, f.q, points.DEPTH_INF)
                         .reshape(-1), reduce="amin")
    won = (f.hit & (zbuf[f.idx.long()] == f.q)).reshape(-1)
    rgb = raster._shade(rm, 0, rm.pos.shape[0], f.bary, None,
                        torch.zeros(3), torch.zeros(3), "color").reshape(-1, 3)
    pix = f.idx.reshape(-1)[won]
    lanes = torch.nonzero(won).squeeze(1)
    counts = torch.bincount(pix, minlength=W * H + 1)
    tied = torch.nonzero(counts > 1).squeeze(1)
    differ = 0
    for p in tied.tolist():
        ls = lanes[pix == p]
        differ += int((rgb[ls.max()] - rgb[ls.min()]).abs().max() > 0.01)
    assert len(tied) > 20 and differ > 10, (len(tied), differ)
    jf = np.asarray(jraster.rasterize(
        jraster.assemble(jm), jc.mvp, width=W, height=H, frag_budget=budget,
        shading="color", cull_backfaces=False))
    tf = raster.rasterize(rm, tc.mvp, width=W, height=H, frag_budget=budget,
                          shading="color", cull_backfaces=False).numpy()
    _assert_image(tf, jf, 0.0)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_wireframe_and_vertices(name):
    jm = MESHES[name]()
    jrm, trm = jraster.assemble(jm), _port_mesh(jm)
    for eye, samples in zip(EYES, (48, 7)):
        jc, tc = _camera(eye)
        jw = np.asarray(jraster.rasterize_wireframe(
            jrm, jc.mvp, width=W, height=H, samples=samples))
        tw = raster.rasterize_wireframe(trm, tc.mvp, width=W, height=H,
                                        samples=samples).numpy()
        np.testing.assert_array_equal(tw, jw)
        assert jw[..., 3].sum() > 50
        jv = np.asarray(jraster.rasterize_vertices(jrm, jc.mvp, width=W,
                                                   height=H))
        tv = raster.rasterize_vertices(trm, tc.mvp, width=W,
                                       height=H).numpy()
        np.testing.assert_array_equal(tv, jv)
        assert jv[..., 3].sum() > 50


def test_rasterize_mesh_auto_budget_and_eye():
    jm = _soup_mesh(60, seed=4)
    jc, tc = _camera(EYES[1])
    tm_mesh = Mesh(*(_t(getattr(jm, f)) for f in jm._fields[:5]),
                   bbox=BoundingBox(_t(jm.bbox.bbox0), _t(jm.bbox.bbox1)))
    assert raster.auto_frag_budget(60, W, H) == 320
    assert raster.auto_frag_budget(1, 640, 480) == 65536
    jf = np.asarray(jraster.rasterize_mesh(jm, jc, width=W, height=H,
                                           shading="phong"))
    tf = raster.rasterize_mesh(tm_mesh, tc, width=W, height=H,
                               shading="phong").numpy()
    _assert_image(tf, jf, 0.005)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_points_and_voxels(name):
    rng = np.random.default_rng(3)
    pts = np.asarray(MESHES[name]().vertices)
    cols = rng.uniform(0, 1, pts.shape).astype(np.float32)
    live = rng.random(len(pts)) < 0.8
    jc, tc = _camera((1.1, 0.7, 1.6))
    # the reference's packed buffer, from its own projection and resolve
    xy, z, valid = jpoints.project(jnp.asarray(pts), jc.mvp, W, H)
    xi = jnp.floor(xy[:, 0]).astype(jnp.int32)
    yi = jnp.floor(xy[:, 1]).astype(jnp.int32)
    inb = valid & (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    jb = np.asarray(jax.jit(lambda *a: jpoints._resolve(*a, W * H))(
        yi * W + xi, z, jnp.asarray(cols), inb))
    tb = points.points_zbuffer(_t(pts), _t(cols), tc.mvp, width=W,
                               height=H).numpy()
    np.testing.assert_array_equal(tb, jb)
    assert (jb != points.DEPTH_INF).sum() > 100
    np.testing.assert_array_equal(
        points.render_points(_t(pts), _t(cols), tc.mvp, width=W,
                             height=H).numpy(),
        np.asarray(jpoints.render_points(jnp.asarray(pts), jnp.asarray(cols),
                                         jc.mvp, width=W, height=H)))
    for max_splat, scale in ((4, 0.03), (1, 0.01)):
        jv = np.asarray(jpoints.render_voxels(
            jnp.asarray(pts), jnp.asarray(cols), scale, jnp.asarray(live),
            jc.view, jc.mvp, width=W, height=H, max_splat=max_splat,
            proj_focal=jc.projection[1, 1]))
        tv = points.render_voxels(
            _t(pts), _t(cols), scale, _t(live), tc.view, tc.mvp, width=W,
            height=H, max_splat=max_splat,
            proj_focal=tc.projection[1, 1]).numpy()
        np.testing.assert_array_equal(tv, jv)
    # without proj_focal both take mvp[1, 1]
    np.testing.assert_array_equal(
        points.render_voxels(_t(pts), _t(cols), 0.03, _t(live), tc.view,
                             tc.mvp, width=W, height=H, max_splat=1).numpy(),
        np.asarray(jpoints.render_voxels(
            jnp.asarray(pts), jnp.asarray(cols), 0.03, jnp.asarray(live),
            jc.view, jc.mvp, width=W, height=H, max_splat=1)))
