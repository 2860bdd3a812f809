"""Port parity: the leaf registry and the splat renderer against the JAX
package on identical inputs.

Tolerances: the registry (keys, nodes, vals, node2pos, count) and packed
z-buffer words are bit-identical; the framebuffer is identical as 8-bit
colours (XLA folds the reference's `/ 255` into a reciprocal multiply,
which can move a float one ulp). With a rotation whose entries are 0 and
+-1 the camera transform is exact in any summation order, so the words
must match everywhere; under a general rotation the 3-term products round
differently in the two libraries and at least 99.9% of words must match."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from torch_parity import DEVICE, random_cloud, to_t, words

from octree_slam_tpu.map import svo as jsvo
from octree_slam_tpu.render import splat as jsplat
from octree_slam_tpu.sensor import sources as jsources
from octree_slam_tpu_torch.map import svo
from octree_slam_tpu_torch.render import splat

DEPTH, CAP, LC, U = 6, 1 << 14, 1 << 11, 1 << 12
W, H, FX = 64, 48, 55.0


def _stream(n_frames=3):
    """Both packages' pool + registry after the same insert stream."""
    jpool = jsvo.create(CAP, jnp.zeros(3), 1.0)
    tpool = svo.create(CAP, torch.zeros(3), 1.0, device=DEVICE)
    jl = jsplat.create_leaf_list(LC, CAP)
    tl = splat.create_leaf_list(LC, CAP, device=DEVICE)
    pts0, cols = random_cloud(3000, seed=21, lo=-0.6, hi=0.6)
    for fr in range(n_frames):
        pts = pts0 + np.float32(0.03 * fr)
        jpool, jst = jsvo.insert(jpool, jnp.asarray(pts), jnp.asarray(cols),
                                 depth=DEPTH, unique_cap=U,
                                 update_interior=False)
        tpool, tst = svo.insert(tpool, to_t(pts), to_t(cols), depth=DEPTH,
                                unique_cap=U)
        jl = jsplat.append_new_leaves(jl, jst)
        tl = splat.append_new_leaves(tl, tst)
    return jpool, jl, tpool, tl


def _axis_pose():
    """Camera 2 m in front of the cloud, rotated 180 degrees about y."""
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.diag([-1.0, 1.0, -1.0])
    T[:3, 3] = [0.0, 0.1, 2.0]
    return T


def test_registry_bit_identical():
    _, jl, _, tl = _stream()
    for name in ("keys", "nodes", "node2pos", "count", "overflowed"):
        np.testing.assert_array_equal(getattr(tl, name).numpy(),
                                      np.asarray(getattr(jl, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(words(tl.vals), np.asarray(jl.vals))
    assert int(tl.count) > 500


def test_registry_overflow_flag():
    jl = jsplat.create_leaf_list(64, CAP)
    tl = splat.create_leaf_list(64, CAP, device=DEVICE)
    pts, cols = random_cloud(500, seed=2)
    _, jst = jsvo.insert(jsvo.create(CAP, jnp.zeros(3), 1.0),
                         jnp.asarray(pts), jnp.asarray(cols), depth=DEPTH,
                         unique_cap=U, update_interior=False)
    _, tst = svo.insert(svo.create(CAP, torch.zeros(3), 1.0, device=DEVICE),
                        to_t(pts), to_t(cols), depth=DEPTH, unique_cap=U)
    jl = jsplat.append_new_leaves(jl, jst)
    tl = splat.append_new_leaves(tl, tst)
    assert bool(tl.overflowed) and bool(jl.overflowed)
    assert int(tl.count) == int(jl.count) == 64
    np.testing.assert_array_equal(tl.keys.numpy(), np.asarray(jl.keys))
    np.testing.assert_array_equal(tl.node2pos.numpy(), np.asarray(jl.node2pos))


@pytest.mark.parametrize("general", [False, True])
def test_zbuffer_dilation_and_framebuffer(general):
    jpool, jl, tpool, tl = _stream()
    pose = (np.asarray(jsources.orbit_pose(0.3, radius=2.0)) if general
            else _axis_pose())
    live = (np.arange(LC) < int(jl.count)) & (np.asarray(jl.keys) >= 0)
    kw = dict(width=W, height=H, depth=DEPTH)
    jb = np.asarray(jsplat.splat_zbuffer(
        jl.vals, jl.keys, jnp.asarray(live), jpool.center, jpool.half_size,
        jnp.asarray(pose), FX, FX, **kw))
    tb = splat.splat_zbuffer(tl.vals, tl.keys, to_t(live), tpool.center,
                             tpool.half_size, to_t(pose), FX, FX,
                             **kw).numpy()
    assert (jb != splat.EMPTY).sum() > 300
    same = (jb == tb).mean()
    if general:
        assert same >= 0.999, f"{(jb != tb).sum()} words differ"
        tb = jb.copy()          # dilate/finish on identical input below
    else:
        np.testing.assert_array_equal(tb, jb)

    jd = np.asarray(jsplat.dilate_zbuffer(jnp.asarray(jb), width=W,
                                          height=H))
    td = splat.dilate_zbuffer(to_t(tb), width=W, height=H).numpy()
    np.testing.assert_array_equal(td, jd)

    jf = np.asarray(jsplat.finish_zbuffer(jnp.asarray(jb), width=W, height=H))
    tf = splat.finish_zbuffer(to_t(tb), width=W, height=H).numpy()
    np.testing.assert_array_equal(np.round(tf * 255), np.round(jf * 255))
    np.testing.assert_allclose(tf, jf, rtol=2e-7, atol=0)


def test_render_splat_end_to_end():
    jpool, jl, tpool, tl = _stream()
    pose = _axis_pose()
    kw = dict(width=W, height=H, depth=DEPTH, max_range=10.0)
    jf = np.asarray(jsplat.render_splat(jpool, jl, jnp.asarray(pose), FX, FX,
                                        **kw))
    tf = splat.render_splat(tpool, tl, to_t(pose), FX, FX, **kw).numpy()
    assert tf.shape == (H, W, 4) and (tf[..., 3] > 0).sum() > 300
    np.testing.assert_array_equal(np.round(tf * 255), np.round(jf * 255))
