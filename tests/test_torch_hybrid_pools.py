"""Port parity: the hybrid's window pools (render/hybrid.py `_pool_max` /
`_pool_min`) against `lax.reduce_window`, and an empty map rendered by the
hybrid in both packages (the band march itself is in
tests/test_torch_hybrid.py).

Tolerances: the pools bit-exact, +inf entries included; the empty map
black in both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from torch_parity import DEVICE, port_config, to_t

from octree_slam_tpu import pipeline as jpipeline
from octree_slam_tpu.config import SLAMConfig
from octree_slam_tpu.render import conesplat as jcs
from octree_slam_tpu.render import hybrid as jhybrid
from octree_slam_tpu_torch import pipeline
from octree_slam_tpu_torch.render import conesplat as cs
from octree_slam_tpu_torch.render import hybrid


CFG = SLAMConfig(width=64, height=48, focal_x=55.0, focal_y=55.0,
                 pyramid_depth=2, pyramid_iters=(6, 6),
                 voxel_resolution=0.05, max_depth=6, node_capacity=1 << 14,
                 leaf_capacity=1 << 12, insert_unique_cap=1 << 10)


TCFG = port_config(CFG)


LVL = 4   # pipeline._accel_level(CFG)


SPEC_KW = dict(width=CFG.width, height=CFG.height, fx=CFG.focal_x,
               leaf_size=CFG.voxel_resolution, z_near=CFG.cone_znear,
               z_far=CFG.max_range, n_slabs=CFG.cone_slabs,
               max_scale=CFG.cone_max_scale)


@pytest.mark.parametrize("half,shape", [(2, (48, 64)), (4, (48, 64)),
                                        (1, (7, 5)), (4, (6, 9))])
def test_pools_bit_exact_against_reduce_window(half, shape):
    rng = np.random.default_rng(half + shape[0])
    grad = rng.random(shape).astype(np.float32)
    grad[rng.random(shape) < 0.7] = 0.0            # flat regions: exact ties
    z = rng.uniform(0.3, 5.0, shape).astype(np.float32)
    z[rng.random(shape) < 0.5] = np.inf
    big = shape[0] > 2 * half + 2
    if big:
        z[:half + 2] = np.inf                       # whole windows of +inf
    k = 2 * half + 1
    want_max = jax.lax.reduce_window(jnp.asarray(grad), jnp.float32(0.0),
                                     jax.lax.max, (k, k), (1, 1), "SAME")
    want_min = jax.lax.reduce_window(jnp.asarray(z), jnp.float32(jnp.inf),
                                     jax.lax.min, (k, k), (1, 1), "SAME")
    np.testing.assert_array_equal(hybrid._pool_max(to_t(grad), half).numpy(),
                                  np.asarray(want_max))
    got_min = hybrid._pool_min(to_t(z), half).numpy()
    np.testing.assert_array_equal(got_min, np.asarray(want_min))
    assert np.isfinite(got_min).any() and np.isinf(got_min).any() == big


def test_empty_map_is_black():
    jstate = jpipeline.init_state(CFG)
    tstate = pipeline.init_state(TCFG, device=DEVICE)
    kw = dict(depth=CFG.max_depth, dist_level=LVL, band_iters=6,
              fused_dist=True)
    jfb = jhybrid.render_cone_hybrid(
        jstate.leaves, jstate.accel, jstate.pool.center,
        jstate.pool.half_size, jstate.pose, CFG.focal_x, CFG.focal_y,
        spec=jcs.make_slab_spec(**SPEC_KW), **kw)
    tfb = hybrid.render_cone_hybrid(
        tstate.leaves, tstate.accel, tstate.pool.center,
        tstate.pool.half_size, tstate.pose, CFG.focal_x, CFG.focal_y,
        spec=cs.make_slab_spec(**SPEC_KW), **kw)
    assert float(tfb[..., :3].abs().max()) == 0.0
    np.testing.assert_array_equal(tfb.numpy(), np.asarray(jfb))
