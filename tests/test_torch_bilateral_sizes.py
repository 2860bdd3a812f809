"""Port parity: the bilateral filter at every window size the reference
takes (octree_slam_tpu_torch/sensor/image_ops.bilateral_filter against the
JAX package's XLA path, image_ops.py:88-117), the depth pyramid and the
step at a 5x5 window. The kernel behind a size other than 7 is
bilateral_window on the card (tests/test_torch_cuda_bilateral.py holds it
against the plain version that runs here).

Tolerances: the filter is equal or +-1 mm on at most 0.1% of pixels (exp
of two math libraries can straddle a rounding tie); even sizes take the
next odd window, as the reference's half = kernel_size // 2 does, and
size 1 is the depth itself, both exactly; the pyramid's depth levels as
the filter, its maps within 1e-3 (a straddled tie moves a vertex); the
step as tests/test_torch_pipeline.py holds it (pose within 1e-4, counts
equal, 99% of pixels within 1e-4)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from torch_parity import (DEVICE, assert_step_parity, orbit_frames,
                          port_config, rand_depth, step_both, to_t)

from octree_slam_tpu import pipeline as jpipeline
from octree_slam_tpu.config import SLAMConfig
from octree_slam_tpu.sensor import image_ops as jimg
from octree_slam_tpu.sensor import tracking as jtracking
from octree_slam_tpu_torch import pipeline
from octree_slam_tpu_torch.sensor import cuda_ops, image_ops, tracking

CFG = SLAMConfig(width=64, height=48, focal_x=55.0, focal_y=55.0,
                 pyramid_depth=2, pyramid_iters=(6, 6),
                 voxel_resolution=0.05, max_depth=6, node_capacity=1 << 14,
                 leaf_capacity=1 << 12, insert_unique_cap=1 << 10,
                 bilateral_kernel_size=5)


def _assert_bilateral_close(out, ref):
    diff = np.abs(out.astype(np.int64) - ref.astype(np.int64))
    n_off = int((diff > 0).sum())
    assert diff.max(initial=0) <= 1 and n_off <= 0.001 * diff.size, \
        f"{n_off} of {diff.size} pixels differ (max {diff.max()})"


@pytest.mark.parametrize("kernel_size", [1, 2, 3, 4, 5, 6, 8, 9, 10, 11])
def test_matches_jax(kernel_size):
    d = rand_depth(48, 64, seed=kernel_size)
    ref = np.asarray(jimg.bilateral_filter(jnp.asarray(d),
                                           kernel_size=kernel_size))
    out = image_ops.bilateral_filter(to_t(d), kernel_size=kernel_size)
    assert out.shape == (48, 64) and out.dtype == torch.int32
    _assert_bilateral_close(out.numpy(), ref)


def test_sizes_share_windows():
    """An even size is the next odd window; size 1 is the depth; the plain
    version's default is the 7x7 window."""
    d = to_t(rand_depth(20, 24, seed=7))
    for even in (2, 4, 6, 8, 10):
        assert torch.equal(image_ops.bilateral_filter(d, kernel_size=even),
                           image_ops.bilateral_filter(d,
                                                      kernel_size=even + 1))
    assert torch.equal(image_ops.bilateral_filter(d, kernel_size=1), d)
    assert torch.equal(cuda_ops.bilateral_plain(d, 4.5, 40.0),
                       cuda_ops.bilateral_plain(d, 4.5, 40.0, 7))


def test_batch_and_depth_step_at_border():
    """[B, H, W] (the recovery batch) equals each image alone, and a sharp
    step with a zero row at the border matches the reference at 9x9."""
    d = to_t(rand_depth(20, 24, seed=4, batch=3))
    out = image_ops.bilateral_filter(d, kernel_size=9)
    for i in range(3):
        assert torch.equal(out[i],
                           image_ops.bilateral_filter(d[i], kernel_size=9))
    s = np.full((48, 64), 1000, np.uint16)
    s[:, 32:] = 3000
    s[0, :] = 0
    s[:, -1] = 5000
    _assert_bilateral_close(
        image_ops.bilateral_filter(to_t(s), kernel_size=9).numpy(),
        np.asarray(jimg.bilateral_filter(jnp.asarray(s), kernel_size=9)))


def test_build_pyramid_matches_jax():
    depth, color, _ = orbit_frames(CFG, 1)
    jpyr = jtracking.build_pyramid(jnp.asarray(depth[0]),
                                   jnp.asarray(color[0]), CFG)
    tpyr = tracking.build_pyramid(to_t(depth[0]), to_t(color[0]),
                                  port_config(CFG))
    for lvl, (j, t) in enumerate(zip(jpyr, tpyr)):
        for name in t._fields:
            a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
            assert a.shape == b.shape, (lvl, name)
            finite = np.isfinite(a) & np.isfinite(b)
            assert (np.isfinite(a) == np.isfinite(b)).mean() >= 0.999
            np.testing.assert_allclose(a[finite], b[finite], atol=1e-3,
                                       err_msg=f"L{lvl} {name}")


def test_step_at_5x5_matches_reference():
    stream = orbit_frames(CFG, 3)
    tcfg = port_config(CFG)
    gt = to_t(stream[2][0])
    jstate = jpipeline.init_state(CFG, initial_pose=jnp.asarray(gt.numpy()))
    tstate = pipeline.init_state(tcfg, initial_pose=gt, device=DEVICE)
    for i in range(3):
        jstate, jo, tstate, to = step_both(jstate, tstate, CFG, tcfg, stream,
                                           i, "splat")
        assert_step_parity(tstate, to, jstate, jo, f"5x5 frame {i}")
        assert not bool(to.diverged)
    assert int(to.map_leaves) > 500
    # the window reached the step: a 7x7 pyramid of the frame differs
    seven = dataclasses.replace(tcfg, bilateral_kernel_size=7)
    frame = [to_t(a[0]) for a in stream[:2]]
    assert not torch.equal(tracking.build_pyramid(*frame, seven)[0].vertex,
                           tracking.build_pyramid(*frame, tcfg)[0].vertex)
