"""Port parity: the plain bilateral at the window sizes the card's tests
add (tests/test_torch_cuda_bilateral.py) beyond those of
tests/test_torch_bilateral_sizes.py: 2 and 4 (the compiled radii 1 and 2
by an even size), 13 (the widest compiled radius, 6) and 15 and 17 (the
run-time-radius kernel), against the JAX package's XLA path
(octree_slam_tpu/sensor/image_ops.bilateral_filter). With the card's
tests this holds kernel -> plain -> JAX at every size chip_smoke.py runs.

Tolerance: as tests/test_torch_bilateral_sizes.py states it, equal or
+-1 mm on at most 0.1% of pixels (exp of two math libraries can straddle
a rounding tie)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from torch_parity import rand_depth, to_t

from octree_slam_tpu.sensor import image_ops as jimg
from octree_slam_tpu_torch.sensor import cuda_ops, image_ops


def _assert_bilateral_close(out, ref):
    diff = np.abs(out.astype(np.int64) - ref.astype(np.int64))
    n_off = int((diff > 0).sum())
    assert diff.max(initial=0) <= 1 and n_off <= 0.001 * diff.size, \
        f"{n_off} of {diff.size} pixels differ (max {diff.max()})"


@pytest.mark.parametrize("kernel_size", [2, 4, 13, 15, 17])
def test_matches_jax(kernel_size):
    d = rand_depth(48, 64, seed=kernel_size)
    ref = np.asarray(jimg.bilateral_filter(jnp.asarray(d),
                                           kernel_size=kernel_size))
    out = image_ops.bilateral_filter(to_t(d), kernel_size=kernel_size)
    assert out.shape == (48, 64) and out.dtype == torch.int32
    _assert_bilateral_close(out.numpy(), ref)


@pytest.mark.parametrize("kernel_size", [13, 17])
def test_batch_matches_jax(kernel_size):
    """[B, H, W] (the recovery batch) against the reference image by
    image, and equal to each image filtered alone."""
    d = rand_depth(48, 64, seed=100 + kernel_size, batch=2)
    out = image_ops.bilateral_filter(to_t(d), kernel_size=kernel_size)
    for i in range(2):
        assert torch.equal(out[i], image_ops.bilateral_filter(
            to_t(d[i]), kernel_size=kernel_size))
        _assert_bilateral_close(out[i].numpy(), np.asarray(
            jimg.bilateral_filter(jnp.asarray(d[i]),
                                  kernel_size=kernel_size)))


def test_instances_by_size():
    """Which kernel the card runs at each size: the compiled instances up
    to radius 6 (size 13), the run-time radius from 7 (size 14) on."""
    assert cuda_ops.MAX_COMPILED_HALF == 6
    assert cuda_ops.bilateral_instance(0) == "none: a copy"
    assert cuda_ops.bilateral_instance(1) == "none: a copy"
    for k in range(2, 14):
        assert cuda_ops.bilateral_instance(k) == f"radius {k // 2}"
    for k in (14, 15, 17, 81):
        assert cuda_ops.bilateral_instance(k) == "run-time radius"
