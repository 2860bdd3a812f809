"""Port parity: the bilateral's and the one-level gated subsample's plain
versions (the two-level pyramid and the image maps are in
tests/test_torch_image_pyramid.py) against the JAX package's image_ops (the XLA twins that
tests/test_pallas_ops.py holds bit-identical to the Pallas kernels) and,
at a Pallas-compatible shape, against the Pallas kernels in interpret mode.

Tolerances: the bilateral filter is equal or +-1 mm on at most 0.1% of
pixels (exp of two math libraries can straddle a rounding tie); the gated
subsample is bit-exact (integer sums below 2^24 are exact in
float32)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from torch_parity import rand_depth, to_t

from octree_slam_tpu.sensor import image_ops as jimg, pallas_ops
from octree_slam_tpu_torch.sensor import cuda_ops, image_ops

SHAPES = [(48, 64), (60, 80), (9, 11)]


def _step_depth():
    """A sharp depth step plus a zero row at the border."""
    d = np.full((48, 64), 1000, np.uint16)
    d[:, 32:] = 3000
    d[0, :] = 0
    d[:, -1] = 5000
    return d


def _assert_bilateral_close(out, ref):
    diff = np.abs(out.astype(np.int64) - ref.astype(np.int64))
    n_off = int((diff > 0).sum())
    assert diff.max(initial=0) <= 1 and n_off <= 0.001 * diff.size, \
        f"{n_off} of {diff.size} pixels differ (max {diff.max()})"


class TestBilateralPlain:
    @pytest.mark.parametrize("shape", SHAPES)
    def test_matches_jax(self, shape):
        d = rand_depth(*shape, seed=shape[0])
        ref = np.asarray(jimg.bilateral_filter(jnp.asarray(d)))
        out = image_ops.bilateral_filter(to_t(d)).numpy()
        _assert_bilateral_close(out, ref)

    def test_depth_step_at_border(self):
        d = _step_depth()
        ref = np.asarray(jimg.bilateral_filter(jnp.asarray(d)))
        _assert_bilateral_close(image_ops.bilateral_filter(to_t(d)).numpy(),
                                ref)

    def test_matches_pallas_interpret(self):
        d = rand_depth(16, 128, seed=1)
        ref = np.asarray(pallas_ops.bilateral(jnp.asarray(d), 4.5, 40.0,
                                              interpret=True))
        _assert_bilateral_close(
            cuda_ops.bilateral_plain(to_t(d), 4.5, 40.0).numpy(), ref)

    def test_batch_equals_per_image(self):
        d = to_t(rand_depth(20, 24, seed=4, batch=3))
        out = cuda_ops.bilateral(d, 4.5, 40.0)
        for i in range(3):
            assert torch.equal(out[i], cuda_ops.bilateral(d[i], 4.5, 40.0))

    def test_cpu_tensor_runs_plain_version(self):
        cuda_ops.reset_launches()
        d = to_t(rand_depth(9, 11, seed=0))
        cuda_ops.bilateral(d, 4.5, 40.0)
        cuda_ops.bilateral(d, 4.5, 40.0, kernel_size=5)
        cuda_ops.gated_subsample(d, 120.0)
        cuda_ops.gated_pyramid(d, 120.0, 2)
        assert cuda_ops.LAUNCHES == {"bilateral7x7": 0, "bilateral_window": 0,
                                     "gated_pyramid5x5": 0}


class TestGatedSubsamplePlain:
    @pytest.mark.parametrize("shape", SHAPES)
    def test_bit_exact(self, shape):
        d = rand_depth(*shape, seed=shape[1])
        ref = np.asarray(jimg.subsample_depth(jnp.asarray(d), 40.0))
        out = image_ops.subsample_depth(to_t(d), 40.0).numpy()
        assert out.shape == ref.shape
        np.testing.assert_array_equal(out, ref)

    def test_depth_step_at_border(self):
        d = _step_depth()
        ref = np.asarray(jimg.subsample_depth(jnp.asarray(d), 40.0))
        np.testing.assert_array_equal(
            image_ops.subsample_depth(to_t(d), 40.0).numpy(), ref)

    def test_matches_pallas_interpret(self):
        d = rand_depth(16, 128, seed=3)
        full = np.asarray(pallas_ops.gated_window_mean(jnp.asarray(d), 120.0,
                                                       interpret=True))
        np.testing.assert_array_equal(
            cuda_ops.gated_subsample_plain(to_t(d), 120.0).numpy(),
            full[::2, ::2].astype(np.uint16))

    def test_batch_equals_per_image(self):
        d = to_t(rand_depth(21, 26, seed=5, batch=2))
        out = cuda_ops.gated_subsample(d, 120.0)
        assert out.shape == (2, 10, 13)
        for i in range(2):
            assert torch.equal(out[i], cuda_ops.gated_subsample(d[i], 120.0))


