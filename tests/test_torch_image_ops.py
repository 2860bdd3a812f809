"""Port parity: the sensor stencils' plain versions and the image maps
against the JAX package's image_ops (the XLA twins that
tests/test_pallas_ops.py holds bit-identical to the Pallas kernels) and,
at a Pallas-compatible shape, against the Pallas kernels in interpret mode.

Tolerances: the bilateral filter is equal or +-1 mm on at most 0.1% of
pixels (exp of two math libraries can straddle a rounding tie); the gated
subsample is bit-exact (integer sums below 2^24 are exact in float32);
vertex and normal maps agree within 1e-6 with identical INF masks."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

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
        cuda_ops.gated_subsample(d, 120.0)
        assert cuda_ops.LAUNCHES == {"bilateral7x7": 0,
                                     "gated_subsample5x5": 0}

    def test_only_7x7_is_ported(self):
        with pytest.raises(NotImplementedError):
            image_ops.bilateral_filter(to_t(rand_depth(9, 11, seed=0)),
                                       kernel_size=5)


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


class TestMaps:
    @pytest.mark.parametrize("shape", [(48, 64), (24, 32)])
    def test_vertex_and_normal_maps(self, shape):
        d = rand_depth(*shape, seed=7)
        d[5, 5] = 16000                      # beyond the 15 m cut
        jv = np.asarray(jimg.generate_vertex_map(jnp.asarray(d), 55.0, 55.0,
                                                 (64, 48)))
        tv = image_ops.generate_vertex_map(to_t(d), 55.0, 55.0, (64, 48))
        np.testing.assert_array_equal(np.isinf(tv.numpy()), np.isinf(jv))
        np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-6, atol=1e-6)
        jn = np.asarray(jimg.generate_normal_map(jnp.asarray(jv)))
        tn = image_ops.generate_normal_map(to_t(jv)).numpy()
        np.testing.assert_array_equal(np.isinf(tn), np.isinf(jn))
        np.testing.assert_allclose(tn, jn, rtol=1e-6, atol=1e-6)

    def test_intensity_subsample_transforms(self):
        rng = np.random.default_rng(8)
        color = rng.integers(0, 256, (9, 11, 3)).astype(np.uint8)
        np.testing.assert_allclose(
            image_ops.color_to_intensity(to_t(color)).numpy(),
            np.asarray(jimg.color_to_intensity(jnp.asarray(color))),
            rtol=1e-6, atol=1e-7)
        img = rng.normal(size=(9, 11)).astype(np.float32)
        np.testing.assert_array_equal(
            image_ops.subsample(to_t(img)).numpy(),
            np.asarray(jimg.subsample(jnp.asarray(img))))
        v = rng.normal(size=(6, 7, 3)).astype(np.float32)
        v[2, 3] = np.inf
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        T[:3, 3] = [0.3, -0.1, 2.0]
        for jf, tf in ((jimg.transform_vertex_map,
                        image_ops.transform_vertex_map),
                       (jimg.transform_normal_map,
                        image_ops.transform_normal_map)):
            ref = np.asarray(jf(jnp.asarray(v), jnp.asarray(T)))
            out = tf(to_t(v), to_t(T)).numpy()
            np.testing.assert_array_equal(np.isfinite(out),
                                          np.isfinite(ref))
            np.testing.assert_allclose(out[np.isfinite(out)],
                                       ref[np.isfinite(ref)],
                                       rtol=1e-6, atol=1e-6)
