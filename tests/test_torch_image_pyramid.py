"""Port parity: the two-level gated pyramid's plain version and the image
maps (vertex, normal, intensity, transforms) against the JAX package's
image_ops and, at a Pallas-compatible shape, against the Pallas kernel in
interpret mode (the bilateral and the one-level subsample are in
tests/test_torch_image_ops.py).

Tolerances: the two-level gated pyramid is bit-exact (integer sums below
2^24 are exact in float32); vertex and normal maps agree within 1e-6 with
identical INF masks."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from torch_parity import rand_depth, to_t

from octree_slam_tpu.sensor import image_ops as jimg, pallas_ops
from octree_slam_tpu_torch.sensor import cuda_ops, image_ops


# (H, W) with odd H/2 or W/2, and a batch of 2
PYRAMID_SHAPES = [(64, 48), (65, 49), (67, 51), (2, 64, 48)]


def _pyramid_depth(shape, seed):
    batch = shape[0] if len(shape) == 3 else None
    return rand_depth(*shape[-2:], seed=seed, batch=batch)


def _images(d):
    return list(d) if d.ndim == 3 else [d]


class TestGatedPyramidPlain:
    @pytest.mark.parametrize("shape", PYRAMID_SHAPES)
    def test_matches_two_jax_subsamples(self, shape):
        d = _pyramid_depth(shape, seed=sum(shape))
        out = cuda_ops.gated_pyramid(to_t(d), 120.0, 2)
        assert len(out) == 2
        for i, ref in enumerate(_images(d)):
            for level in range(2):
                ref = np.asarray(jimg.subsample_depth(jnp.asarray(ref), 40.0))
                got = _images(out[level].numpy())[i]
                assert got.shape == ref.shape
                np.testing.assert_array_equal(got, ref)

    @pytest.mark.parametrize("shape", PYRAMID_SHAPES)
    def test_matches_pallas_interpret(self, shape):
        d = _pyramid_depth(shape, seed=7 + sum(shape))
        out = cuda_ops.gated_pyramid_plain(to_t(d), 120.0, 2)
        for i, ref in enumerate(_images(d)):
            for level in range(2):
                h, w = ref.shape
                full = np.asarray(pallas_ops.gated_window_mean(
                    jnp.asarray(ref), 120.0, interpret=True))
                ref = full[::2, ::2][:h // 2, :w // 2].astype(np.uint16)
                np.testing.assert_array_equal(
                    _images(out[level].numpy())[i], ref)

    def test_levels_chain_two_at_a_time(self):
        d = rand_depth(67, 51, seed=9)
        out = image_ops.subsample_depth_levels(to_t(d), 3, 40.0)
        ref = d
        for level in range(3):
            ref = np.asarray(jimg.subsample_depth(jnp.asarray(ref), 40.0))
            np.testing.assert_array_equal(out[level].numpy(), ref)
        assert image_ops.subsample_depth_levels(to_t(d), 0) == []

    def test_one_level_is_the_subsample(self):
        d = to_t(rand_depth(21, 26, seed=6))
        (one,) = cuda_ops.gated_pyramid(d, 120.0, 1)
        assert torch.equal(one, cuda_ops.gated_subsample(d, 120.0))
        with pytest.raises(ValueError):
            cuda_ops.gated_pyramid(d, 120.0, 3)


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
