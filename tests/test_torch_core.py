"""Port parity: Morton keys, RGBA8 words, compaction and SE(3) against the
JAX package on the same numpy inputs.

Tolerances: keys, words and compaction are bit-exact; SE(3) agrees within
1e-6 (float32 sin/cos/sqrt of two libraries)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from torch_parity import to_t, words

from octree_slam_tpu.core import packing as jpacking, se3 as jse3
from octree_slam_tpu.map import morton as jmorton
from octree_slam_tpu.utils import compaction as jcompaction
from octree_slam_tpu_torch.core import packing, se3
from octree_slam_tpu_torch.map import morton
from octree_slam_tpu_torch.utils import compaction


def _cloud_with_edge_cases(seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.5, 1.5, (3000, 3)).astype(np.float32)
    pts[::97, 1] = np.inf          # non-finite
    pts[::89, 0] = np.nan
    pts[::53] *= 40.0              # far outside the volume
    pts[::61] = 0.0                # exactly on every split plane
    return pts


class TestMorton:
    @pytest.mark.parametrize("depth", [1, 6, 10])
    def test_encode_bit_exact(self, depth):
        pts = _cloud_with_edge_cases(depth)
        center = np.array([0.1, -0.2, 0.05], np.float32)
        jk, jv = jmorton.encode(jnp.asarray(pts), jnp.asarray(center), 0.8,
                                depth)
        tk, tv = morton.encode(torch.from_numpy(pts),
                               torch.from_numpy(center), 0.8, depth)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        assert (tk.numpy() == morton.INVALID_KEY).sum() == (~tv.numpy()).sum()

    def test_decode_and_digits_bit_exact(self):
        depth = 7
        rng = np.random.default_rng(3)
        keys = rng.integers(0, 1 << (3 * depth), 4000).astype(np.int32)
        center = np.array([0.5, 0.0, -1.0], np.float32)
        jc = jmorton.decode_centers(jnp.asarray(keys), jnp.asarray(center),
                                    2.56, depth)
        tc = morton.decode_centers(torch.from_numpy(keys),
                                   torch.from_numpy(center), 2.56, depth)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        for level in range(1, depth + 1):
            np.testing.assert_array_equal(
                morton.level_prefix(torch.from_numpy(keys), depth, level),
                np.asarray(jmorton.level_prefix(jnp.asarray(keys), depth,
                                                level)))
            np.testing.assert_array_equal(
                morton.octant_at(torch.from_numpy(keys), depth, level),
                np.asarray(jmorton.octant_at(jnp.asarray(keys), depth,
                                             level)))


class TestPacking:
    def test_pack_unpack_words(self):
        rng = np.random.default_rng(0)
        ch = rng.integers(-20, 280, (4, 5000)).astype(np.int32)
        jw = jpacking.pack_rgba8(*(jnp.asarray(c) for c in ch))
        tw = packing.pack_rgba8(*(torch.from_numpy(c) for c in ch))
        np.testing.assert_array_equal(words(tw), np.asarray(jw))
        for a, b in zip(packing.unpack_rgba8(tw), jpacking.unpack_rgba8(jw)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(packing.alpha_of(tw).numpy(),
                                      np.asarray(jpacking.alpha_of(jw)))
        np.testing.assert_array_equal(packing.is_occupied(tw).numpy(),
                                      np.asarray(jpacking.is_occupied(jw)))
        assert words(torch.tensor(packing.EMPTY_VALUE)) == \
            np.uint32(jpacking.EMPTY_VALUE)

    def test_blend_value_bit_exact(self):
        # the reference function called op by op (no XLA fusion) rounds
        # every op as written, exactly like the port
        rng = np.random.default_rng(1)
        n = 20000
        old = (rng.integers(0, 1 << 24, n)
               | (rng.integers(0, 256, n) << 24)).astype(np.uint32)
        old[:50] = jpacking.EMPTY_VALUE
        new = rng.uniform(0, 1, (n, 3)).astype(np.float32)
        jb = jpacking.blend_value(jnp.asarray(old), jnp.asarray(new))
        tb = packing.blend_value(to_t(old), torch.from_numpy(new))
        np.testing.assert_array_equal(words(tb), np.asarray(jb))


class TestCompaction:
    @pytest.mark.parametrize("capacity", [16, 700, 5000])
    def test_compact_bit_exact(self, capacity):
        rng = np.random.default_rng(capacity)
        mask = rng.random(2000) < 0.3
        vals = rng.integers(-1000, 1000, (2000, 2)).astype(np.int32)
        jr, jc = jcompaction.exclusive_ranks(jnp.asarray(mask))
        tr, tc = compaction.exclusive_ranks(torch.from_numpy(mask))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        assert int(tc) == int(jc)
        jo, jn = jcompaction.compact(jnp.asarray(vals), jnp.asarray(mask),
                                     capacity, fill=-7)
        to, tn = compaction.compact(torch.from_numpy(vals),
                                    torch.from_numpy(mask), capacity, fill=-7)
        np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
        assert int(tn) == int(jn)
        (ja, jb), _ = jcompaction.compact_multi(
            [jnp.asarray(vals[:, 0]), jnp.asarray(vals[:, 1])],
            jnp.asarray(mask), capacity)
        (ta, tb), _ = compaction.compact_multi(
            [torch.from_numpy(vals[:, 0]), torch.from_numpy(vals[:, 1])],
            torch.from_numpy(mask), capacity)
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))

    def test_first_occurrence_and_scatter_drop(self):
        rng = np.random.default_rng(2)
        keys = np.sort(rng.integers(0, 300, 1000)).astype(np.int32)
        valid = rng.random(1000) < 0.9
        np.testing.assert_array_equal(
            compaction.first_occurrence(torch.from_numpy(keys),
                                        torch.from_numpy(valid)).numpy(),
            np.asarray(jcompaction.first_occurrence(jnp.asarray(keys),
                                                    jnp.asarray(valid))))
        out = torch.zeros(10, dtype=torch.int32)
        idx = torch.tensor([3, 10, 0, 99, -1, 9], dtype=torch.int32)
        compaction.scatter_set_(out, idx, torch.arange(1, 7))
        ref = jnp.zeros(10, jnp.int32).at[jnp.asarray([3, 10, 0, 99, 9])
                                          ].set(jnp.asarray([1, 2, 3, 4, 6]),
                                                mode="drop")
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


class TestSE3:
    @pytest.mark.parametrize("scale", [1e-8, 1e-3, 0.5, 3.0])
    def test_exp_se3_small_and_large_angles(self, scale):
        rng = np.random.default_rng(int(scale * 1e3) + 1)
        tw = (rng.normal(size=(64, 6)) * scale).astype(np.float32)
        tw[0] = 0.0
        jT = np.asarray(jse3.exp_se3(jnp.asarray(tw)))
        tT = se3.exp_se3(torch.from_numpy(tw)).numpy()
        np.testing.assert_allclose(tT, jT, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            se3.exp_so3(torch.from_numpy(tw[:, :3])).numpy(),
            np.asarray(jse3.exp_so3(jnp.asarray(tw[:, :3]))),
            rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            se3.inverse(to_t(jT)).numpy(),
            np.asarray(jse3.inverse(jnp.asarray(jT))), rtol=1e-6, atol=1e-6)

    def test_hat_and_make_transform(self):
        rng = np.random.default_rng(9)
        w = rng.normal(size=(5, 3)).astype(np.float32)
        np.testing.assert_array_equal(se3.hat(torch.from_numpy(w)).numpy(),
                                      np.asarray(jse3.hat(jnp.asarray(w))))
        R = rng.normal(size=(3, 3)).astype(np.float32)
        t = rng.normal(size=(3,)).astype(np.float32)
        np.testing.assert_array_equal(
            se3.make_transform(torch.from_numpy(R), torch.from_numpy(t)),
            np.asarray(jse3.make_transform(jnp.asarray(R), jnp.asarray(t))))
