"""The hand-written two-level gated pyramid kernel against its plain
PyTorch version on the card (the single-level subsample and the bilateral
are in tests/test_torch_cuda_kernels.py). Marked `cuda`: without a CUDA
device every test skips. The repository's conftest imports jax, which the
card's machine lacks, so run these there with

    python -m pytest tests/test_torch_cuda_pyramid.py --noconftest -q

Tolerance: bit-exact against the plain version on the same device (same
tap order, IEEE division, no FMA contraction)."""

import pytest
import torch

from torch_parity import rand_depth

from octree_slam_tpu_torch.sensor import cuda_ops


pytestmark = pytest.mark.cuda


# (483, 645) has an odd L1 (241 x 322 -> 120 x 161)
PYRAMID_SHAPES = [(480, 640), (479, 641), (483, 645), (4, 240, 320), (9, 11),
                  (5, 5), (1, 1)]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _depth(shape, seed, device):
    batch, (h, w) = (shape[0], shape[1:]) if len(shape) == 3 else (None,
                                                                     shape)
    return torch.from_numpy(rand_depth(h, w, seed, batch).astype("int32")).to(
        device)


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("shape", PYRAMID_SHAPES)
def test_gated_pyramid_kernel_matches_plain(device, shape, levels):
    d = _depth(shape, 3, device)
    before = cuda_ops.LAUNCHES["gated_pyramid5x5"]
    out = cuda_ops.gated_pyramid(d, 120.0, levels)
    assert cuda_ops.LAUNCHES["gated_pyramid5x5"] == before + 1
    ref = cuda_ops.gated_pyramid_plain(d, 120.0, levels)
    torch.cuda.synchronize()
    assert len(out) == len(ref) == levels
    for o, r in zip(out, ref):
        assert o.shape == r.shape and o.dtype == torch.int32
        assert torch.equal(o, r)
