"""The hand-written CUDA stencils against their plain PyTorch versions on
the card. Marked `cuda`: without a CUDA device every test skips. The
repository's conftest imports jax, which the card's machine lacks, so run
these there with

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -q

Tolerances: both kernels are bit-exact against the plain versions on the
same device (same tap order, IEEE division, no FMA contraction)."""

import pytest
import torch

from torch_parity import rand_depth

from octree_slam_tpu_torch.sensor import cuda_ops

pytestmark = pytest.mark.cuda

SHAPES = [(480, 640), (479, 641), (4, 240, 320), (9, 11), (1, 1)]


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


@pytest.mark.parametrize("shape", SHAPES)
def test_bilateral_kernel_matches_plain(device, shape):
    d = _depth(shape, 1, device)
    before = cuda_ops.LAUNCHES["bilateral7x7"]
    out = cuda_ops.bilateral(d, 4.5, 40.0)
    assert cuda_ops.LAUNCHES["bilateral7x7"] == before + 1
    ref = cuda_ops.bilateral_plain(d, 4.5, 40.0)
    torch.cuda.synchronize()
    assert out.shape == d.shape and out.dtype == torch.int32
    assert torch.equal(out, ref)


@pytest.mark.parametrize("shape", SHAPES)
def test_gated_subsample_kernel_matches_plain(device, shape):
    d = _depth(shape, 2, device)
    before = cuda_ops.LAUNCHES["gated_subsample5x5"]
    out = cuda_ops.gated_subsample(d, 120.0)
    assert cuda_ops.LAUNCHES["gated_subsample5x5"] == before + 1
    ref = cuda_ops.gated_subsample_plain(d, 120.0)
    torch.cuda.synchronize()
    assert out.shape == ref.shape
    assert torch.equal(out, ref)


def test_wrappers_reject_what_the_kernels_do_not_take(device):
    d = _depth((32, 48), 3, device)
    with pytest.raises(TypeError):
        cuda_ops.bilateral(d.to(torch.int16), 4.5, 40.0)
    with pytest.raises(ValueError):
        cuda_ops.gated_subsample(d.t(), 120.0)
    with pytest.raises(ValueError):
        cuda_ops.bilateral(d[None, None], 4.5, 40.0)
