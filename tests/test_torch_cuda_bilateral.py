"""The bilateral of any window size on the card: bilateral_window against
its plain PyTorch version, and the dispatch of cuda_ops.bilateral by window
radius. Marked `cuda`: without a CUDA device every test skips. Run on the
card's machine with

    python -m pytest tests/test_torch_cuda_bilateral.py --noconftest -q

Tolerance: bit-exact against the plain version on the same device (the
same tap order, expf, IEEE division, rintf and no FMA contraction)."""

import pytest
import torch

from torch_parity import rand_depth

from octree_slam_tpu_torch.sensor import cuda_ops, image_ops

pytestmark = pytest.mark.cuda

# the main path's frame and the recovery batch, a ragged edge, a frame
# smaller than the window and a single pixel
SHAPES = [(480, 640), (4, 480, 640), (479, 641), (9, 11), (1, 1)]


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


@pytest.mark.parametrize("kernel_size", [3, 5, 9, 11])
@pytest.mark.parametrize("shape", SHAPES)
def test_bilateral_window_matches_plain(device, shape, kernel_size):
    d = _depth(shape, kernel_size, device)
    before = dict(cuda_ops.LAUNCHES)
    out = cuda_ops.bilateral(d, 4.5, 40.0, kernel_size)
    assert cuda_ops.LAUNCHES["bilateral_window"] == \
        before["bilateral_window"] + 1
    assert cuda_ops.LAUNCHES["bilateral7x7"] == before["bilateral7x7"]
    ref = cuda_ops.bilateral_plain(d, 4.5, 40.0, kernel_size)
    torch.cuda.synchronize()
    assert out.shape == d.shape and out.dtype == torch.int32
    assert torch.equal(out, ref)


def test_dispatch_by_radius(device):
    """Sizes 6 and 7 are the 7x7 kernel, 1 a copy with no launch, a radius
    whose tile passes 48 KB of shared memory still launches."""
    d = _depth((480, 640), 0, device)
    cuda_ops.reset_launches()
    six = image_ops.bilateral_filter(d, kernel_size=6)
    seven = image_ops.bilateral_filter(d, kernel_size=7)
    assert cuda_ops.LAUNCHES == {"bilateral7x7": 2, "bilateral_window": 0,
                                 "gated_pyramid5x5": 0}
    assert torch.equal(six, seven)
    one = image_ops.bilateral_filter(d, kernel_size=1)
    assert torch.equal(one, d) and one.data_ptr() != d.data_ptr()
    assert cuda_ops.LAUNCHES["bilateral_window"] == 0
    wide = cuda_ops.bilateral(d[:64, :96].contiguous(), 4.5, 40.0, 81)
    torch.cuda.synchronize()
    assert cuda_ops.LAUNCHES["bilateral_window"] == 1
    assert torch.equal(wide, cuda_ops.bilateral_plain(
        d[:64, :96].contiguous(), 4.5, 40.0, 81))
