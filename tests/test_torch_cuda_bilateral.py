"""The bilateral of any window size on the card: bilateral_window against
its plain PyTorch version, and the dispatch of cuda_ops.bilateral by window
radius. Marked `cuda`: without a CUDA device every test skips. Run on the
card's machine with

    python -m pytest tests/test_torch_cuda_bilateral.py --noconftest -q

Every compiled instance (radii 1, 2, 4, 5, 6: sizes 2-5 and 8-13; radius 3
is bilateral7x7) and the run-time-radius kernel (sizes 15 and 17) runs on
shapes whose block edges fall on the image edge in each way: the frame, a
ragged one (W % 4 != 0 sends the staging down its scalar path), a row slab
of the 2 x 4 mesh, one smaller than the window, a single pixel and the
recovery batch. The depth is a noisy surface (torch_parity.surface_depth),
so every tap of the window carries weight.

Tolerance: bit-exact against the plain version on the same device (the
same tap order, expf, IEEE division, rintf and no FMA contraction)."""

import pytest
import torch

from torch_parity import surface_depth

from octree_slam_tpu_torch.sensor import cuda_ops, image_ops

pytestmark = pytest.mark.cuda

# the main path's frame, a ragged edge, a row slab with its halo, a frame
# smaller than the window, a single pixel and the recovery batch
SHAPES = [(480, 640), (479, 641), (72, 640), (9, 11), (1, 1), (4, 480, 640)]
# every compiled radius but 3 (sizes 2-5, 8-13), and the run-time kernel
WINDOW_SIZES = [2, 3, 4, 5, 8, 9, 10, 11, 12, 13, 15, 17]


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _depth(shape, seed, device):
    batch, (h, w) = (shape[0], shape[1:]) if len(shape) == 3 else (None,
                                                                     shape)
    return torch.from_numpy(
        surface_depth(h, w, seed, batch).astype("int32")).to(device)


@pytest.mark.parametrize("kernel_size", WINDOW_SIZES)
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


def test_bilateral_window_filters(device):
    """The surface makes the filter move most pixels: a kernel that kept
    the centre would not pass for the plain version."""
    d = _depth((480, 640), 0, device)
    for k in (3, 13, 15):
        moved = (cuda_ops.bilateral(d, 4.5, 40.0, k) != d).float().mean()
        assert float(moved) > 0.5, (k, float(moved))


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
    assert [cuda_ops.bilateral_instance(k) for k in (1, 5, 7, 13, 15)] == [
        "none: a copy", "radius 2", "radius 3", "radius 6",
        "run-time radius"]
