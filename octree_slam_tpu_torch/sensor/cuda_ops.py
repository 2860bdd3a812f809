"""The sensor stencils as hand-written CUDA kernels, with their plain
PyTorch versions (counterpart: octree_slam_tpu/sensor/pallas_ops.py).

  bilateral          bilateral filter (bilateralKernel,
                     image_kernels.cu:142-177) -> csrc kernel bilateral7x7
                     for the 7x7 window, bilateral_window for any other
                     (the reference's XLA path, image_ops.py:88-117): an
                     instance compiled for each radius up to
                     MAX_COMPILED_HALF, a run-time-radius kernel above
  gated_pyramid      5x5 depth-gated mean at the kept (2y, 2x) pixels
                     (subsampleDepthKernel, image_kernels.cu:237-269),
                     one or two pyramid levels per launch
                     -> csrc kernel gated_pyramid5x5
  gated_subsample    gated_pyramid with one level

Dispatch is by the tensor's device: a CPU tensor runs the plain version, a
CUDA tensor launches the kernel (building it on first use) or raises;
nothing falls back from one to the other. `LAUNCHES` counts kernel
launches, so a run can show that its path went through the kernels, and
`LAUNCH_BATCHES` counts them by the batch each launch took.

The TPU kernel's VMEM striping and full-resolution-then-decimate form are
not carried over: the subsample computes only the pixels it keeps.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from octree_slam_tpu_torch import _build

# kernel name -> launches since the last reset_launches()
LAUNCHES = {"bilateral7x7": 0, "bilateral_window": 0,
            "gated_pyramid5x5": 0}
# kernel name -> {batch size: launches} since the last reset_launches()
LAUNCH_BATCHES = {k: {} for k in LAUNCHES}
# pyramid levels one gated_pyramid5x5 launch makes
MAX_PYRAMID_LEVELS = 2
# the largest radius csrc compiles an instance of the bilateral for
# (kMaxHalf in sensor_stencils.cu); bilateral_window takes any larger one
# with the radius known at run time
MAX_COMPILED_HALF = 6


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LAUNCH_BATCHES[k].clear()


def bilateral_instance(kernel_size: int) -> str:
    """The kernel a CUDA bilateral of this window size runs: the compiled
    instance of its radius, the run-time-radius kernel, or none (a
    radius of 0 is a copy)."""
    half = kernel_size // 2
    if half == 0:
        return "none: a copy"
    if half <= MAX_COMPILED_HALF:
        return f"radius {half}"
    return "run-time radius"


def bilateral_plain(depth: torch.Tensor, sigma_spatial: float,
                    sigma_depth: float, kernel_size: int = 7
                    ) -> torch.Tensor:
    """Bilateral filter of integer depth [..., H, W] over the window of
    radius half = kernel_size // 2 (the reference's: an even size is the
    next odd one) in plain PyTorch: w = exp(-((dx^2+dy^2)*0.5/ss^2 +
    (c-nb)^2*0.5/sd^2)), taps in the order dy outer, dx inner; taps outside
    the image weigh 0 (zero depth inside the image is NOT masked); output
    round_half_even(sum(w*nb) / sum(w)) in the input dtype."""
    half = kernel_size // 2
    h, w = depth.shape[-2:]
    sig_s = 0.5 / (sigma_spatial * sigma_spatial)
    sig_d = 0.5 / (sigma_depth * sigma_depth)
    d = depth.to(torch.float32)
    pad = F.pad(d, (half, half, half, half))
    inb = F.pad(torch.ones_like(d), (half, half, half, half))
    s1 = torch.zeros_like(d)
    s2 = torch.zeros_like(d)
    for dy in range(-half, half + 1):
        for dx in range(-half, half + 1):
            nb = pad[..., half + dy:half + dy + h, half + dx:half + dx + w]
            m = inb[..., half + dy:half + dy + h, half + dx:half + dx + w]
            space2 = float(dx * dx + dy * dy)
            diff = d - nb
            wgt = m * torch.exp(-(space2 * sig_s + diff * diff * sig_d))
            s1 = s1 + nb * wgt
            s2 = s2 + wgt
    return torch.round(s1 / s2).to(depth.dtype)


def gated_subsample_plain(depth: torch.Tensor, gate: float) -> torch.Tensor:
    """Depth-gated 2x subsample of integer depth [..., H, W] in plain
    PyTorch: at each kept pixel (2y, 2x), the mean of the in-image 5x5
    neighbours within `gate` mm of it (0 when none pass), truncated to the
    input dtype. Returns [..., H//2, W//2]."""
    h, w = depth.shape[-2:]
    oh, ow = h // 2, w // 2
    d = depth.to(torch.float32)
    pad = F.pad(d, (2, 2, 2, 2))
    inb = F.pad(torch.ones_like(d), (2, 2, 2, 2))
    c = d[..., 0:2 * oh:2, 0:2 * ow:2]
    s = torch.zeros_like(c)
    cnt = torch.zeros_like(c)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            rows = slice(2 + dy, 2 + dy + 2 * oh, 2)
            cols = slice(2 + dx, 2 + dx + 2 * ow, 2)
            nb = pad[..., rows, cols]
            ok = inb[..., rows, cols] * (torch.abs(nb - c) < gate).to(
                torch.float32)
            s = s + nb * ok
            cnt = cnt + ok
    out = torch.where(cnt > 0, s / torch.clamp(cnt, min=1.0), 0.0)
    return out.to(depth.dtype)


def gated_pyramid_plain(depth: torch.Tensor, gate: float,
                        levels: int) -> List[torch.Tensor]:
    """`levels` successive gated_subsample_plain calls; returns each."""
    out = []
    for _ in range(levels):
        depth = gated_subsample_plain(depth, gate)
        out.append(depth)
    return out


def _kernel_input(depth: torch.Tensor, kernel: str) -> torch.Tensor:
    """Validate a kernel input; returns it as int32 [B, H, W]."""
    if depth.device.type != "cuda":
        raise ValueError(f"{kernel}: expected a CUDA or CPU tensor, got "
                         f"{depth.device}")
    if depth.dtype != torch.int32:
        raise TypeError(f"{kernel}: expected int32 depth, got {depth.dtype}")
    if depth.ndim not in (2, 3):
        raise ValueError(f"{kernel}: expected [H, W] or [B, H, W], got "
                         f"{tuple(depth.shape)}")
    if not depth.is_contiguous():
        raise ValueError(f"{kernel}: input must be contiguous")
    return depth if depth.ndim == 3 else depth[None]


def _launch(kernel: str, x: torch.Tensor, *args) -> None:
    """Call `kernel`'s launcher with `args` and the current stream of x's
    device, switching devices only when x is not on the current one; raise
    on a CUDA error, else count the launch."""
    fn = _build.launcher(kernel)
    dev = x.device.index
    if dev == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, kernel)
    LAUNCHES[kernel] += 1
    batches = LAUNCH_BATCHES[kernel]
    batches[x.shape[0]] = batches.get(x.shape[0], 0) + 1


def bilateral(depth: torch.Tensor, sigma_spatial: float,
              sigma_depth: float, kernel_size: int = 7) -> torch.Tensor:
    """Bilateral filter of int32 depth [H, W] or [B, H, W] over the window
    of radius kernel_size // 2: bilateral7x7 for radius 3 (sizes 6 and 7),
    bilateral_window for any other radius above 0 (`bilateral_instance`
    names the kernel it runs). Radius 0 (sizes 0 and 1) is one tap of
    weight 1: the output is a copy of the depth."""
    if kernel_size < 0:
        raise ValueError(f"bilateral: kernel_size {kernel_size} < 0")
    if depth.device.type == "cpu":
        return bilateral_plain(depth, sigma_spatial, sigma_depth, kernel_size)
    half = kernel_size // 2
    kernel = "bilateral7x7" if half == 3 else "bilateral_window"
    x = _kernel_input(depth, kernel)
    if half == 0:
        return depth.clone()
    out = torch.empty_like(x)
    b, h, w = x.shape
    sig_s = 0.5 / (sigma_spatial * sigma_spatial)
    sig_d = 0.5 / (sigma_depth * sigma_depth)
    if half == 3:
        _launch(kernel, x, x.data_ptr(), out.data_ptr(), b, h, w, sig_s,
                sig_d)
    else:
        _launch(kernel, x, x.data_ptr(), out.data_ptr(), b, h, w, half,
                sig_s, sig_d)
    return out if depth.ndim == 3 else out[0]


def gated_pyramid(depth: torch.Tensor, gate: float,
                  levels: int) -> List[torch.Tensor]:
    """`levels` (1 or 2) successive depth-gated 2x subsamples of int32
    depth [H, W] or [B, H, W] in one launch; returns them in order, each
    [..., h//2, w//2] of the one before."""
    # at 1080x1920 one two-level launch is slower than two one-level
    # launches, while at the main path's 480x640 it is faster: see PERF.md,
    # Open questions, before choosing the level count by image size
    if not 1 <= levels <= MAX_PYRAMID_LEVELS:
        raise ValueError(f"gated_pyramid: levels must be in "
                         f"1..{MAX_PYRAMID_LEVELS}, got {levels}")
    if depth.device.type == "cpu":
        return gated_pyramid_plain(depth, gate, levels)
    x = _kernel_input(depth, "gated_pyramid5x5")
    b, h, w = x.shape
    outs, oh, ow = [], h, w
    for _ in range(levels):
        oh, ow = oh // 2, ow // 2
        outs.append(torch.empty((b, oh, ow), dtype=x.dtype, device=x.device))
    _launch("gated_pyramid5x5", x, x.data_ptr(), outs[0].data_ptr(),
            outs[1].data_ptr() if levels == 2 else None, b, h, w, gate,
            levels)
    return outs if depth.ndim == 3 else [o[0] for o in outs]


def gated_subsample(depth: torch.Tensor, gate: float) -> torch.Tensor:
    """Depth-gated 2x subsample of int32 depth [H, W] or [B, H, W];
    returns [..., H//2, W//2]."""
    return gated_pyramid(depth, gate, 1)[0]
