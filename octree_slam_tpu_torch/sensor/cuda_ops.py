"""The sensor stencils as hand-written CUDA kernels, with their plain
PyTorch versions (counterpart: octree_slam_tpu/sensor/pallas_ops.py).

  bilateral          7x7 bilateral filter (bilateralKernel,
                     image_kernels.cu:142-177) -> csrc kernel bilateral7x7
  gated_subsample    5x5 depth-gated mean at the kept (2y, 2x) pixels
                     (subsampleDepthKernel, image_kernels.cu:237-269)
                     -> csrc kernel gated_subsample5x5

Dispatch is by the tensor's device: a CPU tensor runs the plain version, a
CUDA tensor launches the kernel (building it on first use) or raises;
nothing falls back from one to the other. `LAUNCHES` counts kernel
launches, so a run can show that its path went through the kernels.

The TPU kernel's VMEM striping and full-resolution-then-decimate form are
not carried over: the subsample computes only the pixels it keeps.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from octree_slam_tpu_torch import _build

# kernel name -> launches since the last reset_launches()
LAUNCHES = {"bilateral7x7": 0, "gated_subsample5x5": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def bilateral_plain(depth: torch.Tensor, sigma_spatial: float,
                    sigma_depth: float) -> torch.Tensor:
    """7x7 bilateral filter of integer depth [..., H, W] in plain PyTorch:
    w = exp(-((dx^2+dy^2)*0.5/ss^2 + (c-nb)^2*0.5/sd^2)); taps outside the
    image weigh 0 (zero depth inside the image is NOT masked); output
    round_half_even(sum(w*nb) / sum(w)) in the input dtype."""
    half = 3
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


def bilateral(depth: torch.Tensor, sigma_spatial: float,
              sigma_depth: float) -> torch.Tensor:
    """7x7 bilateral filter of int32 depth [H, W] or [B, H, W]."""
    if depth.device.type == "cpu":
        return bilateral_plain(depth, sigma_spatial, sigma_depth)
    x = _kernel_input(depth, "bilateral7x7")
    lib = _build.library()
    out = torch.empty_like(x)
    b, h, w = x.shape
    with torch.cuda.device(x.device):
        err = lib.oslam_bilateral7x7(
            x.data_ptr(), out.data_ptr(), b, h, w,
            0.5 / (sigma_spatial * sigma_spatial),
            0.5 / (sigma_depth * sigma_depth),
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "bilateral7x7")
    LAUNCHES["bilateral7x7"] += 1
    return out if depth.ndim == 3 else out[0]


def gated_subsample(depth: torch.Tensor, gate: float) -> torch.Tensor:
    """Depth-gated 2x subsample of int32 depth [H, W] or [B, H, W];
    returns [..., H//2, W//2]."""
    if depth.device.type == "cpu":
        return gated_subsample_plain(depth, gate)
    x = _kernel_input(depth, "gated_subsample5x5")
    lib = _build.library()
    b, h, w = x.shape
    out = torch.empty((b, h // 2, w // 2), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.oslam_gated_subsample5x5(
            x.data_ptr(), out.data_ptr(), b, h, w, gate,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "gated_subsample5x5")
    LAUNCHES["gated_subsample5x5"] += 1
    return out if depth.ndim == 3 else out[0]
