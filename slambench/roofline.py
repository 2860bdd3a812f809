"""The card's peaks and the work of the sensor stencils, for their roofline
share: a copy of chip_smoke.py's sound arithmetic (`_window_taps`,
`bilateral_work`, `gated_pyramid_work`, `bound`), kept here so that a
change to the program cannot move it.

Peaks: NVIDIA H100 SXM (80 GB HBM3), NVIDIA's data sheet at the full
700 W: 3.35 TB/s of HBM bandwidth and 67 TFLOP/s of float32 outside the
tensor cores. A card set to a lower power limit runs below them; the
traced run records the limit beside the share.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12


def window_taps(n: int, half: int, step: int) -> int:
    """In-image taps along one axis of a (2 half + 1)-wide window centred
    on every `step`-th pixel of an n-pixel axis (whose output has n // step
    pixels when step > 1)."""
    centres = range(0, step * (n // step), step) if step > 1 else range(n)
    return sum(1 for c in centres for d in range(-half, half + 1)
               if 0 <= c + d < n)


def bilateral_work(shape, kernel_size: int = 7):
    """(bytes, float32 operations) of one bilateral call: the input read
    and the output written once; per in-image tap a subtract, two
    multiplies, an add, the exp, a multiply and two adds (8), and a divide
    and a round per pixel."""
    b, h, w = (1, *shape) if len(shape) == 2 else shape
    half = kernel_size // 2
    taps = b * window_taps(h, half, 1) * window_taps(w, half, 1)
    return 8 * b * h * w, 8 * taps + 2 * b * h * w


def gated_pyramid_work(shape, levels: int):
    """(bytes, float32 operations) of one gated_pyramid5x5 call: the input
    read and every level written once; per in-image tap of a kept pixel a
    subtract, an abs, a compare and the two adds of a passing tap (every
    tap counted as passing), and a divide per output."""
    b, h, w = (1, *shape) if len(shape) == 2 else shape
    nbytes, ops = 4 * b * h * w, 0
    for _ in range(levels):
        taps = b * window_taps(h, 2, 2) * window_taps(w, 2, 2)
        h, w = h // 2, w // 2
        nbytes += 4 * b * h * w
        ops += 5 * taps + b * h * w
    return nbytes, ops


def bound_s(nbytes: int, ops: int) -> float:
    """The least time the card could take for this work, in seconds."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_PER_S)
