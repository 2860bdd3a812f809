"""Multiply-adds rounded once, as the reference evaluates them.

XLA:CPU contracts every `a * b + c` of the reference package into one
fused multiply-add (one rounding), its 3-term sums and small matrix
products into forward chains of them (`x0*y0`, then `+ x1*y1`, then
`+ x2*y2`, each fused), and `a*b - c*d` into fma(a, b, -(c*d)). Where such
a value decides an integer (a voxel's texel, a pixel's quantised depth, a
fragment's inside test), the port evaluates it the same way, so that its
voxel grids and z-buffers equal the reference's word for word on the CPU.

The product of two float32 values is exact in float64; the float64 sum is
then rounded to float32. That is the fused result except where the
float64 sum lies exactly on a float32 rounding midpoint after its own
rounding (double rounding, about one case in 2^29). float64 arithmetic is
IEEE on the CPU and on the card alike, so both give the same words.
"""

from __future__ import annotations

import numpy as np
import torch


def fma32(a, b, c) -> torch.Tensor:
    """float32 a * b + c with one rounding."""
    return (_d(a) * _d(b) + _d(c)).to(torch.float32)


def fms32(a, b, c, d) -> torch.Tensor:
    """float32 a * b - c * d as XLA contracts it: fma(a, b, -(c * d))."""
    return fma32(a, b, -(_f(c) * _f(d)))


def dot3(x, y) -> torch.Tensor:
    """x0*y0 + x1*y1 + x2*y2 over the last axis (size 3) as a forward
    chain of fused multiply-adds (jnp.sum(x * y, -1) and `w @ m` for a
    3-row m on XLA:CPU)."""
    acc = _f(x[..., 0]) * _f(y[..., 0])
    acc = fma32(x[..., 1], y[..., 1], acc)
    return fma32(x[..., 2], y[..., 2], acc)


def chain(ws, rows) -> torch.Tensor:
    """sum_k ws[k] * rows[k] as a forward chain of fused multiply-adds
    (`w @ m` on XLA:CPU, w the weights [..., K] split into K tensors)."""
    acc = _f(ws[0]) * _f(rows[0])
    for w, r in zip(ws[1:], rows[1:]):
        acc = fma32(w, r, acc)
    return acc


def _d(x):
    # a Python constant is a float32 one in the reference
    return (x.to(torch.float64) if isinstance(x, torch.Tensor)
            else float(np.float32(x)))


def _f(x):
    return x.to(torch.float32) if isinstance(x, torch.Tensor) else x
