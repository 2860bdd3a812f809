"""The plain reference that decides `correct`: plain PyTorch, importing
nothing of the program (octree_slam_tpu_torch) and nothing of JAX.

Its modules follow the program's published semantics, op for op where the
program's float32 arithmetic decides a bit (the pyramid, ICP, the world
points, the projections), and by an independent route where the result
is exact (the map: a dense key-indexed table instead of the node pool,
unique keys by torch.unique instead of the insert's sort-and-scan).

`Arith` carries the one switch the control needs: the reference computed
in TF32, the precision below the configurations' float32 with TF32 off
(every matrix product's operands rounded to 10 mantissa bits, products
accumulated in float32, as the tensor cores do).
"""

from __future__ import annotations

import torch


class Arith:
    """Matrix products at float32 (`tf32=False`) or at TF32."""

    def __init__(self, tf32: bool = False):
        self.tf32 = tf32

    def round(self, x: torch.Tensor) -> torch.Tensor:
        """x with its mantissa rounded to TF32's 10 bits (nearest, ties
        away), non-finite entries kept."""
        if not self.tf32:
            return x
        bits = x.contiguous().view(torch.int32)
        r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
        return torch.where(torch.isfinite(x), r, x)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.round(a) @ self.round(b)


F32 = Arith(False)
TF32 = Arith(True)
