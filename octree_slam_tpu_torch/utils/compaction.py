"""Static-shape stream compaction (counterpart:
octree_slam_tpu/utils/compaction.py).

Prefix-sum compaction into a fixed-capacity buffer with a live count, in
place of thrust::copy_if / unique (svo.cu:205,216-217). Every shape is
static and every count stays on the device, so none of these functions
synchronises with the host.

`scatter_set_` is the port's form of JAX's `out.at[idx].set(v,
mode="drop")`: torch raises on an out-of-range index, so dropped rows are
sent to one guard slot past the end of a scratch copy. The copy costs one
pass over `out`; it keeps the call free of host syncs (boolean-mask
indexing would need one).
"""

from __future__ import annotations

from typing import Tuple

import torch


def exclusive_ranks(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exclusive prefix-sum ranks of a boolean mask and the total count
    (both int32)."""
    m = mask.to(torch.int32)
    inc = torch.cumsum(m, dim=0, dtype=torch.int32)
    count = inc[-1] if m.numel() else torch.zeros(
        (), dtype=torch.int32, device=mask.device)
    return inc - m, count


def scatter_set_(out: torch.Tensor, idx: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    """out[idx[i]] = values[i] in place along dim 0, dropping rows whose
    index lies outside [0, len(out)). Valid indices must be distinct."""
    n = out.shape[0]
    ext = torch.empty((n + 1,) + tuple(out.shape[1:]), dtype=out.dtype,
                      device=out.device)
    ext[:n] = out
    ok = (idx >= 0) & (idx < n)
    ext[torch.where(ok, idx, n).to(torch.int64)] = values.to(out.dtype)
    out.copy_(ext[:n])
    return out


def compact(values: torch.Tensor, mask: torch.Tensor, capacity: int,
            fill=0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter `values[mask]` into a `capacity`-sized buffer (row order
    preserved). Returns (out, count); entries beyond capacity are dropped.
    values: [N, ...], mask: bool[N]."""
    (out,), count = compact_multi([values], mask, capacity, fill)
    return out, count


def compact_multi(arrays, mask: torch.Tensor, capacity: int, fill=0):
    """Compact several parallel arrays with one shared mask.
    Returns (list_of_outs, count)."""
    ranks, count = exclusive_ranks(mask)
    idx = torch.where(mask, ranks, capacity)
    outs = []
    for values in arrays:
        out = torch.full((capacity,) + tuple(values.shape[1:]), fill,
                         dtype=values.dtype, device=values.device)
        outs.append(scatter_set_(out, idx, values))
    return outs, torch.clamp(count, max=capacity)


def first_occurrence(sorted_keys: torch.Tensor,
                     valid: torch.Tensor | None = None) -> torch.Tensor:
    """Boolean mask of first occurrences in a sorted key array (the
    static-shape thrust::unique, svo.cu:216-217)."""
    first = torch.ones_like(sorted_keys, dtype=torch.bool)
    first[1:] = sorted_keys[1:] != sorted_keys[:-1]
    if valid is not None:
        first = first & valid
    return first
