"""Static-shape stream compaction (counterpart:
octree_slam_tpu/utils/compaction.py).

Prefix-sum compaction into a fixed-capacity buffer with a live count, in
place of thrust::copy_if / unique (svo.cu:205,216-217). Every shape is
static and every count stays on the device, so none of these functions
synchronises with the host.

`scatter_set_` is the port's form of JAX's `out.at[idx].set(v,
mode="drop")`: torch raises on an out-of-range index, so every dropped row
is pointed at the target of one kept row and given that row's value
(duplicate writes of one value leave that value). That costs a few ops of
the width of `idx` and nothing of the size of `out`, which matters for the
dense mirror's half-gigabyte buffer, and keeps the call free of host syncs
(boolean-mask indexing would need one).
"""

from __future__ import annotations

from typing import Tuple

import torch

# candidate lanes that the voxelizer and the rasterizer enumerate at once;
# read at each call, so it bounds the memory of every chunked enumeration
CHUNK_LANES = 1 << 22


def chunks(n: int, budget: int):
    """[start, end) ranges over n items of `budget` lanes each, as many
    items a range as CHUNK_LANES holds (at least one)."""
    step = max(1, CHUNK_LANES // budget)
    return [(s, min(s + step, n)) for s in range(0, n, step)]


def exclusive_ranks(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exclusive prefix-sum ranks of a boolean mask and the total count
    (both int32)."""
    m = mask.to(torch.int32)
    inc = torch.cumsum(m, dim=0, dtype=torch.int32)
    count = inc[-1] if m.numel() else torch.zeros(
        (), dtype=torch.int32, device=mask.device)
    return inc - m, count


def live_first(active: torch.Tensor, count: int) -> torch.Tensor:
    """The first `count` lane ids of a stable sort of the lanes by "live
    first": the live lanes in index order, then the lowest-numbered dead
    ones; the reference's argsort(where(active, 0, 1))[:count]
    (octree_slam_tpu/render/raycast.py:486-487). A live lane's rank is its
    prefix count, a dead lane's the live total plus its prefix count among
    the dead; one scatter inverts the ranks. Returns int64[count]."""
    ranks, n_live = exclusive_ranks(active)
    lane = torch.arange(active.numel(), dtype=torch.int64,
                        device=active.device)
    rank = torch.where(active, ranks, n_live + lane - ranks)
    return torch.empty_like(lane).scatter_(0, rank, lane)[:count]


def scatter_set_(out: torch.Tensor, idx: torch.Tensor,
                 values: torch.Tensor) -> torch.Tensor:
    """out[idx[i]] = values[i] in place along dim 0, dropping rows whose
    index lies outside [0, len(out)). Valid indices must be distinct."""
    if idx.numel() == 0:
        return out
    n = out.shape[0]
    values = values.to(out.dtype)
    ok = (idx >= 0) & (idx < n)
    safe = torch.where(ok, idx, 0).to(torch.int64)
    # one kept row stands in for every dropped one; with no kept row, all
    # rows rewrite out[0] with itself. j stays a 1-element index tensor: a
    # 0-d one would be read back to the host by the indexing.
    j = torch.argmax(ok.to(torch.uint8)).reshape(1)
    trail = (1,) * (values.dim() - 1)
    tgt0 = torch.where(ok[j], safe[j], 0)
    val0 = torch.where(ok[j].reshape((1,) + trail), values[j], out[:1])
    out[torch.where(ok, safe, tgt0)] = torch.where(
        ok.reshape((-1,) + trail), values, val0)
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
