"""Stream kind `dropout`: the orbit (slambench/stream.py `orbit_stream`)
with the sensor returning no depth on `blank_frames` consecutive loop
frames out of every `blank_every`, as a structured-light sensor does
under interference, at close range or in sunlight, or an operator's hand
over it: depth 0 on those frames, their colour and ground-truth poses
kept. Loop frame i is blank where i % blank_every >= blank_every -
blank_frames, so every seed blanks the same frames of its loop and the
loop's first frames, the warm-up, track."""

from __future__ import annotations

import torch

from slambench import stream


def blank_rows(n: int, blank_every: int, blank_frames: int) -> torch.Tensor:
    """Indices of the blank frames of an n-frame loop."""
    if not 0 < blank_frames < blank_every:
        raise ValueError(f"dropout needs 0 < blank_frames < blank_every, got "
                         f"{blank_frames} and {blank_every}")
    i = torch.arange(n)
    return i[i % blank_every >= blank_every - blank_frames]


def make(traffic: dict, slam: dict, seed: int, device) -> stream.Stream:
    s = stream.orbit_stream(traffic, slam, seed, device)
    warmup = int(traffic.get("warmup_frames", 0))
    every, frames = int(traffic["blank_every"]), int(traffic["blank_frames"])
    if every - frames < warmup:
        raise ValueError(f"the first blank frame ({every - frames}) falls in "
                         f"the {warmup} warm-up frames")
    s.depth[blank_rows(len(s), every, frames).to(s.depth.device)] = 0
    return s
