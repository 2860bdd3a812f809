"""Reference relocalization: the program's recovery from a tracking loss
(relocalize.py, called from app.run_slam's `consume`) written out from its
semantics over the reference's own map table.

  * candidates: the newest `reloc_candidates` keyposes, newest first,
    padded to that many with the oldest of them; with no keypose, the lost
    frame's own pose. A keypose is the pose of a frame j with
    j % keypose_every == 0 that was tracking (the caller keeps the list);
  * the depth at a candidate: the table's leaves splatted into a packed
    (depth q15 << 16 | rgb565) z-buffer by the splat view's projection and
    scatter-min, 3 rounds of 3x3 hole filling, the quantised depth in
    millimetres, truncated and saturated at 65,535;
  * the score: the sensor pyramid of that depth, and the live frame's
    pyramid tracked against it by the tracker. A candidate is ok where the
    solve did not diverge, its finest level kept at least
    int(reloc_min_inlier_frac * H * W) inliers and its pose (the candidate
    times the solve) is finite; the ok candidate with the most inliers
    wins, the first of equals.

Departures from the program, none of which changes a word:
  * the program builds its K candidates' pyramids as one batch [K, H, W]
    (one bilateral and one gated-pyramid launch); the reference builds
    each alone: the stencils treat every image of a batch alone;
  * the program splats its registry's rows in insertion order, the
    reference its table's leaves ascending by key: a scatter-min does not
    depend on the order;
  * the program packs the K scores into one [K, 19] row block read once on
    the host; the reference reads each candidate's verdict as it comes;
  * the program renders its candidates' views on every attempt; the
    caller of `attempt` may keep a candidate's `model` for as long as its
    table does not change, as through one loss, when no frame fuses and
    no keypose is added.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from . import Arith
from . import render as ref_render
from . import sensor as ref_sensor

SETTINGS = ("relocalize", "keypose_every", "reloc_candidates",
            "reloc_min_inlier_frac")


def check_config(slam: dict) -> None:
    """Raise for a configuration that does not state the recovery's
    settings, or states one this reference does not follow."""
    missing = [k for k in SETTINGS if k not in slam]
    if missing:
        raise ValueError(f"the configuration must state {missing}: the "
                         f"reference redoes the program's relocalization "
                         f"from them")
    if slam["relocalize"] is not True or int(slam["reloc_candidates"]) < 1:
        raise ValueError("the reference follows relocalize=True with at "
                         "least one candidate only")
    if int(slam["keypose_every"]) < 1:
        raise ValueError("keypose_every must be at least 1")
    if slam.get("device_remainder", True) is not True:
        raise ValueError("the reference follows the app loop's one-frame lag "
                         "(device_remainder=True) only")


def candidates(keyposes: list, own, k: int) -> list:
    """The attempt's k candidates of the keyposes (oldest first): the
    newest first, padded with the oldest of them; the lost frame's own
    pose (`own`) where there is none."""
    cands = list(keyposes[::-1][:k]) or [own]
    while len(cands) < k:
        cands.append(cands[-1])
    return cands


def depth_mm(keys, words, center, half_size, pose, slam: dict,
             ar: Arith) -> torch.Tensor:
    """i32[H, W] millimetres of the leaves seen from `pose`, 0 where none."""
    img = ref_render.fill_holes(ref_render.splat_zbuffer(
        keys, words, center, half_size, pose, slam, ar), 3)
    qz = torch.where(img != ref_render.DEPTH_INF, img >> 16, 0)
    mm = qz.to(torch.float32) * (slam["max_range"] / 32766.0) * 1e3
    return mm.clamp(max=65535.0).to(torch.int32)


def model(table, pose: torch.Tensor, slam: dict, ar: Arith) -> List:
    """The sensor pyramid of the table's depth seen from `pose`."""
    keys, words = table.leaves()
    return ref_sensor.pyramid(depth_mm(keys, words, table.center,
                                       table.half_size, pose, slam, ar), slam)


def scores(anchors: List[Tuple[torch.Tensor, List]], live: List, slam: dict,
           ar: Arith) -> List[Tuple[torch.Tensor, int, bool]]:
    """Each candidate's (pose f32[4, 4], finest-level inliers, ok): the live
    pyramid tracked against the candidate's model pyramid, for anchors
    given as (candidate pose, its `model`)."""
    min_inl = int(slam["reloc_min_inlier_frac"]
                  * (slam["width"] * slam["height"]))
    rows = []
    for cand, pyr in anchors:
        T, div, inl = ref_sensor.track_inliers(pyr, live, slam, ar)
        pose = ar.mm(cand, T)
        inl = int(inl)
        ok = (not bool(div) and inl >= min_inl
              and bool(torch.isfinite(pose).all()))
        rows.append((pose, inl, ok))
    return rows


def attempt(anchors: List[Tuple[torch.Tensor, List]], live: List,
            slam: dict, ar: Arith) -> Optional[torch.Tensor]:
    """One relocalization attempt of the live pyramid from the anchors
    (candidate pose, its `model`): the winner's pose f32[4, 4], or None
    where no candidate is ok."""
    best, best_inl = None, -1
    for pose, inl, ok in scores(anchors, live, slam, ar):
        if ok and inl > best_inl:
            best, best_inl = pose, inl
    return best
