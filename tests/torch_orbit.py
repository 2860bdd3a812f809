"""The benchmark orbit of bench.py's headline arm on the card, its known
result, and the runners that drive it through the program's entry points
with the kernels' launch counts: 14 frames of the synthetic desk at
640x480, depth 9, 2 cm leaves. The full-size `cuda` tests and
chip_smoke.py drive it. Nothing here imports JAX, so it runs where JAX is
not installed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import warnings

import numpy as np
import torch

from octree_slam_tpu_torch import SLAMConfig, app
from octree_slam_tpu_torch.map import svo
from octree_slam_tpu_torch.parallel import run2d
from octree_slam_tpu_torch.sensor import cuda_ops, sources
from octree_slam_tpu_torch.utils.metrics import ate_rmse

ORBIT_FRAMES, ORBIT_WARMUP = 14, 2
ORBIT_STEP = 0.01               # rad a frame
# the orbit's result since the port's first kernels; the kernels are
# bit-exact against their plain versions, so any change in it is a fault
ORBIT_ATE_M, ORBIT_ATE_TOL_M = 0.0018455, 1e-7
ORBIT_MAP_NODES, ORBIT_MAP_LEAVES = 425_760, 73_458
# the hand kernels of a frame at the default 7x7 window
KERNELS = ("bilateral7x7", "gated_pyramid5x5")
# bench.py's hybrid arm: the band's lanes and its trip cap
HYBRID_BAND = {"cone_band_cap": 57_600, "cone_band_iters": 24}
# the recovery runs: the blanked frame, the candidates an attempt scores
# as one batch, and the bound on the last frame's translation error (the
# reference package's test)
RELOC_GARBAGE_FRAME, RELOC_CANDIDATES, RELOC_ERR_MAX_M = 8, 4, 0.05


def bench_config() -> SLAMConfig:
    """bench.py's headline configuration."""
    return SLAMConfig(width=640, height=480, max_depth=9,
                      voxel_resolution=0.02, node_capacity=1 << 20,
                      leaf_capacity=1 << 17)


def orbit(cfg, n: int = ORBIT_FRAMES, step_angle: float = ORBIT_STEP,
          device="cuda"):
    """(frames, world_T_cam ground truths) of the orbit."""
    scene = sources.default_scene(device)
    gts = [sources.orbit_pose(i * step_angle, radius=2.0, device=device)
           for i in range(n)]
    frames = [sources.render_frame(scene, g, cfg.focal_x, cfg.focal_y,
                                   width=cfg.width, height=cfg.height)
              for g in gts]
    return frames, gts


def orbit_ate(poses, gts) -> float:
    """The pinned ATE: over the frames after the warm-up."""
    return ate_rmse(np.stack([np.asarray(p) for p in poses[ORBIT_WARMUP:]]),
                    np.stack([g.cpu().numpy() for g in gts[ORBIT_WARMUP:]]))


def sorted_registry(state):
    """The leaf registry sorted by key, on the host: (keys, words)."""
    n = int(state.leaves.count)
    keys, order = torch.sort(state.leaves.keys[:n])
    return keys.cpu(), state.leaves.vals[:n][order].cpu()


class HostReads:
    """Counts the host reads that synchronise with the card while it is
    entered (torch's synchronisation warnings, a prototype that may miss
    some)."""

    def __enter__(self):
        # first, outside the record: switching the mode on warns that it
        # is a prototype
        torch.cuda.set_sync_debug_mode("warn")
        self._catch = warnings.catch_warnings(record=True)
        self._caught = self._catch.__enter__()
        warnings.simplefilter("always")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        self._catch.__exit__(*exc)
        self.count = sum("synchroniz" in str(w.message)
                         for w in self._caught)


def recovery(cfg, frames):
    """The recovery run's (config, frames): keyposes every other frame,
    RELOC_CANDIDATES candidates, frame RELOC_GARBAGE_FRAME blanked (zero
    depth and colour)."""
    rcfg = dataclasses.replace(cfg, keypose_every=2,
                               reloc_candidates=RELOC_CANDIDATES)
    frames = list(frames)
    f = frames[RELOC_GARBAGE_FRAME]
    frames[RELOC_GARBAGE_FRAME] = type(f)(torch.zeros_like(f.depth),
                                          torch.zeros_like(f.color),
                                          f.timestamp)
    return rcfg, frames


def pre_nodes(keys, depth, pre):
    """Nodes a pool with `pre` dense levels holds for these leaf keys: the
    dense region plus one 8-slot tile under every distinct level-l prefix
    of a leaf path, l = pre .. depth-1."""
    return svo._LEVEL_BASE[pre + 1] + 8 * sum(
        np.unique(keys >> (3 * (depth - l))).size for l in range(pre, depth))


def growth_capacities(keys, depth):
    """(node, leaf) capacities small enough that the orbit's 3/4 triggers
    fire: the pool's trigger at 70% of the final map's 4-dense-level node
    count at most, where doubling crosses from 4 to 5 dense levels."""
    n4 = pre_nodes(keys, depth, 4)
    lo = 8 * svo._LEVEL_BASE[6] // 2      # doubling from here on is 4 -> 5
    return max(lo, -(-int(n4 * 0.7 / 0.75) // 8) * 8), 1 << 16


def run_slam(cfg, frames, gts, **kw):
    """app.run_slam over the frames on the card, its JSON event lines
    kept, the kernels' launch counts set to 0 just before and read just
    after, and its host reads counted. Returns (result, final state,
    events, launches, launch batches, host reads)."""
    gts_np = [g.cpu().numpy() for g in gts]
    sink, out = [], io.StringIO()
    torch.cuda.synchronize()
    cuda_ops.reset_launches()
    with HostReads() as reads, contextlib.redirect_stdout(out):
        res = app.run_slam(lambda i: frames[i], len(frames), cfg,
                           initial_pose=gts[0], gt_fn=lambda i: gts_np[i],
                           render_every=1, render_mode="splat",
                           state_out=sink, device="cuda", **kw)
        torch.cuda.synchronize()
    events = [json.loads(line) for line in out.getvalue().splitlines()
              if line.startswith("{")]
    return (res, sink[0], events, dict(cuda_ops.LAUNCHES),
            {k: dict(v) for k, v in cuda_ops.LAUNCH_BATCHES.items()},
            reads.count)


def run_2d(cfg, mesh, frames, gts, render="splat", **kw):
    """run2d.run_slam_2d over the frames with the kernels' launch counts
    set to 0 just before and read just after: (state, cfg, info,
    launches)."""
    cuda_ops.reset_launches()
    state, cfg2, info = run2d.run_slam_2d(iter(frames), cfg, mesh,
                                          initial_pose=gts[0], render=render,
                                          **kw)
    torch.cuda.synchronize()
    return state, cfg2, info, dict(cuda_ops.LAUNCHES)


def run_cli(path):
    """The CLI's orbit with --save-mesh to `path`, its summary line kept,
    the kernels' launch counts set to 0 just before and read just after:
    (result, summary, launches)."""
    out = io.StringIO()
    cuda_ops.reset_launches()
    with contextlib.redirect_stdout(out):
        res = app.main(["--frames", str(ORBIT_FRAMES), "--render-every",
                        "0", "--log-every", "0", "--node-capacity",
                        str(1 << 20), "--save-mesh", path])
    torch.cuda.synchronize()
    return (res, json.loads(out.getvalue().strip().splitlines()[-1]),
            dict(cuda_ops.LAUNCHES))
