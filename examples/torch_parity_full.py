"""The bench stream through the JAX package and the PyTorch port, side by side.

bench.py's headline configuration (640x480, depth 9, 2 cm leaves, 14-frame
synthetic orbit, step_angle 0.01, radius 2.0) runs through:

  * JAX on the CPU: pipeline.init_state + pipeline.step(render="splat");
  * the port on --port-device (cpu by default), the same way, from its own
    init_state (independent run);
  * the port again, but starting every frame from the JAX state of the
    frame before (lockstep run): where a frame's leaf keys differ, the
    script walks the frame's stages (filtered-depth pyramid, ICP pose,
    world points, Morton keys) and reports the first that differs and by
    how much. One-ulp pose differences flip keys at cell boundaries, so a
    differing key is traced to its float op before it is called a fault.

It prints ATE, map_nodes and map_leaves of each run and the count of leaf
keys that differ. --scale 2 halves the image (and the focal lengths);
--no-jax runs the port alone (the card's machine has no jax); --replay
adds bench.py's second, throughput pass over the same frames, after which
bench.py reads map_nodes / map_leaves.

    JAX_PLATFORMS=cpu python examples/torch_parity_full.py --scale 2
    python examples/torch_parity_full.py --no-jax --port-device cuda --replay
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from octree_slam_tpu.config import SLAMConfig  # noqa: E402
from octree_slam_tpu.utils.metrics import ate_rmse  # noqa: E402
from octree_slam_tpu_torch import convert, pipeline  # noqa: E402
from octree_slam_tpu_torch.sensor import sources, tracking  # noqa: E402
from octree_slam_tpu_torch.map import morton  # noqa: E402


def bench_config(scale: int) -> SLAMConfig:
    base = SLAMConfig()
    return SLAMConfig(width=640 // scale, height=480 // scale,
                      focal_x=base.focal_x / scale,
                      focal_y=base.focal_y / scale, max_depth=9,
                      voxel_resolution=0.02, node_capacity=1 << 20,
                      leaf_capacity=1 << 17)


def orbit_frames(cfg, n, step_angle, use_jax):
    """The orbit as numpy (depth u16, colour u8, gt pose), rendered by the
    JAX package's sources (as bench.py does) or, without jax, the port's."""
    if use_jax:
        import jax.numpy as jnp
        from octree_slam_tpu.sensor import sources as jsources
        scene = jsources.default_scene()
        poses = [jsources.orbit_pose(i * step_angle, radius=2.0)
                 for i in range(n)]
        fr = [jsources.render_frame(scene, g, cfg.focal_x, cfg.focal_y,
                                    width=cfg.width, height=cfg.height)
              for g in poses]
        return [(np.asarray(f.depth), np.asarray(f.color), np.asarray(g))
                for f, g in zip(fr, poses)]
    scene = sources.default_scene()
    out = []
    for i in range(n):
        gt = sources.orbit_pose(i * step_angle, radius=2.0)
        f = sources.render_frame(scene, gt, cfg.focal_x, cfg.focal_y,
                                 width=cfg.width, height=cfg.height)
        out.append((f.depth.numpy().astype(np.uint16), f.color.numpy(),
                    gt.numpy()))
    return out


def _summary(est, frames, n_warmup, out):
    gt = np.stack([f[2] for f in frames[n_warmup:]])
    return {"ate_rmse_m": ate_rmse(np.stack(est), gt),
            "map_nodes": int(out.map_nodes),
            "map_leaves": int(out.map_leaves),
            "diverged": bool(out.diverged),
            "map_overflowed": bool(out.map_overflowed)}


def run_port(cfg, frames, device, n_warmup, replay):
    state = pipeline.init_state(cfg, initial_pose=torch.from_numpy(
        frames[0][2].copy()), device=device)
    est = []
    passes = 2 if replay else 1
    for p in range(passes):
        for i, (d, c, _) in enumerate(frames):
            if p and i < n_warmup:
                continue
            state, out = pipeline.step(
                state, convert.frame_from_numpy(d, c, device=device), cfg)
            if p == 0 and i >= n_warmup:
                est.append(out.pose.cpu().numpy())
    return _summary(est, frames, n_warmup, out), state


def _leaf_keys(keys, count):
    return set(np.asarray(keys)[:int(count)].tolist())


def _first_divergence(jstate_before, jpyr, jpose, depth, color, cfg):
    """Walk one frame's stages in the port from the JAX state before the
    frame and report the first stage whose result differs from JAX's
    (jpyr / jpose: the pyramid and pose the jitted JAX step produced)."""
    import jax
    import jax.numpy as jnp
    from octree_slam_tpu.map import morton as jmorton
    f = convert.frame_from_numpy(depth, color)
    tpyr = tracking.build_pyramid(f.depth, f.color, cfg)
    for lvl, (jl, tl) in enumerate(zip(jpyr, tpyr)):
        jv, tv = np.asarray(jl.vertex), tl.vertex.numpy()
        if not np.array_equal(np.isinf(jv), np.isinf(tv)):
            return (f"pyramid level {lvl}: vertex INF masks differ "
                    f"({int((np.isinf(jv) != np.isinf(tv)).sum())} values) "
                    f"- the filtered depth differs")
        fin = np.isfinite(jv)
        dz = np.abs(jv[..., 2] - tv[..., 2])[fin[..., 2]]
        if (dz > 5e-4).any():
            return (f"pyramid level {lvl}: filtered depth differs by 1 mm "
                    f"at {int((dz > 5e-4).sum())} pixels (bilateral: the "
                    f"two libraries' expf straddle a rounding tie)")
        if not np.array_equal(jv[fin], tv[fin]):
            d = np.abs(jv[fin] - tv[fin]).max()
            return (f"pyramid level {lvl}: vertex map differs by up to "
                    f"{d:.3g} m (float rounding of the backprojection)")
    tstate = convert.state_from_numpy(jstate_before, cfg)
    T, _ = tracking.track(list(tstate.last_pyramid), tpyr, cfg)
    T = torch.where(tstate.initialized, T, torch.eye(4))
    tpose = (tstate.pose @ T).numpy()
    if not np.array_equal(tpose, jpose):
        msg = (f"ICP pose differs by up to {np.abs(tpose - jpose).max():.3g}"
               f" (19 Gauss-Newton solves summed in another order)")
    else:
        msg = "poses identical"
    v = jpyr[cfg.fuse_level].vertex.reshape(-1, 3)
    jw = np.asarray(jax.jit(lambda v, p: v @ p[:3, :3].T + p[:3, 3])(
        v, jnp.asarray(jpose)))
    tw = (tpyr[cfg.fuse_level].vertex.reshape(-1, 3) @ torch.from_numpy(
        tpose)[:3, :3].T + torch.from_numpy(tpose)[:3, 3]).numpy()
    hs = cfg.voxel_resolution * 2 ** (cfg.max_depth - 1)
    jk = np.asarray(jmorton.encode(jnp.asarray(jw), jnp.zeros(3), hs,
                                   cfg.max_depth)[0])
    tk = morton.encode(torch.from_numpy(tw), torch.zeros(3), hs,
                       cfg.max_depth)[0].numpy()
    return (f"{msg}; world points differ by up to "
            f"{np.nanmax(np.abs(np.where(np.isfinite(jw), jw - tw, 0))):.3g}"
            f" m; {int((jk != tk).sum())} of {jk.size} point keys flip")


def run_jax(cfg, frames, n_warmup):
    """The JAX step over the stream, with the port stepped in lockstep
    from each frame's JAX state."""
    import jax
    import jax.numpy as jnp
    from octree_slam_tpu import pipeline as jpipeline
    from octree_slam_tpu.core.types import Frame
    jcfg = dataclasses.replace(cfg, use_dense_mips=False)  # splat never reads it
    step = jax.jit(lambda s, f: jpipeline.step(s, f, jcfg))
    state = jpipeline.init_state(jcfg, initial_pose=jnp.asarray(frames[0][2]))
    est, diag = [], []
    for i, (d, c, _) in enumerate(frames):
        before = jax.tree_util.tree_map(np.asarray, state)
        f = Frame(jnp.asarray(d), jnp.asarray(c), jnp.float32(0))
        state, out = step(state, f)
        if i >= n_warmup:
            est.append(np.asarray(out.pose))
        ts, to = pipeline.step(convert.state_from_numpy(before, cfg),
                               convert.frame_from_numpy(d, c), cfg)
        jk = _leaf_keys(state.leaves.keys, out.map_leaves)
        tk = _leaf_keys(ts.leaves.keys, to.map_leaves)
        row = {"frame": i, "leaf_keys_differ": len(jk ^ tk),
               "pose_max_abs_diff": float(np.abs(
                   to.pose.numpy() - np.asarray(out.pose)).max())}
        if jk != tk:
            row["first_divergence"] = _first_divergence(
                before, state.last_pyramid, np.asarray(out.pose), d, c, cfg)
        diag.append(row)
    return _summary(est, frames, n_warmup, out), state, diag


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=1,
                    help="divide the 640x480 image and focal lengths")
    ap.add_argument("--port-device", default="cpu")
    ap.add_argument("--no-jax", action="store_true")
    ap.add_argument("--replay", action="store_true",
                    help="add bench.py's second (throughput) pass")
    args = ap.parse_args(argv)
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    cfg = bench_config(args.scale)
    n_warmup = 2
    frames = orbit_frames(cfg, 14, 0.01, use_jax=not args.no_jax)
    report = {"config": {"width": cfg.width, "height": cfg.height,
                         "max_depth": cfg.max_depth,
                         "voxel_resolution": cfg.voxel_resolution,
                         "frames": len(frames), "replay": args.replay},
              "port_device": (torch.cuda.get_device_name(0)
                              if args.port_device.startswith("cuda")
                              else "cpu")}
    port, pstate = run_port(cfg, frames, args.port_device, n_warmup,
                            args.replay)
    report["port"] = port
    if not args.no_jax:
        jres, jstate, diag = run_jax(cfg, frames, n_warmup)
        report["jax_cpu"] = jres
        jk = _leaf_keys(jstate.leaves.keys, jres["map_leaves"])
        pk = _leaf_keys(pstate.leaves.keys.cpu(), port["map_leaves"])
        report["independent_runs_leaf_keys_differ"] = len(jk ^ pk)
        report["lockstep"] = diag
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
