"""Port parity for the app loop (app.py): run_slam against the JAX
package's run_slam on a short orbit that grows its pool and its registry
(poses, ATE, map_nodes, the growth events and capacities, the final map),
stop_fn, the directory-cache check, the checkpoint round trip and what it
refuses, and the port's CLI with --save-trajectory and --save-dir.

Tolerances: poses within 1e-4 and ATE within 1e-5 m; map_nodes, capacities
and the frames on which growth fired exact; the final leaf sets within 1%
(see the test); checkpoint fields word for word; trajectory files read
back within their 6 printed decimals."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from torch_parity import (DEVICE, jax_frame, np_state,
                          orbit_frames, orbit_port_frames, port_config,
                          write_field_file)

from octree_slam_tpu import app as japp
from octree_slam_tpu import pipeline as jpipeline
from octree_slam_tpu.config import SLAMConfig
from octree_slam_tpu_torch import app, convert, pipeline
from octree_slam_tpu_torch.io import png
from octree_slam_tpu_torch.io.tum import _read_groundtruth

# the JAX package's growth test config: a pool of 9,368 slots and a
# registry of 512 rows, both too small for the scene
GROW = SLAMConfig(width=64, height=48, focal_x=55.0, focal_y=55.0,
                  pyramid_depth=2, pyramid_iters=(2, 2),
                  voxel_resolution=0.02, max_depth=8, node_capacity=9368,
                  leaf_capacity=1 << 9, max_march_iters=16,
                  precompile_ahead=False)
SMALL = SLAMConfig(width=64, height=48, focal_x=55.0, focal_y=55.0,
                   pyramid_depth=2, pyramid_iters=(4, 4),
                   voxel_resolution=0.05, max_depth=7,
                   node_capacity=1 << 15, leaf_capacity=1 << 12,
                   insert_unique_cap=1 << 11, max_march_iters=24,
                   precompile_ahead=False)


def _events(capsys, kinds=("map_grow",)):
    out = []
    for line in capsys.readouterr().out.splitlines():
        if line.startswith("{") and '"event"' in line:
            rec = json.loads(line)
            if rec["event"] in kinds:
                out.append(rec)
    return out


@pytest.mark.parametrize("render_every", [0, 2])
def test_run_slam_matches_reference_with_growth(render_every, capsys):
    stream = orbit_frames(GROW, 5, step_angle=0.05)
    depth, color, gt = stream
    frames = orbit_port_frames(stream)
    jsink, tsink = [], []
    jres = japp.run_slam(lambda i: jax_frame(depth, color, i), 5, GROW,
                         initial_pose=gt[0], gt_fn=lambda i: gt[i],
                         render_every=render_every, state_out=jsink)
    jev = _events(capsys)
    tres = app.run_slam(lambda i: frames[i], 5, port_config(GROW),
                        initial_pose=gt[0], gt_fn=lambda i: gt[i],
                        render_every=render_every, state_out=tsink,
                        device=DEVICE)
    tev = _events(capsys)
    assert tev == jev and len(tev) >= 2
    assert tres.frames == jres.frames == 5
    np.testing.assert_allclose(np.stack(tres.poses), np.stack(jres.poses),
                               atol=1e-4)
    assert abs(tres.ate_rmse - jres.ate_rmse) < 1e-5
    assert tres.map_nodes == jres.map_nodes
    assert tres.diverged == jres.diverged is False
    fc, jc = tres.final_cfg, jres.final_cfg
    assert (fc.node_capacity, fc.leaf_capacity) == \
        (jc.node_capacity, jc.leaf_capacity)
    assert fc.node_capacity > GROW.node_capacity
    assert fc.leaf_capacity > GROW.leaf_capacity
    assert tres.growth_frame_s is not None
    # Each frame but the last overflows the pool, and the allocation cut
    # falls after a different key wherever one point lies on a cell
    # boundary (the poses differ in the last bits), so the node layouts
    # differ; the leaf sets agree to 1%.
    tstate, jstate = tsink[0], jsink[0]
    tk = set(tstate.leaves.keys[:int(tstate.leaves.count)].tolist())
    jk = set(np.asarray(jstate.leaves.keys)[:int(jstate.leaves.count)]
             .tolist())
    assert len(tk ^ jk) <= 0.01 * len(jk) and len(jk) > 1000
    assert not bool(tstate.pool.overflowed)
    assert not bool(tstate.leaves.overflowed)


def test_stop_fn_ends_run_early():
    stream = orbit_frames(SMALL, 6, step_angle=0.02)
    frames = orbit_port_frames(stream)
    res = app.run_slam(lambda i: frames[i], 6, port_config(SMALL),
                       initial_pose=stream[2][0], render_every=0,
                       stop_fn=lambda i: i >= 3, device=DEVICE)
    assert res.frames == 3 and len(res.poses) == 3
    assert res.steady_fps > 0 and res.max_frame_s > 0
    assert res.growth_frame_s is None


def test_debug_validate_dircache(capsys):
    """The cached run re-runs every 2nd frame uncached from a copy of the
    state before it and finds the same leaves."""
    cfg = port_config(dataclasses.replace(
        SMALL, insert_dircache=True, debug_validate_dircache=2))
    stream = orbit_frames(SMALL, 5, step_angle=0.03)
    frames = orbit_port_frames(stream)
    res = app.run_slam(lambda i: frames[i], 5, cfg,
                       initial_pose=stream[2][0], render_every=0,
                       device=DEVICE)
    assert not res.diverged
    ev = _events(capsys, ("dircache_validated",))
    assert [e["frame"] for e in ev] == [2, 4]
    assert all(e["leaves"] > 0 for e in ev)


def test_dircache_check_catches_a_stale_directory():
    cfg = port_config(dataclasses.replace(SMALL, insert_dircache=True))
    stream = orbit_frames(SMALL, 3, step_angle=0.03)
    frames = orbit_port_frames(stream)
    state = pipeline.init_state(cfg, initial_pose=stream[2][0],
                                device=DEVICE)
    for f in frames[:2]:
        state, _ = pipeline.step(state, f, cfg)
    pre = convert.clone_state(state)
    # a directory whose cached words are stale: blends start from them
    pre = pre._replace(dir_vals=pre.dir_vals ^ 0x00404040)
    post, _ = pipeline.step(convert.clone_state(pre), frames[2], cfg)
    with pytest.raises(RuntimeError, match="dircache validation FAILED"):
        app._validate_dircache(pre, post, frames[2], cfg, 2)


def _stepped(cfg, n=2):
    stream = orbit_frames(cfg, n, step_angle=0.03)
    frames = orbit_port_frames(stream)
    tcfg = port_config(cfg)
    state = pipeline.init_state(tcfg, initial_pose=stream[2][0],
                                device=DEVICE)
    for f in frames:
        state, _ = pipeline.step(state, f, tcfg, render="cone_hybrid")
    return state, tcfg, frames


@pytest.mark.parametrize("fmt", ["reference", "field"])
def test_checkpoint_round_trip(tmp_path, fmt):
    """Every field word for word, from the file save_state writes and from
    the port's earlier field:<name> file; one more frame from the loaded
    state and from a copy of the original gives the same pose, map and
    registry."""
    cfg = dataclasses.replace(SMALL, insert_dircache=True,
                              saturation_gate=True, track_keyframe=True)
    state, tcfg, frames = _stepped(cfg)
    path = str(tmp_path / "state.npz")
    _save(path, state, tcfg, fmt)
    # the caller's cfg has other capacities: the stamps win
    other = dataclasses.replace(tcfg, node_capacity=1 << 16,
                                leaf_capacity=1 << 10)
    loaded, lcfg = app.load_state(path, other, device=DEVICE)
    assert lcfg == tcfg
    a = app._flatten(convert.state_to_numpy(state))
    b = app._flatten(convert.state_to_numpy(loaded))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    s1, o1 = pipeline.step(loaded, frames[-1], lcfg, render="cone_hybrid")
    s2, o2 = pipeline.step(convert.clone_state(state), frames[-1], tcfg,
                           render="cone_hybrid")
    assert torch.equal(o1.pose, o2.pose)
    assert torch.equal(s1.pool.value, s2.pool.value)
    assert torch.equal(s1.leaves.keys, s2.leaves.keys)
    assert torch.equal(s1.leaves.vals, s2.leaves.vals)


def test_checkpoint_matches_reference_stamps(tmp_path):
    """The port writes the JAX package's file: the same keys (`n`, a0 ..
    a{n-1} and the 15 stamps) with the same stamp values, the map words as
    the JAX package's u32 bits in its leaf order."""
    cfg = SMALL
    stream = orbit_frames(cfg, 1)
    jstate = jpipeline.init_state(cfg, initial_pose=jnp.asarray(stream[2][0]))
    jstate, _ = jpipeline.step(jstate, jax_frame(*stream[:2], 0), cfg)
    tstate = convert.state_from_numpy(np_state(jstate), port_config(cfg),
                                      device=DEVICE)
    japp.save_state(str(tmp_path / "j.npz"), jstate, cfg)
    app.save_state(str(tmp_path / "t.npz"), tstate, port_config(cfg))
    with np.load(tmp_path / "j.npz") as zj, np.load(tmp_path / "t.npz") as zt:
        assert sorted(zt.files) == sorted(zj.files)
        stamps = [k for k in zj.files if not k.startswith("a")
                  and k != "n"]
        assert len(stamps) == 15
        for k in stamps + ["n"]:
            assert zt[k] == zj[k], k
        i = convert.slam_state_leaf_names(port_config(cfg)).index(
            "pool.value")
        assert zt[f"a{i}"].dtype == np.uint32
        np.testing.assert_array_equal(zt[f"a{i}"],
                                      np.asarray(jstate.pool.value))


def _rewrite(path, out, drop=(), change=None):
    with np.load(path) as z:
        data = {k: z[k] for k in z.files if k not in drop}
    if change:
        data.update(change(data))
    np.savez(out, **data)
    return out


def _save(path, state, cfg, fmt):
    """`state` in the reference package's file (what save_state writes) or
    in the port's earlier field:<name> one. Returns {field: its key}."""
    if fmt == "reference":
        app.save_state(path, state, cfg)
        return {k: f"a{i}" for i, k in enumerate(
            convert.slam_state_leaf_names(cfg))}
    from octree_slam_tpu_torch.map import svo
    write_field_file(path, convert.state_to_numpy(state), dict(
        prealloc=svo.prealloc_levels(cfg.node_capacity),
        node_capacity=cfg.node_capacity, leaf_capacity=cfg.leaf_capacity,
        **{k: (int(v) if isinstance(v, bool) else v)
           for k, v in ((k, getattr(cfg, k)) for k, _ in app._STAMPS)}))
    return {k: "field:" + k for k in app._flatten(
        convert.state_to_numpy(state))}


@pytest.mark.parametrize("fmt", ["reference", "field"])
@pytest.mark.parametrize("fault,match", [
    # no stamp means the legacy schedule: 5 dense levels at 2^20 nodes
    ("no_prealloc", "written with 5 dense-preallocated"),
    ("wrong_prealloc", "dense-preallocated"),
    ("missing_field", r"lacks field leaves.vals|has 32 arrays but the current "
                      r"config expects 35"),
    ("dtype", "field pool.value: stored int32"),
    ("shape", "field last_pyramid.0.vertex"),
])
def test_checkpoint_refusals(tmp_path, fault, match, fmt):
    cfg = (dataclasses.replace(SMALL, node_capacity=1 << 20)
           if fault == "no_prealloc" else SMALL)
    state, tcfg, _ = _stepped(cfg, n=1)
    path = str(tmp_path / "s.npz")
    key = _save(path, state, tcfg, fmt)
    out = str(tmp_path / "bad.npz")
    if fault == "no_prealloc":
        _rewrite(path, out, drop=("prealloc",))
    elif fault == "wrong_prealloc":
        _rewrite(path, out, change=lambda d: {"prealloc": np.int64(3)})
    elif fault == "missing_field" and fmt == "field":
        _rewrite(path, out, drop=(key["leaves.vals"],))
    elif fault == "missing_field":
        # three arrays short: no legacy tail without the directory cache
        n = len(key)
        _rewrite(path, out, drop=[f"a{i}" for i in range(n - 3, n)],
                 change=lambda d: {"n": np.asarray(n - 3)})
    elif fault == "dtype":
        k = key["pool.value"]
        _rewrite(path, out, change=lambda d: {k: d[k].view(np.int32)})
    else:
        k = key["last_pyramid.0.vertex"]
        _rewrite(path, out, change=lambda d: {k: d[k][:-1]})
    with pytest.raises(ValueError, match=match):
        app.load_state(out, tcfg, device=DEVICE)


def test_cli_orbit_saves_trajectory_and_frames(tmp_path, capsys):
    traj = str(tmp_path / "traj.txt")
    frames_dir = tmp_path / "fb"
    ckpt = str(tmp_path / "end.npz")
    res = app.main(["--source", "orbit", "--frames", "3", "--width", "64",
                    "--height", "48", "--max-depth", "6", "--resolution",
                    "0.08", "--render-every", "1", "--log-every", "0",
                    "--save-trajectory", traj, "--save-dir", str(frames_dir),
                    "--save-state", ckpt, "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rec) == {"fps", "steady_fps", "ate_rmse", "frames",
                        "map_nodes", "diverged"}
    assert rec["frames"] == 3 and rec["diverged"] is False
    assert rec["ate_rmse"] < 0.1
    est = _read_groundtruth(traj)
    gt = _read_groundtruth(traj + ".gt.txt")
    assert len(est) == len(gt) == 3
    for (t, T), P in zip(est, res.poses):
        np.testing.assert_allclose(T, P, atol=2e-6)
    pngs = sorted(p.name for p in frames_dir.iterdir())
    assert pngs == [f"frame_{j:05d}.png" for j in range(3)]
    img = png.read_png(str(frames_dir / pngs[-1]))
    assert img.shape == (48, 64, 4) and img[..., :3].max() > 0
    # the saved state resumes another run
    res2 = app.main(["--source", "orbit", "--frames", "2", "--width", "64",
                     "--height", "48", "--max-depth", "6", "--resolution",
                     "0.08", "--render-every", "0", "--log-every", "0",
                     "--load-state", ckpt, "--device", "cpu"])
    assert res2.frames == 2 and not res2.diverged


def test_cli_refuses_unported_and_missing_card(tmp_path):
    # --save-mesh is ported: one frame writes the map's cube mesh, 8
    # vertices and 12 faces a voxel
    mesh = tmp_path / "m.obj"
    app.main(["--frames", "1", "--width", "32", "--height", "24",
              "--max-depth", "5", "--resolution", "0.1", "--log-every", "0",
              "--save-mesh", str(mesh), "--device", "cpu"])
    lines = mesh.read_text().splitlines()
    n_v = sum(line.startswith("v ") for line in lines)
    n_f = sum(line.startswith("f ") for line in lines)
    assert n_v > 0 and n_v % 8 == 0 and n_f == 12 * (n_v // 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            app.main(["--frames", "1", "--width", "32", "--height", "24"])
