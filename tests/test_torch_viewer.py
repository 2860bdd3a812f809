"""Port parity for the interactive modules: render/camera_controller.py,
viewer.py (parse_script, fly_poses, run_viewer) and live_viewer.py (keys,
ANSI frames, the LiveViewer core, pick_size and the headless main).

Tolerances: camera states, ticks, keys, ANSI text and sizes equal (both
packages do this on the host in Python floats); view matrices and poses
within 1e-5 (float32 matrices built by torch and by XLA)."""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from torch_parity import DEVICE

from octree_slam_tpu import live_viewer as jlive
from octree_slam_tpu import viewer as jviewer
from octree_slam_tpu.render import camera_controller as jfly
from octree_slam_tpu_torch import SLAMConfig, app, live_viewer, viewer
from octree_slam_tpu_torch.io import png
from octree_slam_tpu_torch.render import camera_controller as fly

CFG = SLAMConfig(width=64, height=48, focal_x=55.0, focal_y=55.0,
                 pyramid_depth=2, pyramid_iters=(2, 2),
                 voxel_resolution=0.05, max_depth=7,
                 node_capacity=1 << 15, leaf_capacity=1 << 12)
SCRIPT = "w 1.0; look 0.5 -0.2; zoom -5; wait 0.2; a 0.3; up 0.2; s"


@pytest.fixture(scope="module")
def tiny_map():
    return viewer.orbit_map(CFG, 3, DEVICE)


def _same_inputs(t, j):
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_controller_update_and_camera():
    ts, js = fly.FlyCameraState(), jfly.FlyCameraState()
    steps = [dict(forward=1.0), dict(strafe=-1.0, drag_x=0.3),
             dict(rise=1.0, drag_y=2.0, scroll=-50.0), dict(drag_y=-30.0),
             dict(scroll=300.0)]
    for kw in steps:
        ts = fly.update(ts, fly.CameraInputs(**kw), 0.1)
        js = jfly.update(js, jfly.CameraInputs(**kw), 0.1)
        assert dataclasses.asdict(ts) == dataclasses.asdict(js)
        tc = fly.camera(ts, 4 / 3, device=DEVICE)
        jc = jfly.camera(js, 4 / 3)
        for name in ("view", "projection"):
            np.testing.assert_allclose(getattr(tc, name).numpy(),
                                       np.asarray(getattr(jc, name)),
                                       atol=1e-5)
    assert ts.pitch == -1.5 and ts.fov == 120.0  # both clamps reached


def test_parse_script_and_poses():
    for fps in (10.0, 4.0):
        t = viewer.parse_script(SCRIPT, fps)
        j = jviewer.parse_script(SCRIPT, fps)
        assert len(t) == len(j) > 10
        for a, b in zip(t, j):
            _same_inputs(a, b)
    with pytest.raises(ValueError, match="teleport"):
        viewer.parse_script("teleport 3", 10.0)
    ticks_t = viewer.parse_script(SCRIPT, 5.0)
    ticks_j = jviewer.parse_script(SCRIPT, 5.0)
    start_t = fly.FlyCameraState(position=(0.1, 0.2, 3.0))
    start_j = jfly.FlyCameraState(position=(0.1, 0.2, 3.0))
    pt = list(viewer.fly_poses(start_t, ticks_t, 0.2))
    pj = list(jviewer.fly_poses(start_j, ticks_j, 0.2))
    assert len(pt) == len(pj)
    for (st, a), (sj, b) in zip(pt, pj):
        assert dataclasses.asdict(st) == dataclasses.asdict(sj)
        assert a.dtype == np.float32
        np.testing.assert_allclose(a, b, atol=1e-5)
    # forward flight moves along -z; the look turns the heading
    assert pt[4][1][2, 3] < pt[0][1][2, 3]
    assert not np.allclose(pt[-1][1][:3, :3], pt[4][1][:3, :3])


@pytest.mark.parametrize("mode", ["splat", "cone"])
def test_run_viewer_writes_frames(tmp_path, tiny_map, mode):
    state, cfg = tiny_map
    script = "wait 0.2; w 0.4; look 0.5 0"
    out = tmp_path / "fly"
    n = viewer.run_viewer(state.pool, state.leaves, cfg, script=script,
                          out_dir=str(out), mode=mode, fps=5.0)
    assert n == len(jviewer.parse_script(script, 5.0))
    frames = sorted(pathlib.Path(out).glob("fly_*.png"))
    assert [f.name for f in frames] == [f"fly_{i:05d}.png" for i in range(n)]
    a = png.read_png(str(frames[0]))
    b = png.read_png(str(frames[-1]))
    assert a.shape == (48, 64, 4) and a[..., :3].max() > 0
    assert not np.array_equal(a, b)  # the camera moved


def test_keys_and_ansi_frames():
    for raw in (b"wasd", b"\x1b[A\x1b[D", b"W", b"q\t+", b"\x1b", b"\x1b[",
                b"\x1b[Bx\x1b[C-", bytes(range(32, 127))):
        assert live_viewer.decode_keys(raw) == jlive.decode_keys(raw)
    rng = np.random.default_rng(0)
    img = rng.integers(0, 3, (6, 9, 3)).astype(np.uint8) * 100
    for home in (True, False):
        assert live_viewer.ansi_frame(img, home) == jlive.ansi_frame(img,
                                                                     home)
    for cols, rows in ((100, 40), (10, 5), (233, 61)):
        assert live_viewer.pick_size(cols, rows) == jlive.pick_size(cols,
                                                                    rows)


def test_live_viewer_core(tiny_map):
    state, cfg = tiny_map
    v = live_viewer.LiveViewer(state.pool, state.leaves, cfg, width=64,
                               height=48, mode="splat")
    ref = v.state
    fb = v.tick()
    assert fb.shape == (48, 64, 4) and fb[..., 3].max() > 0
    ref = jfly.update(jfly.FlyCameraState(**dataclasses.asdict(ref)),
                      jfly.CameraInputs(), 0.1)
    for keys, inputs in ((["w", "w", "d"], dict(forward=2.0, strafe=1.0)),
                         (["LEFT", "UP"], dict(drag_x=0.35, drag_y=0.35)),
                         (["+", "r"], dict(scroll=-2.0, rise=1.0))):
        v.feed(keys)
        v.tick()
        ref = jfly.update(ref, jfly.CameraInputs(**inputs), 0.1)
        assert dataclasses.asdict(v.state) == dataclasses.asdict(ref)
    assert "12.3 fps" in v.status(12.3) and "splat" in v.status(12.3)
    v.feed(["\t"])
    assert v.mode == "cone"
    fb = v.tick()
    assert fb.shape == (48, 64, 4) and fb[..., :3].max() > 0
    v.feed(["q"])
    assert v.quit


def test_headless_main(tmp_path, tiny_map, capsys):
    """main() with stdin not a terminal: scripted ticks, no termios."""
    state, cfg = tiny_map
    path = str(tmp_path / "m.npz")
    app.save_state(path, state, cfg)
    n = live_viewer.main(["--load-state", path, "--ticks", "3", "--fps",
                          "100", "--device", "cpu"])
    assert n == 3
    out = capsys.readouterr().out
    assert out.count("▀") > 100 and "fps" in out
    m = viewer.main(["--load-state", path, "--out", str(tmp_path / "v"),
                     "--script", "wait 0.2", "--fps", "10", "--width", "64",
                     "--height", "48", "--device", "cpu"])
    assert m == 2 and "wrote 2 flight frames" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            viewer.main(["--load-state", path])
