"""A cell with tracking losses is judged whole, at slambench/tests/small.py's
CPU cut with keyposes every other frame and the `dropout` stream: the
reference's relocalization (slambench/reference/reloc.py) against the
program's, a recovery judged by `check`, the recovery's planted fault,
`failed` whatever frame the window closes on, and the trace's `app.reloc`
range."""

import importlib.util

import numpy as np
import pytest
import torch

from slambench import faults, harness, stream, trace
from slambench.reference import F32
from slambench.reference import fusion as ref_fusion
from slambench.reference import reloc as ref_reloc
from slambench.reference import sensor as ref_sensor
from slambench.tests.small import SEED, small_cell

# loop frames 8-9, 18-19, 28-29 and 38-39 of the 40-frame loop are blank
BLANK = {"kind": "dropout", "blank_every": 10, "blank_frames": 2}


def dropout_cell(**traffic) -> harness.Cell:
    c = small_cell()
    c.traffic = dict(c.traffic, **BLANK, **traffic)
    c.config = dict(c.config, slam=dict(c.slam, keypose_every=2))
    return c


def run(frames: int, control: bool = False, seed: int = SEED) -> dict:
    return harness.run_cell(dropout_cell(), seed, 1000.0, False, device="cpu",
                            max_frames=frames, control=control,
                            log=lambda m: None)


def _dropout_module():
    spec = importlib.util.spec_from_file_location(
        "slambench.streams.dropout",
        harness.BENCH_DIR / "streams" / "dropout.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [SEED, SEED + 17, 2 ** 31 + 5])
def test_reloc_reference_matches_program(seed):
    """Six frames mapped, then frame 9 tracked against the map from four
    keyposes: the program's score rows and winner equal the reference's,
    word for word."""
    from octree_slam_tpu_torch import pipeline, relocalize
    from octree_slam_tpu_torch.core.types import Frame
    from octree_slam_tpu_torch.sensor import tracking
    cell = small_cell()
    slam = cell.slam
    cfg = harness.slam_config(slam)
    s = stream.make_stream(dict(cell.traffic, frames_per_loop=40), slam, seed,
                           "cpu")
    state = pipeline.init_state(cfg, initial_pose=s.poses[0], device="cpu")
    table = ref_fusion.MapTable(slam, "cpu")
    poses = []
    for i in range(6):
        state, out = pipeline.step(state, Frame(s.depth[i], s.color[i],
                                                torch.tensor(i / 30.0)),
                                   cfg, render="none")
        assert not bool(out.diverged)
        poses.append(out.pose.clone())
        vertex0 = ref_sensor.pyramid(s.depth[i], slam, levels=1)[0][0]
        table.fuse(table.world_points(vertex0, poses[-1], F32), s.color[i])
    live = 9
    state = state._replace(last_pyramid=tuple(tracking.build_pyramid(
        s.depth[live], s.color[live], cfg)))
    keyposes = [poses[0], poses[2], poses[4], poses[5]]
    anchors = ref_reloc.candidates(keyposes, poses[5], cfg.reloc_candidates)
    rows = relocalize.score_candidates(
        state.leaves, state.pool.center, state.pool.half_size,
        torch.stack(anchors), state.last_pyramid, cfg)
    live_pyr = ref_sensor.pyramid(s.depth[live], slam)
    models = [(a, ref_reloc.model(table, a, slam, F32)) for a in anchors]
    ref_rows = ref_reloc.scores(models, live_pyr, slam, F32)
    for row, (pose, inl, ok) in zip(rows, ref_rows):
        assert torch.equal(row[:16].reshape(4, 4), pose)
        assert int(row[16]) == inl and bool(row[18] > 0) is ok
    assert any(ok for _, _, ok in ref_rows)
    pose, ok, _ = relocalize.relocalize(state, cfg,
                                        [p.numpy() for p in keyposes])
    ref_pose = ref_reloc.attempt(models, live_pyr, slam, F32)
    assert ok and ref_pose is not None
    assert np.array_equal(pose, ref_pose.numpy())


def test_recovery_is_judged_and_the_control_fails():
    """Frames 8-9 blank: frame 8 diverges, the attempt after frame 9 (blank)
    fails, the one after frame 10 recovers, frame 11 tracks from the
    recovered pose. The reference redoes both attempts and judges frame
    11's pose and every flag: all four numbers 0. The TF32 control in the
    program's place fails."""
    out = run(14, control=True)
    rec = out["recovery"]
    assert out["correct"] is True and out["failed"] == 0, out["checks"]
    assert all(c["value"] == 0 for c in out["checks"].values())
    assert rec["attempts"] == 2 and rec["recoveries"] == 1
    assert rec["resumed_frames"] == 1 and rec["lost_frames"] == 3
    assert rec["resumed_pose_gap"] == 0.0 and rec["resumed_differ"] == 0
    assert [k for k, v in out["control"].items()
            if v > out["checks"][k]["limit"]], out["control"]


def test_moved_recovery_fails():
    """The relocalized pose off by 1 mm: the first frame after the
    recovery composes its solve with it, and pose_gap fails."""
    with faults.planted("moved_recovery"):
        out = run(14)
    assert out["correct"] is False, out["checks"]
    assert out["recovery"]["resumed_pose_gap"] > out["checks"]["pose_gap"][
        "limit"]


def test_missed_recovery_is_failed_and_incorrect(monkeypatch):
    """A program whose attempts all fail stays lost where the reference's
    redo resumes: those frames are failed, and their flags differ."""
    from octree_slam_tpu_torch import relocalize
    monkeypatch.setattr(relocalize, "relocalize",
                        lambda state, cfg, keyposes: (None, False, {}))
    out = run(14)
    assert out["correct"] is False, out["checks"]
    assert out["checks"]["diverged_differ"]["value"] == out["failed"] > 0
    assert out["recovery"]["resumed_differ"] == 1


def test_failed_does_not_depend_on_the_close():
    """A window that closes inside the second blackout (its last frame is
    loop frame 18, blank, after a failed attempt in the final drain) and
    one that closes after the first recovery count the same failed frames:
    none, though the first run ends lost."""
    inside, after = run(17), run(14)
    assert 18 in _dropout_module().blank_rows(40, 10, 2).tolist()
    assert inside["recovery"]["attempts"] == 3
    assert inside["recovery"]["lost_frames"] == 4
    assert inside["recovery"]["lost_at_close"]
    assert not after["recovery"]["lost_at_close"]
    assert inside["correct"] and after["correct"], inside["checks"]
    assert inside["failed"] == after["failed"] == 0


def test_dropout_stream():
    """Blank frames have no depth and keep their colour and poses; every
    seed blanks the same frames of its loop; no blank in the warm-up."""
    cell = dropout_cell(frames_per_loop=20)
    orbit = dict(cell.traffic, kind="orbit")
    for seed in (SEED, SEED + 1):
        d = stream.make_stream(cell.traffic, cell.slam, seed, "cpu")
        o = stream.make_stream(orbit, cell.slam, seed, "cpu")
        blank = [8, 9, 18, 19]
        assert torch.equal(d.color, o.color) and torch.equal(d.poses, o.poses)
        assert int(d.depth[blank].abs().sum()) == 0
        keep = [i for i in range(20) if i not in blank]
        assert torch.equal(d.depth[keep], o.depth[keep])
    with pytest.raises(ValueError):
        stream.make_stream(dict(cell.traffic, warmup_frames=9), cell.slam,
                           SEED, "cpu")


def test_check_config_needs_the_recovery_settings():
    slam = dict(small_cell().slam)
    ref_reloc.check_config(slam)
    for key in ref_reloc.SETTINGS:
        with pytest.raises(ValueError):
            ref_reloc.check_config({k: v for k, v in slam.items()
                                    if k != key})
    with pytest.raises(ValueError):
        ref_reloc.check_config(dict(slam, relocalize=False))


def test_planted_recovery_fault_is_undone():
    from octree_slam_tpu_torch import pipeline, relocalize
    inner, step = relocalize.relocalize, pipeline.step
    with faults.planted("moved_recovery"):
        assert relocalize.relocalize is not inner
        assert pipeline.step is step
    assert relocalize.relocalize is inner


def test_reloc_range_credited():
    """app.reloc, between two steps, is credited as a step range is: its
    host time by its span, its kernels' device time by their correlation
    ids; app_host_ms leaves it out."""
    ev = []

    def x(cat, name, ts, dur, **args):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts,
                   "dur": dur, "args": args})

    for f, t0 in enumerate((0.0, 1000.0, 2000.0)):
        x("user_annotation", "step.pyramid", t0, 100)
        x("user_annotation", "step.track", t0 + 100, 300)
        x("user_annotation", "app.reloc", t0 + 500, 400)
        x("cuda_runtime", "cudaLaunchKernel", t0 + 600, 5, correlation=f)
        x("kernel", "icp", t0 + 610, 250, correlation=f, grid=[1, 1, 1])
    s = trace.summarize({"traceEvents": ev}, {})
    assert s.range_host_s["app.reloc"] == pytest.approx(8e-4)
    assert s.range_device_s["app.reloc"] == pytest.approx(5e-4)
    app_host = harness.load_reader("app_host_ms")
    assert app_host(s) == pytest.approx(0.2)
