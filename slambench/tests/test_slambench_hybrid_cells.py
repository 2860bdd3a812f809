"""The room-scale cone-traced cells, room2cm_hybrid.view30 and
room2cm_hybrid.orbit: found by name in BENCHMARK.json with their files,
correct at a CPU cut against the reference's hybrid view (view30's judged
view healed after "none" frames), and the band's readers on a synthetic
trace: `step.band` credited beside `step.render`, not inside it, and no
reading where a program has no such stage."""

import pytest

from slambench import harness, trace
from slambench.tests.small import SEED

CELLS = ["room2cm_hybrid.view30", "room2cm_hybrid.orbit"]
TEN = {"track_host_ms", "track_device_ms", "fuse_host_ms", "fuse_device_ms",
       "render_host_ms", "render_device_ms", "launches_per_frame",
       "stencil_roofline", "device_idle_pct", "app_host_ms"}
BAND = {"band_host_ms", "band_device_ms"}


def cpu_cut(cell: harness.Cell, **traffic) -> harness.Cell:
    """The cell at slambench/tests/small.py's CPU cut (160x120, 4 cm, depth
    7, a 3,600-lane band, a 40-frame loop, 2 warm-up frames)."""
    slam = dict(cell.slam)
    slam.update(width=160, height=120, focal_x=532.57 / 4,
                focal_y=531.54 / 4, voxel_resolution=0.04, max_depth=7,
                node_capacity=1 << 16, leaf_capacity=1 << 14,
                insert_unique_cap=4096, cone_band_cap=3600)
    cell.config = dict(cell.config, slam=slam)
    cell.traffic = dict(cell.traffic, warmup_frames=2, frames_per_loop=40,
                        **traffic)
    return cell


@pytest.mark.parametrize("name", CELLS)
def test_cells_load_by_name(name):
    cell = harness.load_cell(name)
    assert cell.config["name"] == "room2cm_hybrid"
    assert cell.render == "cone_hybrid"
    assert cell.slam["cone_band_cap"] == 57600
    assert cell.slam["cone_band_iters"] == 24
    assert cell.slam["voxel_resolution"] == 0.02
    assert cell.traffic.get("render_every", 1) == (
        30 if name.endswith("view30") else 1)
    assert set(cell.limits) >= {"pose_gap", "diverged_differ",
                                "map_diff_share", "render_diff_share"}
    assert {m["name"] for m in cell.end_to_end} == {"fps", "frame_ms_p95",
                                                    "setup_s"}
    layer = {m["name"] for m in cell.per_layer}
    assert layer == TEN | (BAND if name.endswith("orbit") else set())
    for m in layer:
        assert callable(harness.load_reader(m, cell.bench_dir))


@pytest.mark.parametrize("name,frames,every", [
    ("room2cm_hybrid.view30", 10, 4),
    ("room2cm_hybrid.orbit", 6, None),
])
def test_small_run_is_correct(name, frames, every):
    """view30 at render_every 4 over 10 frames after 2 warm-up frames: the
    judged view is frame 8's, which heals the mirror that frames 5-7 left
    stale."""
    traffic = {} if every is None else {"render_every": every}
    cell = cpu_cut(harness.load_cell(name), **traffic)
    out = harness.run_cell(cell, SEED, 1000.0, False, device="cpu",
                           max_frames=frames, log=lambda m: None)
    assert out["attempted"] == frames and out["failed"] == 0
    assert out["correct"] is True, out["checks"]
    assert all(c["value"] == 0.0 for c in out["checks"].values())


def test_traced_orbit_reads_the_band():
    """A traced CPU run of the orbit cell puts band_host_ms on the line
    (band_device_ms needs the card's kernels)."""
    cell = cpu_cut(harness.load_cell("room2cm_hybrid.orbit"))
    out = harness.run_cell(cell, SEED, 1000.0, True, device="cpu",
                           max_frames=6, log=lambda m: None)
    assert out["correct"] is True, out["checks"]
    assert out["metrics"]["band_host_ms"]["value"] > 0.0
    assert "band_device_ms" not in out["metrics"]
    assert out["metrics"]["render_host_ms"]["value"] > 0.0


def _trace(with_band: bool) -> dict:
    """Two frames of a hand-made trace: a kernel launched in step.render,
    and one in step.band (or, without the stage, later in step.render)."""
    ev = []

    def x(cat, name, ts, dur, **args):
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": ts,
                   "dur": dur, "args": args})

    for f, t0 in enumerate((0.0, 1000.0, 2000.0)):
        x("user_annotation", "step.pyramid", t0, 100)
        if with_band:
            x("user_annotation", "step.render", t0 + 100, 300)
            x("user_annotation", "step.band", t0 + 400, 500)
            x("user_annotation", "band.march", t0 + 450, 100)
        else:
            x("user_annotation", "step.render", t0 + 100, 800)
        x("cuda_runtime", "cudaLaunchKernel", t0 + 150, 5,
          correlation=2 * f)
        x("kernel", "slab", t0 + 160, 100, correlation=2 * f,
          grid=[1, 1, 1])
        x("cuda_runtime", "cudaLaunchKernel", t0 + 600, 5,
          correlation=2 * f + 1)
        x("kernel", "march", t0 + 610, 200, correlation=2 * f + 1,
          grid=[1, 1, 1])
    return {"traceEvents": ev}


@pytest.mark.parametrize("with_band", [True, False])
def test_band_readers(with_band):
    s = trace.summarize(_trace(with_band), {})
    host = harness.load_reader("band_host_ms")
    device = harness.load_reader("band_device_ms")
    render = harness.load_reader("render_device_ms")
    if with_band:
        assert host(s) == pytest.approx(0.5)
        assert device(s) == pytest.approx(0.2)
        assert render(s) == pytest.approx(0.1)
    else:
        assert host(s) is None and device(s) is None
        assert render(s) == pytest.approx(0.3)
