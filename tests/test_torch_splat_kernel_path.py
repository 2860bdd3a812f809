"""Which path the splat's z-buffer takes (render/splat.py `_splat_kernel`)
and the checks of the splat kernel's wrapper (render/splat_ops.py), on the
CPU: run_slam's splat frames, a recovery pyramid and the sharded splat run
the plain version and count `splat_eager` once a call, never
`splat_kernel`, and launch nothing; a CUDA device takes the kernel; the
wrapper raises on a wrong dtype, shape, layout, depth or device before it
builds or launches anything; the kernel library's loader binds
`oslam_splat_zbuffer` where the library has it and loads a library built
from an older source without it. The kernel itself runs only on the card
(tests/test_torch_cuda_splat_kernel.py).

Tolerances: none; counts are compared exactly."""

import ctypes
import os
import subprocess

import pytest
import torch

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from test_torch_band_stage import CFG, FRAMES, orbit  # noqa: F401

from octree_slam_tpu_torch import _build, app, pipeline, relocalize
from octree_slam_tpu_torch.parallel import distributed
from octree_slam_tpu_torch.render import splat_ops
from octree_slam_tpu_torch.utils import spans


@pytest.fixture(autouse=True)
def _recorder_off():
    spans.stop()
    yield
    spans.stop()


def test_cpu_runs_the_plain_path_on_every_splat_frame(orbit):
    """run_slam at render_every 2: every splat frame counts splat_eager
    once and no splat_kernel; no kernel launch."""
    frames, poses = orbit
    before = dict(splat_ops.LAUNCHES)
    spans.start()
    app.run_slam(lambda i: frames[i], FRAMES, CFG, initial_pose=poses[0],
                 device="cpu", render_every=2, render_mode="splat")
    rec = spans.stop()
    assert rec.frames == list(range(FRAMES))
    assert rec.counter("splat_eager") == {i: int(i % 2 == 0)
                                          for i in rec.frames}
    assert set(rec.counter("splat_kernel").values()) == {0}
    assert splat_ops.LAUNCHES == before


@pytest.mark.parametrize("device,kernel", [("cuda", True), ("cpu", False)])
def test_which_path_the_zbuffer_takes(device, kernel):
    """_splat_kernel decides by the device alone."""
    from octree_slam_tpu_torch.render import splat
    assert splat._splat_kernel(torch.device(device)) is kernel


def test_recovery_and_shards_take_the_plain_path(orbit):
    """A recovery's model pyramid counts splat_eager once, the sharded
    splat once a shard; no launch."""
    frames, poses = orbit
    state = pipeline.init_state(CFG, initial_pose=poses[0], device="cpu")
    for f in frames[:2]:
        state, _ = pipeline.step(state, f, CFG, render="none")
    lv = state.leaves
    before = dict(splat_ops.LAUNCHES)
    spans.start()
    with spans.frame(0):
        relocalize.model_pyramid(lv, state.pool.center, state.pool.half_size,
                                 state.pose, CFG)
        buf = distributed._zbuffer_sharded(
            [lv.vals] * 2, [lv.keys, torch.full_like(lv.keys, -1)],
            state.pool.center, state.pool.half_size, state.pose,
            CFG.focal_x, CFG.focal_y, CFG)
    c = spans.stop().counters[0]
    assert c["splat_eager"] == 3 and "splat_kernel" not in c
    assert splat_ops.LAUNCHES == before
    assert int((buf != splat_ops.DEPTH_INF).sum()) > 100


def _inputs(n=8):
    """Valid splat_zbuffer arguments on the CPU, as (args, kwargs)."""
    keys = torch.arange(n, dtype=torch.int32)
    args = dict(vals=torch.zeros(n, dtype=torch.int32), keys=keys,
                count=torch.tensor(n, dtype=torch.int32),
                center=torch.zeros(3), half_size=torch.tensor(1.0),
                world_T_cam=torch.eye(4), fx=50.0, fy=50.0)
    return args, dict(width=64, height=48, depth=6)


@pytest.mark.parametrize("fault,error,match", [
    ("keys_f32", TypeError, "keys of torch.int32"),
    ("vals_i64", TypeError, "vals of torch.int32"),
    ("keys_strided", ValueError, "keys must be contiguous"),
    ("count_i64", TypeError, "count of torch.int32"),
    ("count_shape", ValueError, "count of shape"),
    ("center_f64", TypeError, "center of torch.float32"),
    ("half_size_shape", ValueError, "half_size of shape"),
    ("pose_f64", TypeError, "world_T_cam f32"),
    ("depth_11", ValueError, "depth 11"),
    ("cpu", ValueError, "expected CUDA tensors"),
])
def test_the_wrapper_raises(fault, error, match):
    """Each wrong argument raises before anything is built or launched; a
    valid call on CPU tensors raises for the device."""
    args, kw = _inputs()
    change = {
        "keys_f32": lambda: args.update(keys=args["keys"].float()),
        "vals_i64": lambda: args.update(vals=args["vals"].long()),
        "keys_strided": lambda: args.update(
            keys=torch.zeros(16, dtype=torch.int32)[::2]),
        "count_i64": lambda: args.update(count=args["count"].long()),
        "count_shape": lambda: args.update(count=args["count"][None]),
        "center_f64": lambda: args.update(center=args["center"].double()),
        "half_size_shape": lambda: args.update(half_size=torch.ones(1)),
        "pose_f64": lambda: args.update(
            world_T_cam=args["world_T_cam"].double()),
        "depth_11": lambda: kw.update(depth=11),
        "cpu": lambda: None,
    }[fault]
    change()
    before = dict(splat_ops.LAUNCHES)
    lib = _build._lib
    with pytest.raises(error, match=match):
        splat_ops.splat_zbuffer(**args, **kw)
    assert splat_ops.LAUNCHES == before
    assert _build._lib is lib


# the launchers every kernel library has, as stubs; `extra` adds more
_STUBS = """
extern "C" {
int oslam_bilateral7x7() { return 0; }
int oslam_gated_pyramid5x5() { return 0; }
const char* oslam_error_string(int) { return "stub"; }
%s
}
"""


def test_loader_binds_splat_zbuffer_where_the_library_has_it(tmp_path):
    """A library from an older source, with neither band_march nor
    splat_zbuffer, loads and has no splat launcher; one with
    oslam_splat_zbuffer gets its 21 argument types bound."""
    cxx = os.environ.get("CXX", "g++")
    libs = {}
    for name, extra in (("old", ""),
                        ("new", "int oslam_splat_zbuffer() { return 0; }")):
        src = tmp_path / f"{name}.cpp"
        src.write_text(_STUBS % extra)
        libs[name] = tmp_path / f"lib{name}.so"
        subprocess.run([cxx, "-shared", "-fPIC", "-o", str(libs[name]),
                        str(src)], check=True, capture_output=True)
    saved, saved_launchers = _build._lib, dict(_build._launchers)
    try:
        old = _build.load(libs["old"])
        assert not hasattr(old, "oslam_splat_zbuffer")
        with pytest.raises(AttributeError):
            _build.launcher(splat_ops.KERNEL)
        new = _build.load(libs["new"])
        fn = _build.launcher(splat_ops.KERNEL)
        assert fn is new.oslam_splat_zbuffer
        assert len(fn.argtypes) == 21 and fn.restype is ctypes.c_int
    finally:
        _build._lib = saved
        _build._launchers.clear()
        _build._launchers.update(saved_launchers)
