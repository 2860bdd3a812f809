"""The single map's checkpoint file between the two packages: a state the
JAX package saved (its app.save_state) loads in the port's app.load_state,
and one the port saved loads in the JAX package's load_state, at three
configurations (the default layout; the entry grid of use_dense_mips=False;
the keyframe anchor with the directory cache and the saturation gate). The
reference's legacy files (a short tail of arrays, no prealloc stamp) give
the state or the refusal that its loader gives; a wrong array count, dtype
or shape raises and names the field; the port's CLI and viewer resume a
file the JAX package wrote.

Tolerances: every leaf word for word and dtype for dtype, stamps equal;
the frame stepped after a load as tests/test_torch_pipeline.py holds the
step (pose within 1e-4, counts and flags equal, 99% of pixels within
1e-4; with the keyframe anchor, counts within 1%)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from torch_parity import (DEVICE, assert_step_parity, jax_frame, np_state,
                          orbit_frames, port_config, reference_leaf_names,
                          step_both)

from octree_slam_tpu import app as japp
from octree_slam_tpu import pipeline as jpipeline
from octree_slam_tpu.config import SLAMConfig
from octree_slam_tpu_torch import app, convert, pipeline, viewer

# the default layout at the CLI's focal lengths (the CLI test resumes it)
BASE = SLAMConfig(width=64, height=48, pyramid_depth=2, pyramid_iters=(4, 4),
                  voxel_resolution=0.05, max_depth=7,
                  node_capacity=1 << 15, leaf_capacity=1 << 12,
                  insert_unique_cap=1 << 11, max_march_iters=24,
                  precompile_ahead=False)
WIDE = dict(focal_x=55.0, focal_y=55.0)
CONFIGS = {
    "default": BASE,
    "accel_grid": dataclasses.replace(BASE, use_dense_mips=False, **WIDE),
    "features": dataclasses.replace(BASE, track_keyframe=True,
                                    insert_dircache=True,
                                    saturation_gate=True, **WIDE),
}
FRAMES = 3   # two steps before the save, one after


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Per config: the JAX state after two frames, the file its
    save_state wrote, and the stream."""
    out = {}
    for name, cfg in CONFIGS.items():
        stream = orbit_frames(cfg, FRAMES, step_angle=0.01)
        state = jpipeline.init_state(cfg,
                                     initial_pose=jnp.asarray(stream[2][0]))
        for i in range(FRAMES - 1):
            state, _ = jpipeline.step(state, jax_frame(*stream[:2], i), cfg)
        path = str(tmp_path_factory.mktemp(name) / "jax.npz")
        japp.save_state(path, state, cfg)
        out[name] = (state, path, stream)
    return out


def _port_flat(state):
    return app._flatten(convert.state_to_numpy(state))


def _assert_leaves_equal(flat, jstate, where):
    """A port state's fields (by dotted name) against a JAX state's leaves,
    word for word and dtype for dtype."""
    names = reference_leaf_names(jstate)
    assert sorted(flat) == sorted(names), where
    for name, leaf in zip(names, jax.tree_util.tree_leaves(jstate)):
        leaf = np.asarray(leaf)
        assert flat[name].dtype == leaf.dtype, (where, name)
        np.testing.assert_array_equal(flat[name], leaf,
                                      err_msg=f"{where} {name}")


def _rewrite(src, dst, drop=(), **change):
    with np.load(src) as z:
        data = {k: z[k] for k in z.files if k not in drop}
    data.update(change)
    np.savez(dst, **data)
    return dst


@pytest.mark.parametrize("name", list(CONFIGS))
def test_reference_file_loads_in_port(saved, name):
    """Every field word for word, the leaf table in the reference's
    tree_flatten order, the stamps over the caller's capacities, and one
    more frame as the JAX step makes it."""
    jstate, path, stream = saved[name]
    cfg = CONFIGS[name]
    layout = port_config(cfg)
    assert list(convert.slam_state_leaf_names(layout)) \
        == reference_leaf_names(jstate)
    other = dataclasses.replace(layout, node_capacity=1 << 16,
                                leaf_capacity=1 << 10)
    tstate, tcfg = app.load_state(path, other, device=DEVICE)
    assert tcfg == layout
    _assert_leaves_equal(_port_flat(tstate), jstate, name)
    jstate, jo, tstate, to = step_both(jstate, tstate, cfg, tcfg, stream,
                                       FRAMES - 1, "splat")
    assert_step_parity(tstate, to, jstate, jo, f"{name} after the load",
                       exact=not cfg.track_keyframe)


@pytest.mark.parametrize("name", ["default", "features"])
def test_port_file_loads_in_reference(saved, name, tmp_path):
    """The port's file after a frame of its own: the JAX load_state takes
    it unchanged and gets every leaf; its keys and stamps are those of the
    JAX package's file of the same state. Without a cfg both packages
    write `n` and the arrays alone."""
    jstate, _, stream = saved[name]
    cfg = CONFIGS[name]
    tcfg = port_config(cfg)
    tstate = convert.state_from_numpy(np_state(jstate), tcfg, device=DEVICE)
    tstate, _ = pipeline.step(
        tstate, convert.frame_from_numpy(stream[0][-1], stream[1][-1],
                                         device=DEVICE), tcfg)
    mine, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    app.save_state(mine, tstate, tcfg)
    loaded, lcfg = japp.load_state(mine, cfg)
    assert lcfg == cfg
    _assert_leaves_equal(_port_flat(tstate), loaded, name)
    japp.save_state(theirs, loaded, cfg)
    with np.load(mine) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        stamps = [k for k in b.files if not k.startswith("a")]
        assert len(stamps) == 16        # n and the 15 stamps
        for k in stamps:
            assert a[k] == b[k] and a[k].dtype == b[k].dtype, k
    app.save_state(mine, tstate)
    japp.save_state(theirs, loaded)
    with np.load(mine) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        assert int(a["n"]) == len(a.files) - 1
    loaded, _ = japp.load_state(mine, cfg)
    _assert_leaves_equal(_port_flat(tstate), loaded, f"{name} without cfg")


@pytest.mark.parametrize("name,cut", [
    ("default", 1), ("features", 2), ("features", 6),
    ("default", 3),   # no legacy tail without the directory cache
])
def test_legacy_tail_as_reference(saved, tmp_path, name, cut):
    """A file short of its last `cut` arrays: the port's state equals the
    JAX load_state's of the same file (the tail from the template, the
    directory cache reset, the saturation mask rebuilt), or both refuse."""
    jstate, path, _ = saved[name]
    cfg = CONFIGS[name]
    change = {}
    if cfg.saturation_gate:
        # two frames saturate no leaf: half the registry at alpha 255
        # gives the rebuilt mask bits to set
        i = reference_leaf_names(jstate).index("leaves.vals")
        with np.load(path) as z:
            vals = z[f"a{i}"].copy()
        vals[:int(jstate.leaves.count) // 2] |= np.uint32(0xFF000000)
        change[f"a{i}"] = vals
    with np.load(path) as z:
        n = int(z["n"])
    short = _rewrite(path, str(tmp_path / "short.npz"),
                     drop=[f"a{i}" for i in range(n - cut, n)],
                     n=np.asarray(n - cut), **change)
    try:
        jstate, jcfg = japp.load_state(short, cfg)
    except ValueError:
        with pytest.raises(ValueError, match=f"has {n - cut} arrays but the "
                           f"current config expects {n}"):
            app.load_state(short, port_config(cfg), device=DEVICE)
        assert cut == 3 and not cfg.insert_dircache
        return
    tstate, tcfg = app.load_state(short, port_config(cfg), device=DEVICE)
    assert tcfg == port_config(jcfg)
    _assert_leaves_equal(_port_flat(tstate), jstate, f"{name} cut {cut}")
    if cfg.insert_dircache:
        assert bool((tstate.dir_nodes == -1).all())
    if cfg.saturation_gate:
        assert bool((tstate.sat_mask != 0).any())


@pytest.mark.parametrize("capacity", [BASE.node_capacity, 1 << 20])
def test_prestamp_file_as_reference(saved, tmp_path, capacity):
    """A file without the prealloc stamp was laid out under the legacy
    schedule: accepted where it equals this build's (at 2^15 nodes both
    schedules give 4 dense levels), refused where it does not (at 2^20
    nodes: 6 against the legacy 5), by both packages."""
    from octree_slam_tpu_torch.map import svo
    cfg = dataclasses.replace(BASE, node_capacity=capacity)
    path = saved["default"][1]
    if capacity != BASE.node_capacity:
        path = str(tmp_path / "big.npz")
        japp.save_state(path, jpipeline.init_state(cfg), cfg)
    old = _rewrite(path, str(tmp_path / "old.npz"), drop=("prealloc",))
    same = (svo.prealloc_levels_legacy(capacity)
            == svo.prealloc_levels(capacity))
    assert same == (capacity == BASE.node_capacity)
    if not same:
        for load in (lambda: japp.load_state(old, cfg),
                     lambda: app.load_state(old, port_config(cfg),
                                            device=DEVICE)):
            with pytest.raises(ValueError, match="dense-preallocated"):
                load()
        return
    jstate, _ = japp.load_state(old, cfg)
    tstate, _ = app.load_state(old, port_config(cfg), device=DEVICE)
    _assert_leaves_equal(_port_flat(tstate), jstate, "no prealloc stamp")


@pytest.mark.parametrize("fault", ["dtype", "shape"])
def test_wrong_leaf_refused_as_reference(saved, tmp_path, fault):
    """A leaf of another dtype or shape: both packages refuse, and the port
    names the field and its array."""
    jstate, path, _ = saved["default"]
    names = reference_leaf_names(jstate)
    if fault == "dtype":
        i = names.index("pool.value")
        with np.load(path) as z:
            bad = z[f"a{i}"].view(np.int32)
        match = r"field pool.value: stored int32\[32768\] vs expected uint32"
    else:
        i = names.index("last_pyramid.1.normal")
        with np.load(path) as z:
            bad = z[f"a{i}"][:-1]
        match = r"field last_pyramid.1.normal: stored float32\[23, 32, 3\]"
    bad_path = _rewrite(path, str(tmp_path / "bad.npz"), **{f"a{i}": bad})
    with pytest.raises(ValueError):
        japp.load_state(bad_path, CONFIGS["default"])
    with pytest.raises(ValueError, match=match + rf".*\(array a{i}\)"):
        app.load_state(bad_path, port_config(CONFIGS["default"]),
                       device=DEVICE)


def test_cli_and_viewer_resume_reference_file(saved, tmp_path, capsys):
    """The port's CLI resumes a file the JAX package wrote and saves one
    the JAX package loads; the port's viewer flies through it; without a
    card, a load onto the default device raises."""
    jstate, path, _ = saved["default"]
    end = str(tmp_path / "end.npz")
    app.main(["--source", "orbit", "--frames", "2", "--width", "64",
              "--height", "48", "--max-depth", "7", "--resolution", "0.05",
              "--log-every", "0", "--load-state", path, "--save-state", end,
              "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["frames"] == 2 and rec["diverged"] is False
    assert rec["map_nodes"] >= int(jstate.pool.n_nodes)
    resumed, _ = japp.load_state(end, CONFIGS["default"])
    assert int(resumed.frame_idx) == int(jstate.frame_idx) + 2
    assert int(resumed.leaves.count) >= int(jstate.leaves.count) > 0
    n = viewer.main(["--load-state", path, "--out", str(tmp_path / "v"),
                     "--script", "wait 0.2", "--fps", "10", "--width", "64",
                     "--height", "48", "--device", "cpu"])
    assert n == 2 and "wrote 2 flight frames" in capsys.readouterr().out
    if not torch.cuda.is_available():
        # the card is the default device: no fallback to the CPU
        with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
            app.load_state(path, port_config(CONFIGS["default"]))
