"""The 2-D mesh's checkpoint file between the two packages: a sharded
state the JAX package saved (its run2d.save_sharded) loads in the port's
run2d.load_sharded, every shard on its device, and one the port saved
loads in the JAX package's load_sharded; with and without the keyframe
anchor, which the file does not stamp (the caller's cfg says). A file of
another shard count, array count, dtype or shape is refused by both
packages. The JAX side's state is slam_init_2d plus one jitted
insert_sharded (its run_slam_2d compiles the whole 2-D step).

Tolerances: every leaf word for word and dtype for dtype; the keys and
stamps of the two packages' files equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from torch_parity import (DEVICE, port_config, random_cloud,
                          reference_leaf_names, to_t)

from octree_slam_tpu.config import SLAMConfig
from octree_slam_tpu.parallel import distributed as jdist
from octree_slam_tpu.parallel import run2d as jrun2d
from octree_slam_tpu_torch import app, convert
from octree_slam_tpu_torch.parallel import distributed, run2d
from octree_slam_tpu_torch.parallel.distributed import State2D

CFG = SLAMConfig(width=64, height=48, focal_x=55.0, focal_y=55.0,
                 pyramid_depth=2, pyramid_iters=(2, 2),
                 voxel_resolution=0.05, max_depth=6,
                 node_capacity=1 << 15, leaf_capacity=1 << 10,
                 insert_unique_cap=1 << 11, map_split_level=2,
                 relocalize=False)
KEYFRAME = dataclasses.replace(CFG, track_keyframe=True)
M = 2   # map shards


def _jmesh(m=M):
    return jdist.make_mesh(m, axis_name="map")


def _mesh(m=M):
    return distributed.make_mesh(m, axis_name="map", devices=DEVICE)


@pytest.fixture(scope="module")
def smap():
    """The JAX package's sharded map after one insert."""
    mesh = _jmesh()
    pts, cols = random_cloud(3000, 5, lo=-1.0, hi=1.0)
    insert = jax.jit(lambda s, p, c: jdist.insert_sharded(s, p, c, CFG,
                                                          mesh))
    smap, _ = insert(jdist.make_sharded_map(CFG, mesh), jnp.asarray(pts),
                     jnp.asarray(cols))
    return smap


def _jstate(smap, cfg, seed=0):
    """A JAX 2-D state around `smap` whose pyramids and poses hold seeded
    values (slam_init_2d's are INF and identities)."""
    rng = np.random.default_rng(seed)
    st = list(jdist.slam_init_2d(cfg, _jmesh()))

    def noisy(levels):
        return tuple(type(l)(*(jnp.asarray(rng.normal(size=np.shape(x))
                                           .astype(np.float32)) for x in l))
                     for l in levels)
    pose = rng.normal(size=(4, 4)).astype(np.float32)
    st[0], st[1], st[2], st[3] = (noisy(st[0]), jnp.asarray(pose),
                                  jnp.bool_(True), smap)
    if cfg.track_keyframe:
        st[5], st[6] = noisy(st[5]), jnp.asarray(pose + 1)
        st[7] = jnp.asarray(rng.normal(size=(4, 4)).astype(np.float32))
    return tuple(st)


def _assert_leaves_equal(tstate, jstate, where):
    flat = app._flatten(convert.state2d_to_numpy(tstate))
    names = reference_leaf_names(jstate, top=State2D._fields)
    assert sorted(flat) == sorted(names), where
    for name, leaf in zip(names, jax.tree_util.tree_leaves(jstate)):
        leaf = np.asarray(leaf)
        assert flat[name].dtype == leaf.dtype, (where, name)
        np.testing.assert_array_equal(flat[name], leaf,
                                      err_msg=f"{where} {name}")


@pytest.mark.parametrize("cfg", [CFG, KEYFRAME], ids=["plain", "keyframe"])
def test_reference_sharded_file_loads_in_port(smap, tmp_path, cfg):
    """Every leaf word for word, in the leaf table's order; the stamps
    over the caller's capacities; each shard on its device."""
    jstate = _jstate(smap, cfg)
    assert list(convert.state2d_leaf_names(port_config(cfg))) \
        == reference_leaf_names(jstate, top=State2D._fields)
    path = str(tmp_path / "jax.npz")
    jrun2d.save_sharded(path, jstate, cfg)
    other = dataclasses.replace(port_config(cfg), node_capacity=1 << 16,
                                leaf_capacity=1 << 12)
    mesh = _mesh()
    tstate, tcfg = run2d.load_sharded(path, other, mesh)
    assert tcfg == port_config(cfg)
    _assert_leaves_equal(tstate, jstate, "loaded")
    for dev, pool, lv in zip(mesh.axis_devices("map"), tstate.smap.pools,
                             tstate.smap.leaves):
        assert pool.child.device == lv.keys.device == dev


@pytest.mark.parametrize("cfg", [CFG, KEYFRAME], ids=["plain", "keyframe"])
def test_port_sharded_file_loads_in_reference(smap, tmp_path, cfg):
    """The port's file after an insert of its own: the JAX load_sharded
    takes it unchanged and gets every leaf; its keys and stamps are those
    of the JAX package's file of the same state."""
    tcfg = port_config(cfg)
    mesh = _mesh()
    tstate = convert.state2d_from_numpy(
        jax.tree_util.tree_map(np.asarray, _jstate(smap, cfg)), tcfg, mesh)
    pts, cols = random_cloud(2000, 6, lo=-1.0, hi=1.0)
    tsmap, _ = distributed.insert_sharded(tstate.smap, to_t(pts),
                                          to_t(cols), tcfg, mesh)
    tstate = tstate._replace(smap=tsmap)
    mine, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    run2d.save_sharded(mine, tstate, tcfg)
    jstate, jcfg = jrun2d.load_sharded(mine, cfg, _jmesh())
    assert jcfg == cfg
    _assert_leaves_equal(tstate, jstate, "port file")
    jrun2d.save_sharded(theirs, jstate, cfg)
    with np.load(mine) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        stamps = [k for k in b.files if not k.startswith("a")]
        assert len(stamps) == 14        # n and the 13 stamps
        for k in stamps:
            assert a[k] == b[k] and a[k].dtype == b[k].dtype, k


@pytest.mark.parametrize("fault", ["shards", "count", "dtype", "shape",
                                   "keyframe"])
def test_sharded_refusals_as_reference(smap, tmp_path, fault):
    """Both packages refuse a file of another shard count than the mesh's,
    of another array count (one array short; a file without the keyframe
    anchor read with it on), or with a leaf of another dtype or shape; the
    port names what differs."""
    jstate = _jstate(smap, CFG)
    path = str(tmp_path / "jax.npz")
    jrun2d.save_sharded(path, jstate, CFG)
    names = list(convert.state2d_leaf_names(port_config(CFG)))
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}
    cfg, m = CFG, M
    if fault == "shards":
        m, match = 1, "holds 2 map shards but the mesh has 1"
    elif fault == "count":
        data["n"] = np.asarray(len(names) - 1)
        del data[f"a{len(names) - 1}"]
        match = f"has {len(names) - 1} arrays but the current config"
    elif fault == "dtype":
        i = names.index("smap.pool.value")
        data[f"a{i}"] = data[f"a{i}"].view(np.int32)
        match = r"field smap.pool.value: stored int32\[2, 32768\]"
    elif fault == "shape":
        i = names.index("smap.leaves.keys")
        data[f"a{i}"] = data[f"a{i}"][:, :-1]
        match = r"field smap.leaves.keys: stored int32\[2, 1023\]"
    else:
        cfg = KEYFRAME
        match = f"has {len(names)} arrays but the current config expects " \
                f"{len(names) + 3 * CFG.pyramid_depth}"
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, **data)
    with pytest.raises(ValueError):
        jrun2d.load_sharded(bad, cfg, _jmesh(m))
    with pytest.raises(ValueError, match=match):
        run2d.load_sharded(bad, port_config(cfg), _mesh(m))
