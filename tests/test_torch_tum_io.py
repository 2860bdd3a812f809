"""Port parity for ingest and output (the PNG codec against PIL is in
tests/test_torch_png.py): the TUM reader's
association and ground truth against the JAX package's TUMDataset, the
text files (trajectory, ground truth and listings) byte for byte against
the JAX package's writers on the same poses, the port's CLI on a written
sequence, and a feeder whose decode raises.

Tolerance: exact (pixels, association pairs, text bytes, map size);
ground-truth poses within 1e-6; the CLI runs' poses within 1e-4 and ATEs
within 1e-4 m of each other."""

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from torch_parity import yield_cpu  # noqa: F401 (autouse fixture)
from torch_parity import DEVICE

from octree_slam_tpu.io import tum as jtum
from octree_slam_tpu_torch import app
from octree_slam_tpu_torch.io import png, tum

REPO = Path(__file__).resolve().parents[1]


def _jax_writer():
    spec = importlib.util.spec_from_file_location(
        "make_tum_sequence", REPO / "examples" / "make_tum_sequence.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def sequences(tmp_path_factory):
    """The same 4-frame 64x48 sequence written by the JAX package's
    example writer and by the port's, on the JAX writer's poses."""
    from octree_slam_tpu.sensor import sources as jsources
    root = tmp_path_factory.mktemp("tum")
    jroot = _jax_writer().write_sequence(str(root / "jax"), 4, 64, 48)
    poses = [np.asarray(jsources.orbit_pose(i * 0.01, radius=2.0))
             for i in range(4)]
    troot = tum.write_sequence(str(root / "port"), 4, 64, 48, poses=poses,
                               device=DEVICE)
    return jroot, troot


def test_sequence_text_files_equal_reference(sequences):
    jroot, troot = sequences
    for name in ("depth.txt", "rgb.txt", "groundtruth.txt"):
        assert (Path(troot) / name).read_bytes() == \
            (Path(jroot) / name).read_bytes(), name


def test_sequence_images_match_reference(sequences):
    jroot, troot = sequences
    jd, td = tum.TUMDataset(jroot, device=DEVICE), \
        tum.TUMDataset(troot, device=DEVICE)
    for i in range(len(jd)):
        (_, fd), (_, fr) = jd.pairs[i]
        for f, tol in ((fd, 5), (fr, 1)):
            a = np.asarray(Image.open(os.path.join(jroot, f))).astype(int)
            b = png.read_png(os.path.join(troot, f)).astype(int)
            # the two packages' renderers agree to 1 mm / 1 level
            assert np.abs(a - b).max() <= tol and (a != b).mean() < 0.01


def test_association_and_ground_truth_match_reference(sequences):
    jroot, _ = sequences
    jd = jtum.TUMDataset(jroot, max_frames=3)
    td = tum.TUMDataset(jroot, max_frames=3, device=DEVICE)
    assert td.pairs == jd.pairs and len(td) == 3
    for i in range(3):
        np.testing.assert_allclose(td.gt_pose(i), jd.gt_pose(i), atol=1e-6)
        f = td.frame(i)
        j = jd.frame(i)
        np.testing.assert_array_equal(f.depth.numpy(), np.asarray(j.depth))
        np.testing.assert_array_equal(f.color.numpy(), np.asarray(j.color))
        assert float(f.timestamp) == float(j.timestamp)
    frames = list(td.prefetched())
    assert len(frames) == 3
    for f, i in zip(frames, range(3)):
        np.testing.assert_array_equal(f.depth.numpy(),
                                      td.frame(i).depth.numpy())
        assert f.color.dtype == torch.uint8 and f.depth.dtype == torch.int32
    # a list of association edge cases
    a = [(0.0, "a"), (0.05, "b"), (0.1, "c"), (0.3, "d")]
    b = [(0.011, "x"), (0.04, "y"), (0.095, "z"), (0.2, "w")]
    assert tum._associate(a, b) == jtum._associate(a, b)


def test_trajectory_writer_equals_reference(tmp_path):
    rng = np.random.default_rng(2)
    poses = []
    for k in range(6):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        x, y, z, w = q
        R = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                       2 * (x * z + y * w)],
                      [2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                       2 * (y * z - x * w)],
                      [2 * (x * z - y * w), 2 * (y * z + x * w),
                       1 - 2 * (x * x + y * y)]])
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = rng.normal(size=3)
        poses.append(T.astype(np.float32))
    for ts in (None, [1305031102.1 + k / 30 for k in range(6)]):
        tum.write_trajectory(str(tmp_path / "t.txt"), poses, timestamps=ts)
        jtum.write_trajectory(str(tmp_path / "j.txt"), poses, timestamps=ts)
        assert (tmp_path / "t.txt").read_bytes() == \
            (tmp_path / "j.txt").read_bytes()
    back = tum._read_groundtruth(str(tmp_path / "t.txt"))
    for (t, T), P in zip(back, poses):
        np.testing.assert_allclose(T, P, atol=2e-6)


def test_cli_on_written_sequence(tmp_path, capsys):
    """Both packages' CLIs on one written sequence: the same trajectory.
    At 64x48 the TUM focal length leaves a 7-degree view, so the ATE is
    held to the JAX package's, not to the full-size bound."""
    from octree_slam_tpu import app as japp
    root = tum.write_sequence(str(tmp_path / "seq"), 6, 64, 48,
                              device=DEVICE)
    args = ["--source", "tum", "--tum-root", root, "--frames", "6",
            "--width", "64", "--height", "48", "--max-depth", "7",
            "--resolution", "0.04", "--log-every", "0",
            "--no-precompile-ahead", "--save-trajectory"]
    japp.main(args + [str(tmp_path / "j.txt")])
    jrec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    app.main(args + [str(tmp_path / "t.txt"), "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec.keys() == jrec.keys()
    assert rec["frames"] == jrec["frames"] == 6
    assert rec["diverged"] is jrec["diverged"] is False
    assert abs(rec["ate_rmse"] - jrec["ate_rmse"]) < 1e-4
    assert rec["map_nodes"] == jrec["map_nodes"]
    est = tum._read_groundtruth(str(tmp_path / "t.txt"))
    ref = tum._read_groundtruth(str(tmp_path / "j.txt"))
    assert [t for t, _ in est] == [t for t, _ in ref]
    for (_, T), (_, R) in zip(est, ref):
        np.testing.assert_allclose(T, R, atol=1e-4)
    ds = tum.TUMDataset(root, device=DEVICE)
    assert [t for t, _ in est] == pytest.approx(
        [ds.pairs[i][0][0] for i in range(6)], abs=1e-6)


def test_feeder_failure_reaches_the_consumer(tmp_path):
    """A decode that raises in the feeder thread ends the consumer's loop
    with that exception (no hang)."""
    root = tum.write_sequence(str(tmp_path / "seq"), 4, 32, 24,
                              device=DEVICE)
    ds = tum.TUMDataset(root, device=DEVICE)
    os.remove(os.path.join(root, ds.pairs[2][0][1]))   # frame 2's depth
    got = []
    import threading
    result = {}

    def consume():
        try:
            for f in ds.prefetched(ahead=2):
                got.append(f)
        except FileNotFoundError as e:
            result["error"] = e

    th = threading.Thread(target=consume, daemon=True)
    th.start()
    th.join(timeout=60)
    assert not th.is_alive(), "the consumer hangs"
    assert "error" in result and len(got) == 2
