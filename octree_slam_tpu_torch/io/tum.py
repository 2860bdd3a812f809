"""TUM RGB-D dataset replay and writer (counterpart:
octree_slam_tpu/io/tum.py, and examples/make_tum_sequence.py for
`write_sequence`).

Layout (vision.in.tum.de/data/datasets/rgbd-dataset): rgb.txt and
depth.txt list "timestamp filename", groundtruth.txt "timestamp tx ty tz
qx qy qz qw"; depth PNGs are 16-bit at 5000 units per metre, so
mm = value / 5. PNGs decode through the native runtime (io/native.py:
libpng, and its threaded prefetcher in `prefetched`) where it builds, else
with the port's own codec (io/png.py); both give the same bytes.

`TUMDataset.prefetched` decodes frames in a feeder thread `ahead` frames in
front of the consumer and uploads each as one packed u8 buffer (depth as
u16 little-endian bytes, then rgb): a pinned host buffer, one non-blocking
copy, a split on the device; with packed=False as two such buffers, depth
and rgb, the reference's per-array path. The feeder always ends its queue,
with a sentinel or with the exception that stopped it, which the consumer
raises.
"""

from __future__ import annotations

import os
import pathlib
import queue
import threading
from typing import List, Tuple

import numpy as np
import torch

from octree_slam_tpu_torch.core.types import Frame
from octree_slam_tpu_torch.io import native
from octree_slam_tpu_torch.io.png import read_png, write_png

DEPTH_FACTOR_TO_MM = 5.0  # TUM: 5000 per metre; the sensor path wants mm


def pack_frame(depth_mm: np.ndarray, rgb: np.ndarray) -> np.ndarray:
    """One u8[H*W*5] ingest buffer: depth as u16 little-endian bytes, then
    rgb."""
    return np.concatenate([depth_mm.astype("<u2").view(np.uint8).ravel(),
                           rgb.ravel()])


def _frame_of(depth_bytes: torch.Tensor, rgb: torch.Tensor, ts: float, *,
              h: int, w: int) -> Frame:
    """Depth as u16 little-endian bytes and rgb bytes, on the device ->
    Frame (depth as int32 mm)."""
    d = depth_bytes.view(h * w, 2).to(torch.int32)
    return Frame(depth=(d[:, 0] | (d[:, 1] << 8)).view(h, w),
                 color=rgb.view(h, w, 3),
                 timestamp=torch.full((), ts, dtype=torch.float32,
                                      device=rgb.device))


def _read_png(path: str) -> np.ndarray:
    """A PNG through the native runtime's libpng where it builds and reads
    the file, else through the port's codec, which names the fault of a
    file that neither reads (a missing one raises FileNotFoundError)."""
    if native.available():
        try:
            return native.read_png(path)
        except OSError:
            pass
    return read_png(path)


def _read_list(path: str) -> List[Tuple[float, str]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1]))
    return out


def _read_groundtruth(path: str) -> List[Tuple[float, np.ndarray]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(x) for x in line.split()]
            t, tx, ty, tz, qx, qy, qz, qw = vals[:8]
            n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
            qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
            R = np.array([
                [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
                 2 * (qx * qz + qy * qw)],
                [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
                 2 * (qy * qz - qx * qw)],
                [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
                 1 - 2 * (qx * qx + qy * qy)],
            ])
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = R
            T[:3, 3] = [tx, ty, tz]
            out.append((t, T))
    return out


def _associate(a: List[Tuple[float, str]], b: List[Tuple[float, str]],
               max_dt: float = 0.02):
    """Nearest-timestamp association (the TUM associate.py algorithm)."""
    pairs = []
    bi = 0
    for ta, fa in a:
        while bi + 1 < len(b) and abs(b[bi + 1][0] - ta) <= abs(b[bi][0] - ta):
            bi += 1
        if abs(b[bi][0] - ta) <= max_dt:
            pairs.append(((ta, fa), b[bi]))
    return pairs


class TUMDataset:
    """Replay source over a TUM RGB-D sequence directory; frames land on
    `device`. Intrinsics default to the TUM fr1 calibration."""

    FX, FY, CX, CY = 517.3, 516.5, 318.6, 255.3

    def __init__(self, root: str, max_frames: int | None = None,
                 device="cuda"):
        self.root = root
        self.device = torch.device(device)
        rgb = _read_list(os.path.join(root, "rgb.txt"))
        depth = _read_list(os.path.join(root, "depth.txt"))
        self.pairs = _associate(depth, rgb)
        if max_frames:
            self.pairs = self.pairs[:max_frames]
        gt_path = os.path.join(root, "groundtruth.txt")
        self.groundtruth = (_read_groundtruth(gt_path)
                            if os.path.exists(gt_path) else [])

    def __len__(self):
        return len(self.pairs)

    def decode(self, i: int):
        """Frame i on the host: (depth u16[H, W] mm, rgb u8[H, W, 3],
        timestamp)."""
        (td, fd), (_, fr) = self.pairs[i]
        depth_raw = _read_png(os.path.join(self.root, fd))
        color = _read_png(os.path.join(self.root, fr))
        if color.ndim == 2:
            color = np.repeat(color[..., None], 3, axis=-1)
        depth_mm = depth_raw.astype(np.float32) / DEPTH_FACTOR_TO_MM
        depth_mm = np.clip(depth_mm, 0, 65535).astype(np.uint16)
        return depth_mm, np.ascontiguousarray(color[..., :3]), td

    def frame(self, i: int) -> Frame:
        depth_mm, color, td = self.decode(i)
        return Frame(
            depth=torch.from_numpy(depth_mm.astype(np.int32)).to(self.device),
            color=torch.from_numpy(color).to(self.device),
            timestamp=torch.full((), td, dtype=torch.float32,
                                 device=self.device))

    def prefetched(self, n_threads: int = 3, capacity: int = 8,
                   packed: bool = True, ahead: int = 2):
        """Generator of Frames decoded and uploaded by a feeder thread
        `ahead` frames in front of the consumer; ahead=0 decodes in the
        caller's thread. Each frame is one packed upload, or with
        packed=False two, depth and rgb (see the module docstring); the
        frames are the same either way. On a card the host buffers are
        pinned, one set per frame in flight, each reused only after its
        copies' event has completed. With the native runtime the PNGs
        decode in its threaded prefetcher (native/src/prefetch.cpp) on
        `n_threads` threads holding up to `capacity` decoded frames, the
        feeder's source. The reference's signature; without the native
        runtime the reference decodes in the caller's thread, the port
        in its feeder."""
        if not self.pairs:
            return
        cuda = self.device.type == "cuda"
        pf = None
        if native.available():
            h, w = self.decode(0)[0].shape
            pf = native.FramePrefetcher(
                [os.path.join(self.root, fd) for (_, fd), _ in self.pairs],
                [os.path.join(self.root, fr) for _, (_, fr) in self.pairs],
                w, h, depth_to_mm=1.0 / DEPTH_FACTOR_TO_MM,
                n_threads=n_threads, capacity=capacity)

        def decoded(i: int):
            if pf is None:
                return self.decode(i)
            try:
                nxt = pf.next()
            except OSError:
                # decode it alone: the pure codec names the fault (a
                # missing file raises FileNotFoundError)
                return self.decode(i)
            if nxt is None:
                raise IOError(f"the prefetcher ended before frame {i}")
            return nxt[0], nxt[1], self.pairs[i][0][0]
        slots = ahead + 2
        pinned: list = [None] * slots
        events: list = [None] * slots

        def to_device(i: int, parts) -> list:
            if not cuda:
                return [torch.from_numpy(p).to(self.device) for p in parts]
            k = i % slots
            if events[k] is not None:
                events[k].synchronize()
            if pinned[k] is None or [b.numel() for b in pinned[k]] != [
                    p.size for p in parts]:
                pinned[k] = [torch.empty(p.size, dtype=torch.uint8,
                                         pin_memory=True) for p in parts]
            bufs = []
            for host, p in zip(pinned[k], parts):
                host.numpy()[:] = p
                bufs.append(host.to(self.device, non_blocking=True))
            events[k] = torch.cuda.Event()
            events[k].record()
            return bufs

        def upload(i: int) -> Frame:
            depth_mm, rgb, ts = decoded(i)
            h, w = depth_mm.shape
            if packed:
                (buf,) = to_device(i, [pack_frame(depth_mm, rgb)])
                d, c = buf[:2 * h * w], buf[2 * h * w:]
            else:
                d, c = to_device(i, [
                    depth_mm.astype("<u2").view(np.uint8).ravel(),
                    np.ascontiguousarray(rgb).ravel()])
            return _frame_of(d, c, ts, h=h, w=w)

        if ahead <= 0:
            try:
                for i in range(len(self.pairs)):
                    yield upload(i)
            finally:
                if pf is not None:
                    pf.close()
            return

        q: "queue.Queue" = queue.Queue(maxsize=ahead)
        stop = threading.Event()
        end = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def feeder():
            last = end
            try:
                for i in range(len(self.pairs)):
                    if not put(upload(i)):
                        return
            except Exception as e:   # handed to the consumer, which raises
                last = e
            finally:
                put(last)

        th = threading.Thread(target=feeder, daemon=True,
                              name="tum-feeder")
        th.start()
        try:
            while True:
                item = q.get()
                if item is end:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            th.join()
            if pf is not None:
                pf.close()

    def gt_pose(self, i: int) -> np.ndarray | None:
        """Ground-truth world_T_cam nearest to frame i's timestamp."""
        if not self.groundtruth:
            return None
        t = self.pairs[i][0][0]
        times = np.array([g[0] for g in self.groundtruth])
        j = int(np.argmin(np.abs(times - t)))
        return self.groundtruth[j][1]


def rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (qx, qy, qz, qw), Shepperd's branch-stable
    method (the inverse of the ground-truth parser)."""
    R = np.asarray(R, np.float64)
    tr = R[0, 0] + R[1, 1] + R[2, 2]
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        qw = (R[2, 1] - R[1, 2]) / s
        qx = 0.25 * s
        qy = (R[0, 1] + R[1, 0]) / s
        qz = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        qw = (R[0, 2] - R[2, 0]) / s
        qx = (R[0, 1] + R[1, 0]) / s
        qy = 0.25 * s
        qz = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        qw = (R[1, 0] - R[0, 1]) / s
        qx = (R[0, 2] + R[2, 0]) / s
        qy = (R[1, 2] + R[2, 1]) / s
        qz = 0.25 * s
    return np.array([qx, qy, qz, qw], np.float64)


def write_trajectory(path: str, poses, timestamps=None) -> None:
    """world_T_cam poses in the TUM trajectory format ('timestamp tx ty tz
    qx qy qz qw' a line), for the TUM benchmark tools and evo; timestamps
    default to the frame index in seconds."""
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for i, T in enumerate(poses):
            T = np.asarray(T, np.float64)
            t = float(timestamps[i]) if timestamps is not None else float(i)
            q = rotmat_to_quat(T[:3, :3])
            f.write("%.6f %.6f %.6f %.6f %.6f %.6f %.6f %.6f\n"
                    % (t, T[0, 3], T[1, 3], T[2, 3], q[0], q[1], q[2], q[3]))


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (qx, qy, qz, qw), the synthetic sequence
    writer's form (largest diagonal element when the trace is not
    positive)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                         (R[1, 0] - R[0, 1]) / s, 0.25 * s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k]) * 2
    q = np.zeros(4)
    q[i] = 0.25 * s
    q[3] = (R[k, j] - R[j, k]) / s
    q[j] = (R[j, i] + R[i, j]) / s
    q[k] = (R[k, i] + R[i, k]) / s
    return q


def write_sequence(out: str, n_frames: int = 30, width: int = 640,
                   height: int = 480, poses=None, device="cuda") -> str:
    """Write the synthetic orbit as a TUM-format sequence: 16-bit depth
    PNGs at 5000 units per metre, 8-bit RGB PNGs, depth.txt / rgb.txt with
    clocks 11 ms apart (so the association has work) and groundtruth.txt.
    Frames are rendered by sensor/sources on `device` at the TUM
    intrinsics; `poses` (world_T_cam, [n, 4, 4]) replaces the orbit."""
    from octree_slam_tpu_torch.sensor import sources
    root = pathlib.Path(out)
    (root / "depth").mkdir(parents=True, exist_ok=True)
    (root / "rgb").mkdir(parents=True, exist_ok=True)
    scene = sources.default_scene(device)
    fx, fy = TUMDataset.FX, TUMDataset.FY
    d_lines, r_lines, g_lines = [], [], []
    t0 = 1305031102.175304  # fr1-style epoch timestamps
    for i in range(n_frames):
        t = t0 + i / 30.0
        pose = (sources.orbit_pose(i * 0.01, radius=2.0, device=device)
                if poses is None
                else torch.from_numpy(np.array(poses[i], np.float32)).to(
                    device))
        f = sources.render_frame(scene, pose, fx, fy, width=width,
                                 height=height)
        depth_tum = np.clip(f.depth.cpu().numpy().astype(np.float64) * 5.0,
                            0, 65535).astype(np.uint16)
        dname = f"depth/{t:.6f}.png"
        rname = f"rgb/{t + 0.011:.6f}.png"
        write_png(str(root / dname), depth_tum)
        write_png(str(root / rname), f.color.cpu().numpy())
        d_lines.append(f"{t:.6f} {dname}")
        r_lines.append(f"{t + 0.011:.6f} {rname}")
        p = pose.cpu().numpy()
        q = _rot_to_quat(p[:3, :3])
        tr = p[:3, 3]
        g_lines.append(f"{t:.6f} {tr[0]:.6f} {tr[1]:.6f} {tr[2]:.6f} "
                       f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}")
    hdr = "# synthetic orbit sequence in TUM RGB-D format\n"
    (root / "depth.txt").write_text(hdr + "\n".join(d_lines) + "\n")
    (root / "rgb.txt").write_text(hdr + "\n".join(r_lines) + "\n")
    (root / "groundtruth.txt").write_text(hdr + "\n".join(g_lines) + "\n")
    return str(root)
