"""Live map viewer in the terminal (counterpart:
octree_slam_tpu/live_viewer.py).

The reference's GLFW main loop polls the keyboard and mouse, re-renders the
map every tick and prints the frame rate in the window title
(main.cpp:47,68-78,115-124, glfw_camera_controller.cpp:38-106). Here the
loop runs in the terminal:

  * the framebuffer draws as 24-bit ANSI half blocks (U+2580: two image
    rows a character cell, foreground = top pixel, background = bottom);
  * the keyboard is read raw (termios cbreak + select): W/S/A/D move, R/F
    rise / sink, arrows look, +/- zoom, TAB switches splat <-> cone, Q
    quits;
  * the status line carries the live frame rate, where the reference
    put it in the window title.

The camera is camera_controller.update, as in viewer.py; the views are the
SLAM renderers (render_splat, conesplat.render_cone_splat) on the map
state's device.

    python -m octree_slam_tpu_torch.live_viewer --load-state map.npz
    python -m octree_slam_tpu_torch.live_viewer     # synthetic-orbit map

LiveViewer.feed(keys) + .tick() is the tty-free core; only main() touches
termios.
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from typing import Tuple

import numpy as np

from octree_slam_tpu_torch import viewer
from octree_slam_tpu_torch.render import camera_controller as fly

# key -> CameraInputs field delta (a held key arrives as autorepeat)
_MOVES = {
    "w": ("forward", 1.0), "s": ("forward", -1.0),
    "d": ("strafe", 1.0), "a": ("strafe", -1.0),
    "r": ("rise", 1.0), "f": ("rise", -1.0),
    "UP": ("drag_y", 1.0), "DOWN": ("drag_y", -1.0),
    "LEFT": ("drag_x", 1.0), "RIGHT": ("drag_x", -1.0),
    "+": ("scroll", -2.0), "-": ("scroll", 2.0),
}

_CSI_KEYS = {"A": "UP", "B": "DOWN", "C": "RIGHT", "D": "LEFT"}


def decode_keys(raw: bytes) -> list:
    """Decode a raw stdin chunk into key tokens ('w', 'UP', 'q', ...)."""
    keys = []
    i = 0
    while i < len(raw):
        b = raw[i]
        if b == 0x1B and i + 2 < len(raw) and raw[i + 1:i + 2] == b"[":
            tok = _CSI_KEYS.get(chr(raw[i + 2]))
            if tok:
                keys.append(tok)
            i += 3
            continue
        ch = chr(b)
        keys.append(ch.lower() if ch.isalpha() else ch)
        i += 1
    return keys


def ansi_frame(rgb8: np.ndarray, home: bool = True) -> str:
    """u8[H, W, 3] (H even) as truecolour half-block rows. A cell reuses
    the previous SGR when both colours repeat, so flat regions cost one
    byte a cell."""
    h, w, _ = rgb8.shape
    top = rgb8[0::2]
    bot = rgb8[1::2]
    out = ["\x1b[H"] if home else []
    for y in range(h // 2):
        row = []
        last = None
        for x in range(w):
            fg = (int(top[y, x, 0]), int(top[y, x, 1]), int(top[y, x, 2]))
            bg = (int(bot[y, x, 0]), int(bot[y, x, 1]), int(bot[y, x, 2]))
            if (fg, bg) != last:
                row.append("\x1b[38;2;%d;%d;%d;48;2;%d;%d;%dm" % (fg + bg))
                last = (fg, bg)
            row.append("▀")
        row.append("\x1b[0m\n")
        out.append("".join(row))
    return "".join(out)


class LiveViewer:
    """tty-free interactive core: feed keys, tick, get frames."""

    def __init__(self, pool, leaves, cfg, *, width: int, height: int,
                 mode: str = "splat",
                 start: fly.FlyCameraState | None = None):
        assert height % 2 == 0, "half-block drawing needs an even height"
        self.pool, self.leaves, self.cfg = pool, leaves, cfg
        self.width, self.height = width, height
        self.mode = mode
        self.quit = False
        self._pending: dict = {}
        self.state = start if start is not None else viewer.start_state(pool)
        self._spec = viewer.slab_spec(cfg, pool, width, height,
                                      self._focal())

    def _focal(self) -> float:
        return (self.height / 2.0
                / math.tan(math.radians(self.state.fov) / 2.0))

    def feed(self, keys) -> None:
        """Accumulate key tokens for the next tick."""
        for k in keys:
            if k == "q":
                self.quit = True
            elif k == "\t":
                self.mode = "cone" if self.mode == "splat" else "splat"
            elif k in _MOVES:
                field, amount = _MOVES[k]
                self._pending[field] = self._pending.get(field, 0.0) + amount

    def tick(self, dt: float = 0.1) -> np.ndarray:
        """Integrate the pending inputs and render one frame, f32[H, W, 4]
        on the host. Drags and scrolls apply per event, moves as m/s * dt,
        the GLFW handler's split (glfw_camera_controller.cpp:69-80)."""
        p = self._pending
        self._pending = {}
        inp = fly.CameraInputs(
            forward=p.get("forward", 0.0), strafe=p.get("strafe", 0.0),
            rise=p.get("rise", 0.0),
            drag_x=0.35 * p.get("drag_x", 0.0),
            drag_y=0.35 * p.get("drag_y", 0.0),
            scroll=p.get("scroll", 0.0))
        self.state = fly.update(self.state, inp, dt)
        pose = viewer.sensor_pose(self.state, self.width / self.height)
        fb = viewer.render_view(self.pool, self.leaves, self.cfg, pose,
                                self._focal(), self.mode, self._spec,
                                self.width, self.height)
        return fb.cpu().numpy()

    def status(self, fps: float) -> str:
        """The reference's title-bar line (main.cpp:68-78)."""
        x, y, z = self.state.position
        return ("\x1b[0m octree-slam-tpu | %4.1f fps | %s | "
                "pos (%.2f %.2f %.2f) yaw %.2f pitch %.2f fov %.0f | "
                "WASD move RF rise arrows look +- zoom TAB mode Q quit\x1b[K"
                % (fps, self.mode, x, y, z, self.state.yaw,
                   self.state.pitch, self.state.fov))


def pick_size(cols: int, rows: int) -> Tuple[int, int]:
    """The largest render size that fits the terminal: a character column
    a pixel, two image rows a text row (less the status line), cut to
    multiples of 8 (the slab cone's scales divide them)."""
    w = max(32, (cols // 8) * 8)
    h = max(32, ((2 * (rows - 2)) // 8) * 8)
    return w, h


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="live terminal map viewer")
    p.add_argument("--load-state", type=str, default=None,
                   help="SLAM state .npz from the app's --save-state")
    p.add_argument("--mode", choices=["splat", "cone"], default="splat")
    p.add_argument("--fps", type=float, default=15.0, help="tick rate cap")
    p.add_argument("--max-depth", type=int, default=9)
    p.add_argument("--resolution", type=float, default=0.02)
    p.add_argument("--node-capacity", type=int, default=1 << 20)
    p.add_argument("--orbit-frames", type=int, default=8,
                   help="without --load-state: frames of synthetic orbit "
                        "SLAM that build the map to fly through")
    p.add_argument("--ticks", type=int, default=0,
                   help="exit after N ticks (0 = until Q)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cpu for a run without a card)")
    args = p.parse_args(argv)
    import shutil

    from octree_slam_tpu_torch import app
    from octree_slam_tpu_torch.config import SLAMConfig

    dev = app.resolve_device(args.device)
    size = shutil.get_terminal_size((100, 40))
    w, h = pick_size(size.columns, size.lines)
    cfg = SLAMConfig(width=w, height=h, focal_x=0.8 * w, focal_y=0.8 * w,
                     max_depth=args.max_depth,
                     voxel_resolution=args.resolution,
                     node_capacity=args.node_capacity,
                     leaf_capacity=args.node_capacity >> 3)
    if args.load_state:
        state, cfg = app.load_state(args.load_state, cfg, device=dev)
    else:
        build = SLAMConfig(width=320, height=240, focal_x=265.0,
                           focal_y=265.0, max_depth=args.max_depth,
                           voxel_resolution=args.resolution,
                           node_capacity=args.node_capacity,
                           leaf_capacity=args.node_capacity >> 3)
        state, cfg = viewer.orbit_map(build, args.orbit_frames, dev)
    live = LiveViewer(state.pool, state.leaves, cfg, width=w, height=h,
                      mode=args.mode)

    interactive = sys.stdin.isatty()
    if interactive:
        import termios
        import tty
        fd = sys.stdin.fileno()
        saved = termios.tcgetattr(fd)
        tty.setcbreak(fd)
    sys.stdout.write("\x1b[2J\x1b[?25l")  # clear, hide the cursor
    fps = 0.0
    n = 0
    try:
        while not live.quit:
            t0 = time.perf_counter()
            if interactive:
                import os
                import select
                while select.select([sys.stdin], [], [], 0)[0]:
                    live.feed(decode_keys(os.read(fd, 64)))
            fb = live.tick(dt=1.0 / args.fps)
            rgb8 = np.clip(fb[..., :3] * 255.0, 0, 255).astype(np.uint8)
            sys.stdout.write(ansi_frame(rgb8))
            sys.stdout.write(live.status(fps))
            sys.stdout.flush()
            n += 1
            if args.ticks and n >= args.ticks:
                break
            dt = time.perf_counter() - t0
            if dt < 1.0 / args.fps:
                time.sleep(1.0 / args.fps - dt)
            fps = 1.0 / max(time.perf_counter() - t0, 1e-6)
    finally:
        sys.stdout.write("\x1b[0m\x1b[?25h\n")
        sys.stdout.flush()
        if interactive:
            termios.tcsetattr(fd, termios.TCSADRAIN, saved)
    return n


if __name__ == "__main__":
    main()
