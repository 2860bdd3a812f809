"""A cell of the benchmark cut to a size the CPU runs in seconds: 160x120
frames, depth 7 at 4 cm, a 40-frame loop, 2 warm-up frames. Only for the
tests: the benchmark's cells are never cut."""

from slambench import harness

SEED = 3141592653


def small_cell(name: str = "kinect1cm_splat.orbit") -> harness.Cell:
    c = harness.load_cell(name)
    slam = dict(c.slam)
    slam.update(width=160, height=120, focal_x=532.57 / 4,
                focal_y=531.54 / 4, voxel_resolution=0.04, max_depth=7,
                node_capacity=1 << 16, leaf_capacity=1 << 14,
                insert_unique_cap=4096)
    if "cone_band_cap" in slam:
        slam["cone_band_cap"] = 3600
    c.config = dict(c.config, slam=slam)
    c.traffic = dict(c.traffic, warmup_frames=2, frames_per_loop=40)
    return c


def run_small(name: str = "kinect1cm_splat.orbit", trace: bool = False,
              frames: int = 6, control: bool = False, seed: int = SEED):
    return harness.run_cell(small_cell(name), seed, 1000.0, trace,
                            device="cpu", max_frames=frames,
                            control=control, log=lambda m: None)
