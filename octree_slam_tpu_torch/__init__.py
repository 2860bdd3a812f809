"""octree-slam-tpu on PyTorch + CUDA: track -> fuse -> render, with the
splat, slab-cone, exact-march and hybrid renderers.

A second package beside the JAX reference `octree_slam_tpu`, laid out file
for file opposite it (each module's docstring names its counterpart). It
imports torch and numpy, never jax, and nothing of the reference package:
it keeps its own copies of what it needs from there (`config.SLAMConfig`,
field for field the reference's, and `utils.metrics.ate_rmse`).

It covers `pipeline.init_state` and the whole of `pipeline.step`:
render="splat", "cone" (the slab cone), "cone_march" (the exact march over
the dense mirror of `map/mips.py`, or over the node pool when
use_dense_mips is off), "cone_hybrid" (the slab cone with its edge band
marched, `render/hybrid.py`) and "none", lazy and eager interiors, the
keyframe anchor, the saturation gate, the photometric term, the insert's
directory cache, the caller-driven pager (`pipeline.insert_remainder`) and
`pipeline.heal_for_march`. Around the step it has the app loop
(`app.run_slam` with growth, host tiering, relocalization and checkpoints
in the JAX package's own file, and the CLI, `python -m octree_slam_tpu_torch.app`), TUM replay
(`io/tum.py`: the repo's native libpng runtime through `io/native.py`
where it builds, else its own PNG codec, `io/png.py`) and the `Octree`
facade (`map/octree.py`). The multi-device path is the reference's
single-controller design on a mesh of torch devices (`parallel/`: the
row-sharded pyramid and tracker, the Morton-range-sharded map, the 2-D
mesh's app loop `run2d.run_slam_2d` and its tiering). The offline and interactive paths are ported too: mesh
I/O (`io/obj.py`, `io/bmp.py`), the voxelizer and its A-buffer
(`map/voxelization.py`), the point, voxel-splat and triangle rasterizers
(`render/points.py`, `render/raster.py`), `render/renderer.Renderer`,
`scene.Scene`, the fly camera and both viewers (`viewer.py`,
`live_viewer.py`), and the CLI's `--save-mesh`. Both
sensor stencils of the reference (the bilateral filter, 7x7 or of any
other window size, and the 5x5 gated subsample) run as hand-written CUDA
kernels for sm_90a (`csrc/sensor_stencils.cu`, bound in
`sensor/cuda_ops.py`); every other op
is plain PyTorch, as the reference reaches no TPU kernel anywhere else. On
CPU tensors the kernel wrappers run their plain PyTorch versions instead.

The entry points that make tensors (`pipeline.init_state`, `svo.create`,
`mips.create`, `splat.create_leaf_list`, the `sources` constructors, the
`convert` readers, `app.run_slam`, `app.load_state`, `app.main`'s
`--device`, `io.tum.TUMDataset`, `map.octree.Octree`, `scene.Scene`, the
mesh and texture readers, `core.camera.make_camera`, the viewers'
`--device` and the meshes of `parallel.distributed`) put them on the card unless the caller names another device,
as the CPU tests do; without a card they raise.

`pipeline.check_supported` raises where the reference's step does: for an
unknown render, and for the hybrid without the dense mirror. The
hybrid's band knobs and the slab cone's three composite modes are ported
with the rest (`render/hybrid.py`, `render/conesplat.py`).
"""

from octree_slam_tpu_torch.config import SLAMConfig

__all__ = ["SLAMConfig"]
