"""octree-slam-tpu on PyTorch + CUDA: the track -> fuse -> splat slice.

A second package beside the JAX reference `octree_slam_tpu`, laid out file
for file opposite it (each module's docstring names its counterpart). It
imports torch and numpy, never jax; the only modules it takes from the
reference package are the two that are free of jax: `config.SLAMConfig`
(so one config object drives both packages and their capacities and node
indices line up) and `utils.metrics`.

The slice covers `pipeline.init_state` and `pipeline.step` for
render="splat" and render="none". Both sensor stencils of the reference
(the 7x7 bilateral filter and the 5x5 gated subsample) run as hand-written
CUDA kernels for sm_90a (`csrc/sensor_stencils.cu`, bound in
`sensor/cuda_ops.py`); every other op is plain PyTorch. On CPU tensors the
kernel wrappers run their plain PyTorch versions instead.

Config branches outside the slice raise NotImplementedError (see
`pipeline.check_supported`).
"""

from octree_slam_tpu.config import SLAMConfig

__all__ = ["SLAMConfig"]
