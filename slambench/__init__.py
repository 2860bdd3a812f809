"""The benchmark of the PyTorch and CUDA port (octree_slam_tpu_torch) on
one NVIDIA H100: `python3 slambench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` from the root of a checkout."""
