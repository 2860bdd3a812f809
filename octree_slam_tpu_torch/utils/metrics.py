"""Trajectory metrics: the reference package's numpy `ate_rmse`, imported as
is (octree_slam_tpu/utils/metrics.py imports numpy only, no jax)."""

from octree_slam_tpu.utils.metrics import ate_rmse

__all__ = ["ate_rmse"]
