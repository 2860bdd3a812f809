"""Trajectory metrics (counterpart: octree_slam_tpu/utils/metrics.py), in
numpy: poses come back from the device once per run."""

from __future__ import annotations

import numpy as np


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray,
             align: bool = False) -> float:
    """ATE-RMSE over trajectories of [N, 4, 4] world_T_cam matrices.

    With align=True, applies the closed-form SE(3) alignment (Horn/Umeyama
    without scale) before computing the error, as in the TUM benchmark tools.
    """
    p_est = np.asarray(est_poses)[:, :3, 3]
    p_gt = np.asarray(gt_poses)[:, :3, 3]
    if align:
        mu_e = p_est.mean(0)
        mu_g = p_gt.mean(0)
        H = (p_est - mu_e).T @ (p_gt - mu_g)
        U, _, Vt = np.linalg.svd(H)
        S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
        R = Vt.T @ S @ U.T
        t = mu_g - R @ mu_e
        p_est = p_est @ R.T + t
    err = p_est - p_gt
    return float(np.sqrt(np.mean(np.sum(err * err, axis=-1))))


def rpe(est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1):
    """Relative pose error over `delta` frames: (translation RMSE,
    rotation RMSE in radians)."""
    est = np.asarray(est_poses)
    gt = np.asarray(gt_poses)
    n = est.shape[0] - delta
    t_err = []
    r_err = []
    for i in range(n):
        de = np.linalg.inv(est[i]) @ est[i + delta]
        dg = np.linalg.inv(gt[i]) @ gt[i + delta]
        e = np.linalg.inv(dg) @ de
        t_err.append(np.linalg.norm(e[:3, 3]))
        c = np.clip((np.trace(e[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        r_err.append(np.arccos(c))
    return (float(np.sqrt(np.mean(np.square(t_err)))),
            float(np.sqrt(np.mean(np.square(r_err)))))
