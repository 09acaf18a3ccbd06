"""Trajectory export (TUM / KITTI formats) and ATE evaluation (a numpy copy
of the parts of ``scl_slam_tpu/io/trajectory.py`` that the runner uses; the
port may not import it).

Export parity with the reference's ``saveDistributedTrajectoryService``
(``include/distributedMapping.h:1500-1609``): TUM lines
``t x y z qx qy qz qw`` and KITTI 3x4 row-major lines. The reference's TUM
timestamps came from a never-populated vector (``:76,1562``) — here they are
real. Evaluation (external evo/kitti-devkit in the reference workflow) is
built in: Umeyama-aligned ATE RMSE and relative pose error.
"""
from __future__ import annotations

import os

import numpy as np


def _rot_to_quat(R: np.ndarray) -> np.ndarray:
    """3x3 -> (qx, qy, qz, qw), TUM order."""
    w = np.sqrt(max(0.0, 1 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    if w > 1e-6:
        x = (R[2, 1] - R[1, 2]) / (4 * w)
        y = (R[0, 2] - R[2, 0]) / (4 * w)
        z = (R[1, 0] - R[0, 1]) / (4 * w)
    else:  # fall back to dominant-diagonal extraction
        k = int(np.argmax(np.diag(R)))
        i, j = (k + 1) % 3, (k + 2) % 3
        s = np.sqrt(max(1e-12, 1 + R[k, k] - R[i, i] - R[j, j])) * 2
        q = np.zeros(4)
        q[k] = s / 4
        q[i] = (R[i, k] + R[k, i]) / s
        q[j] = (R[j, k] + R[k, j]) / s
        x, y, z = q[:3]
        w = (R[j, i] - R[i, j]) / s
    return np.array([x, y, z, w])


def save_tum(path: str, poses: np.ndarray, stamps: np.ndarray | None = None):
    """poses: [N, 4, 4]; writes ``t x y z qx qy qz qw`` per line."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = len(poses)
    stamps = stamps if stamps is not None else np.arange(n, dtype=np.float64)
    with open(path, "w") as f:
        for k in range(n):
            t = poses[k][:3, 3]
            q = _rot_to_quat(poses[k][:3, :3])
            f.write(
                f"{stamps[k]:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
            )


def save_kitti(path: str, poses: np.ndarray):
    """poses: [N, 4, 4]; writes 3x4 row-major per line."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for T in poses:
            f.write(" ".join(f"{v:.6e}" for v in T[:3, :4].reshape(-1)) + "\n")


def umeyama_align(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Least-squares similarity/rigid alignment est -> gt over [N, 3] points.

    Returns (s, R, t) with gt ~ s * R @ est + t.
    """
    mu_e, mu_g = est.mean(0), gt.mean(0)
    ce, cg = est - mu_e, gt - mu_g
    cov = cg.T @ ce / len(est)
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float(np.trace(np.diag(d) @ S) / (ce ** 2).sum() * len(est)) if with_scale else 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error RMSE (meters) after rigid alignment."""
    est = est_poses[:, :3, 3]
    gt = gt_poses[:, :3, 3]
    if align:
        s, R, t = umeyama_align(est, gt)
        est = (s * (R @ est.T)).T + t
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=1))))
