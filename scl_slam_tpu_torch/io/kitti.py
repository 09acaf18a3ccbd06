"""KITTI odometry dataset I/O + synthetic LiDAR world generator (a numpy
copy of ``scl_slam_tpu/io/kitti.py``, which the port may not import).

Replaces the reference's rosbag replay harness
(``launch/test_distributed_loop.launch:34-58`` replays KITTI seq 05/08/09
bags with per-robot topic prefixes). Here the velodyne ``.bin`` files and
``poses.txt`` are read directly; multi-robot splits are index ranges over one
sequence, exactly like the reference's 2-way/3-way bag splits.

When no dataset is on disk, :class:`SyntheticWorld` simulates a LiDAR-carrying
robot in a structured random world — used by tests and the benchmark.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np


def read_velodyne_bin(path: str) -> np.ndarray:
    """One KITTI scan: float32 [N, 4] (x, y, z, reflectance) -> [N, 3]."""
    pts = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    return pts[:, :3]


def read_poses_txt(path: str) -> np.ndarray:
    """KITTI ground-truth poses: [N, 3, 4] row-major cam0 poses."""
    rows = np.loadtxt(path, dtype=np.float64)
    return rows.reshape(-1, 3, 4)


def read_calib(path: str) -> np.ndarray:
    """Tr (velo -> cam0) as 4x4 from calib.txt."""
    with open(path) as f:
        for line in f:
            if line.startswith("Tr"):
                vals = np.array(line.split(":")[1].split(), dtype=np.float64)
                T = np.eye(4)
                T[:3, :4] = vals.reshape(3, 4)
                return T
    raise ValueError(f"no Tr line in {path}")


@dataclass
class KittiSequence:
    """Lazy reader over one KITTI odometry sequence directory layout:

    ``<root>/sequences/<seq>/velodyne/*.bin``, ``<root>/poses/<seq>.txt``.
    Poses are converted into the velodyne frame so SLAM output compares
    directly against ground truth.
    """

    root: str
    sequence: str

    def __post_init__(self):
        self.velo_dir = os.path.join(self.root, "sequences", self.sequence, "velodyne")
        self.frames = sorted(
            f for f in os.listdir(self.velo_dir) if f.endswith(".bin")
        )
        pose_path = os.path.join(self.root, "poses", self.sequence + ".txt")
        self.gt_cam = read_poses_txt(pose_path) if os.path.exists(pose_path) else None
        calib_path = os.path.join(
            self.root, "sequences", self.sequence, "calib.txt"
        )
        self.Tr = read_calib(calib_path) if os.path.exists(calib_path) else np.eye(4)

    def __len__(self) -> int:
        return len(self.frames)

    def scan(self, idx: int) -> np.ndarray:
        return read_velodyne_bin(os.path.join(self.velo_dir, self.frames[idx]))

    def gt_pose_velo(self, idx: int) -> np.ndarray | None:
        """4x4 pose of the velodyne frame in the world (velo0) frame."""
        if self.gt_cam is None:
            return None
        Tc = np.eye(4)
        Tc[:3, :4] = self.gt_cam[idx]
        # world_velo = Tr^-1 * cam_pose * Tr
        return np.linalg.inv(self.Tr) @ Tc @ self.Tr


class SyntheticWorld:
    """Simulated structured world + trajectory for tests and benchmarks.

    The world is a set of random landmark clusters ("buildings") on a ground
    plane; a scan at pose T returns world points within ``max_range`` of the
    sensor, expressed in the sensor frame — the same geometry a spinning
    LiDAR would deliver after deskewing.
    """

    def __init__(
        self,
        seed: int = 0,
        extent: float = 200.0,
        n_clusters: int = 120,
        pts_per_cluster: int = 400,
        max_range: float = 60.0,
    ):
        rng = np.random.RandomState(seed)
        centers = rng.uniform(-extent, extent, (n_clusters, 2))
        sizes = rng.uniform(2.0, 12.0, (n_clusters, 2))
        heights = rng.uniform(3.0, 15.0, n_clusters)
        pts = []
        for c, s, h in zip(centers, sizes, heights):
            # sample building SURFACES (4 walls + roof), not volumes — real
            # LiDAR returns lie on surfaces, which is what gives normals and
            # point-to-plane registration something to grip
            n_face = pts_per_cluster // 5
            u = rng.uniform(-1, 1, (n_face, 4))
            zs = rng.uniform(0, h, (n_face, 4))
            walls = [
                np.column_stack([c[0] + u[:, 0] * s[0], np.full(n_face, c[1] - s[1]), zs[:, 0]]),
                np.column_stack([c[0] + u[:, 1] * s[0], np.full(n_face, c[1] + s[1]), zs[:, 1]]),
                np.column_stack([np.full(n_face, c[0] - s[0]), c[1] + u[:, 2] * s[1], zs[:, 2]]),
                np.column_stack([np.full(n_face, c[0] + s[0]), c[1] + u[:, 3] * s[1], zs[:, 3]]),
            ]
            roof_u = rng.uniform(-1, 1, (n_face, 2))
            roof = np.column_stack(
                [c[0] + roof_u[:, 0] * s[0], c[1] + roof_u[:, 1] * s[1],
                 np.full(n_face, h)]
            )
            pts.extend(walls)
            pts.append(roof)
        # ground points
        ground = rng.uniform(-extent, extent, (n_clusters * 100, 2))
        pts.append(
            np.concatenate([ground, np.zeros((len(ground), 1))], axis=1)
        )
        self.world = np.concatenate(pts).astype(np.float32)
        self.max_range = max_range

    def scan_at(self, T: np.ndarray, max_points: int = 8192, seed: int = 0) -> np.ndarray:
        """Points visible from pose T (4x4), in the sensor frame. [M, 3]."""
        rel = self.world - T[:3, 3]
        d = np.linalg.norm(rel[:, :2], axis=1)
        vis = self.world[d < self.max_range]
        # world -> sensor frame
        local = (vis - T[:3, 3]) @ T[:3, :3]
        if len(local) > max_points:
            idx = np.random.RandomState(seed).choice(
                len(local), max_points, replace=False
            )
            local = local[idx]
        return local.astype(np.float32)


def loop_trajectory(
    n_frames: int = 200,
    radius: float = 80.0,
    revisit: bool = True,
    laps: float | None = None,
) -> np.ndarray:
    """A closed circular survey trajectory [N, 4, 4]: ends where it starts,

    optionally continuing past the start (guaranteed loop closures).
    ``laps`` overrides the arc length (e.g. 2.0 = two full revolutions, so
    the whole second lap revisits the first — continuous loop closures,
    the regime where corrections are visible everywhere)."""
    total = 2 * np.pi * (laps if laps else (1.25 if revisit else 1.0))
    out = []
    for k in range(n_frames):
        a = total * k / n_frames
        T = np.eye(4)
        yaw = a + np.pi / 2
        T[:3, :3] = np.array(
            [
                [np.cos(yaw), -np.sin(yaw), 0],
                [np.sin(yaw), np.cos(yaw), 0],
                [0, 0, 1],
            ]
        )
        T[:3, 3] = [radius * np.cos(a), radius * np.sin(a), 1.8]
        out.append(T)
    return np.stack(out)
