"""Map and constraint exports (port of ``scl_slam_tpu/io/export.py``,
numpy only, copied so that both packages write the same bytes): the
rviz-topic/PCD-file replacements.

The reference publishes a global-map PointCloud2, loop-closure MarkerArray
(spheres + lines, ``include/distributedMapping.h:1388-1447``) and writes PCD
keypose files on the save service (``:1591-1592``). Headless equivalents:
PLY/PCD point-cloud writers and a JSON loop-constraint dump any viewer can
consume.
"""
from __future__ import annotations

import json
import os

import numpy as np


def save_ply(path: str, xyz: np.ndarray, colors: np.ndarray | None = None):
    """ASCII PLY point cloud. colors: optional [N, 3] uint8."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = len(xyz)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write(
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            )
        f.write("end_header\n")
        for i in range(n):
            row = f"{xyz[i,0]:.4f} {xyz[i,1]:.4f} {xyz[i,2]:.4f}"
            if colors is not None:
                row += f" {colors[i,0]} {colors[i,1]} {colors[i,2]}"
            f.write(row + "\n")


def save_pcd(path: str, xyz: np.ndarray):
    """ASCII PCD v0.7 (the reference's keypose export format)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = len(xyz)
    with open(path, "w") as f:
        f.write(
            "# .PCD v0.7 - Point Cloud Data file format\n"
            "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
            f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA ascii\n"
        )
        for p in xyz:
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")


def load_pcd(path: str) -> np.ndarray:
    pts = []
    with open(path) as f:
        in_data = False
        for line in f:
            if in_data:
                pts.append([float(v) for v in line.split()[:3]])
            elif line.startswith("DATA"):
                in_data = True
    return np.asarray(pts, np.float32)


def save_loop_constraints(path: str, loops: list[dict]):
    """JSON dump of loop constraints: the MarkerArray analog.

    Each entry: {"i": slot, "j": slot, "pi": [x,y,z], "pj": [x,y,z],
    "kind": "intra"|"inter", "noise": float}.
    """
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump({"loop_constraints": loops}, f, indent=1)
