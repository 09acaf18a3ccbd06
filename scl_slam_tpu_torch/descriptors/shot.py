"""Global SHOT-style descriptor (port of ``scl_slam_tpu/descriptors/shot.py``).

A local reference frame from the cloud's covariance (z the least-variance
axis, x the largest, signs by the cubic mass and the normals), space cut
into azimuth x elevation x radial bins around the centroid, and in each a
histogram of the cosine between the point normals and the frame's z axis;
normalized to 100. Compared like GRSD and FPFH (``geometric.vector_query``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..ops.pointcloud import Cloud, estimate_normals
from .geometric import bin_counts, walk_frames


@dataclass(frozen=True)
class SHOTConfig:
    azimuth_bins: int = 4
    elevation_bins: int = 2
    radial_bins: int = 2
    cos_bins: int = 5          # orientation histogram a spatial bin
    max_radius: float = 80.0
    knn: int = 16
    num_candidates: int = 10
    exclude_recent: int = 30
    distance_threshold: float = 50.0

    @property
    def dim(self) -> int:
        return self.azimuth_bins * self.elevation_bins * self.radial_bins * self.cos_bins


class SHOT(NamedTuple):
    descriptor: torch.Tensor    # [..., dim]


def shot_one(xyz: torch.Tensor, mask: torch.Tensor, normals: torch.Tensor,
             cfg: SHOTConfig) -> torch.Tensor:
    """One cloud's SHOT [dim] from its normals [N, 3]. The x axis's sign
    sums the cube of every point's coordinate, padded ones too, as the JAX
    module does."""
    w = mask.to(xyz.dtype)
    n_pts = torch.clamp(torch.sum(w), min=1.0)
    centroid = torch.sum(xyz * w[:, None], dim=0) / n_pts
    centered = xyz - centroid
    cov = torch.einsum("ni,n,nj->ij", centered, w, centered) / n_pts
    vecs = torch.linalg.eigh(cov).eigenvectors
    z_axis, x_axis = vecs[:, 0], vecs[:, 2]
    x_axis = x_axis * torch.where(torch.sum((centered @ x_axis) ** 3) < 0, -1.0, 1.0)
    z_axis = z_axis * torch.where(torch.sum(normals @ z_axis) < 0, -1.0, 1.0)
    y_axis = torch.linalg.cross(z_axis, x_axis, dim=-1)

    px = centered @ x_axis
    py = centered @ y_axis
    pz = centered @ z_axis
    r = torch.sqrt(px * px + py * py + pz * pz)
    az = torch.atan2(py, px)
    a_bin = torch.clamp(
        ((az + math.pi) / (2 * math.pi) * cfg.azimuth_bins).to(torch.int32),
        0, cfg.azimuth_bins - 1,
    )
    el = pz / torch.clamp(r, min=1e-6)
    e_bin = torch.clamp(
        ((el + 1.0) * 0.5 * cfg.elevation_bins).to(torch.int32), 0, cfg.elevation_bins - 1
    )
    r_bin = torch.clamp(
        (torch.sqrt(torch.clamp(r / cfg.max_radius, max=1.0)) * cfg.radial_bins).to(torch.int32),
        0, cfg.radial_bins - 1,
    )
    cos_n = normals @ z_axis
    c_bin = torch.clamp(
        ((cos_n + 1.0) * 0.5 * cfg.cos_bins).to(torch.int32), 0, cfg.cos_bins - 1
    )
    flat = (
        ((a_bin * cfg.elevation_bins + e_bin) * cfg.radial_bins + r_bin) * cfg.cos_bins + c_bin
    )
    valid = mask & (r < cfg.max_radius)
    hist = bin_counts(flat, valid, cfg.dim).to(xyz.dtype)
    return hist / torch.clamp(valid.sum(), min=1) * 100.0


def shot_make(cloud: Cloud, cfg: SHOTConfig) -> SHOT:
    """SHOT of clouds [..., N, 3] -> [..., dim] (normals from the ``knn``
    nearest neighbours)."""
    return SHOT(walk_frames(
        cloud,
        lambda xyz, mask: shot_one(
            xyz, mask, estimate_normals(Cloud(xyz, mask), k=cfg.knn), cfg
        ),
    ))
