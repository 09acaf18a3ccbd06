"""M2DP descriptor (port of ``scl_slam_tpu/descriptors/m2dp.py``).

The cloud aligned to its principal axes, projected onto 4 azimuth x 16
elevation view planes, a 16-theta x 8-rho polar histogram a view, and the
first left (64) and right (128) singular vectors of that 64 x 128 signature
as a 192-D unit vector. Retrieval is the plain-vector L2 query
(``geometric.vector_query``); M2DP gives no yaw.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..ops.pointcloud import Cloud
from .geometric import bin_counts, walk_frames


@dataclass(frozen=True)
class M2DPConfig:
    num_t: int = 16          # theta bins
    num_r: int = 8           # rho bins
    num_p: int = 4           # azimuth view angles
    num_q: int = 16          # elevation view angles
    max_rho: float = 80.0
    num_candidates: int = 10
    exclude_recent: int = 30
    distance_threshold: float = 0.25   # L2 on unit-norm 192-vectors

    @property
    def dim(self) -> int:
        return self.num_p * self.num_q + self.num_t * self.num_r


class M2DP(NamedTuple):
    descriptor: torch.Tensor   # [..., num_p*num_q + num_t*num_r]


def _pca_align(xyz: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """One cloud centred and rotated into its principal axes (largest
    first), each axis's sign such that the cubes of the coordinates sum to
    >= 0; invalid points land at the origin."""
    w = mask.to(xyz.dtype)
    n = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(xyz * w[:, None], dim=0) / n
    c = (xyz - mean) * w[:, None]
    cov = c.T @ c / n
    axes = torch.flip(torch.linalg.eigh(cov).eigenvectors, dims=(-1,))
    proj = c @ axes
    sign = torch.where(torch.sum(proj ** 3, dim=0) < 0, -1.0, 1.0)
    return proj * sign[None, :]


def m2dp_one(xyz: torch.Tensor, mask: torch.Tensor, cfg: M2DPConfig) -> torch.Tensor:
    aligned = _pca_align(xyz, mask)
    dev = xyz.device
    p_angles = math.pi * torch.arange(cfg.num_p, device=dev) / cfg.num_p
    q_angles = math.pi / 2 * torch.arange(1, cfg.num_q + 1, device=dev) / cfg.num_q
    az, el = torch.meshgrid(p_angles, q_angles, indexing="ij")
    az, el = az.reshape(-1), el.reshape(-1)                    # [V]
    nrm = torch.stack(
        [torch.cos(el) * torch.cos(az), torch.cos(el) * torch.sin(az), torch.sin(el)], -1
    )                                                          # [V, 3]
    up = torch.tensor([0.0, 0.0, 1.0], device=dev)
    side = torch.tensor([1.0, 0.0, 0.0], device=dev)
    ref = torch.where((torch.abs(nrm[:, 2]) < 0.9)[:, None], up, side)
    u = torch.linalg.cross(nrm, ref, dim=-1)
    u = u / torch.sqrt(torch.sum(u * u, dim=-1, keepdim=True))
    v = torch.linalg.cross(nrm, u, dim=-1)
    pu = aligned @ u.T                                         # [N, V]
    pv = aligned @ v.T
    rho = torch.sqrt(pu * pu + pv * pv)
    theta = torch.atan2(pv, pu)
    tb = torch.clamp(
        ((theta + math.pi) / (2 * math.pi) * cfg.num_t).to(torch.int32), 0, cfg.num_t - 1
    )
    rb = torch.clamp(
        (torch.sqrt(torch.clamp(rho / cfg.max_rho, max=1.0)) * cfg.num_r).to(torch.int32),
        0, cfg.num_r - 1,
    )
    V, TR = nrm.shape[0], cfg.num_t * cfg.num_r
    flat = torch.arange(V, device=dev) * TR + tb * cfg.num_r + rb   # [N, V]
    hist = bin_counts(flat, mask[:, None].expand_as(flat), V * TR).reshape(V, TR)
    A = hist.to(xyz.dtype) / torch.clamp(torch.sum(mask.to(xyz.dtype)), min=1.0)
    U, _, Vh = torch.linalg.svd(A, full_matrices=False)
    d = torch.cat([U[:, 0], Vh[0, :]])
    d = d * torch.where(torch.sum(U[:, 0]) < 0, -1.0, 1.0)    # the SVD's sign
    return d / torch.clamp(torch.sqrt(torch.sum(d * d)), min=1e-9)


def make(cloud: Cloud, cfg: M2DPConfig) -> M2DP:
    """M2DP of clouds [..., N, 3] -> [..., dim]."""
    return M2DP(walk_frames(cloud, lambda xyz, mask: m2dp_one(xyz, mask, cfg)))
