"""GRSD and FPFH global descriptors and the plain-vector DB they share
(port of ``scl_slam_tpu/descriptors/geometric.py``).

GRSD: per-point radius-based surface estimates from a brute-force k-NN
(``ops.pointcloud.knn_indices``) and the covariance normals, classified on a
dense voxel grid, then a histogram of the class transitions between
neighbouring voxels. FPFH: the SPFH signature (Darboux-frame angle
histograms) of the point nearest the centroid. Both are compared by L2
against an absolute gate (``vector_query``). The makes take clouds
[..., N, 3] and walk the frames (the JAX module vmaps single clouds); the
k-NN is their dominant cost.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..ops.pointcloud import (
    PAD_VALUE, Cloud, covariance_normals, estimate_normals, knn_indices, smallest_k,
)
from . import base


class Vector(NamedTuple):
    """A plain-vector descriptor [..., D] (GRSD, FPFH, SHOT, M2DP): the
    vector is its own retrieval key and its wire format."""

    descriptor: torch.Tensor


def bin_counts(bins: torch.Tensor, keep: torch.Tensor, n: int) -> torch.Tensor:
    """Integer counts [n] of the kept entries of ``bins`` (values in [0,
    n)): a scatter-add into a spare last bin, exact and without a host
    read."""
    idx = torch.where(keep, bins.long(), n).reshape(-1)
    out = torch.zeros((n + 1,), dtype=torch.int64, device=bins.device)
    return out.scatter_add_(0, idx, torch.ones_like(idx))[:n]


def walk_frames(cloud: Cloud, make_one) -> torch.Tensor:
    """``make_one(xyz [N, 3], mask [N]) -> [D]`` over clouds [..., N, 3] ->
    [..., D]."""
    lead, n = cloud.xyz.shape[:-2], cloud.xyz.shape[-2]
    outs = [make_one(x, m) for x, m in zip(cloud.xyz.reshape(-1, n, 3),
                                           cloud.mask.reshape(-1, n))]
    return torch.stack(outs).reshape(*lead, -1)


# ---------------------------------------------------------------------------
# GRSD
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GRSDConfig:
    num_bins: int = 21        # the GRSD histogram's size
    knn: int = 16
    num_candidates: int = 10
    exclude_recent: int = 30
    distance_threshold: float = 160.0
    voxel_width: float = 2.0  # the grid's voxel (the search radius)
    extent_xy: float = 80.0   # the grid covers [-extent, extent) per axis
    extent_z: float = 16.0
    rsd_subdiv: int = 5       # alpha bins of the RSD radius estimate


# RSD surface-class thresholds (metres) over the local min/max surface radius
_PLANE_RADIUS = 0.2        # radius cap: r -> min(r, cap); a plane has r = cap
_MIN_RADIUS_PLANE = 0.1    # r_min above this => plane
_MIN_RADIUS_CYLINDER = 0.175   # r_max above this (r_min small) => cylinder
_MAX_RADIUS_NOISE = 0.015  # r_min below this => noise/corner
_MAX_MIN_RADIUS_DIFF = 0.05    # r_max - r_min below this => sphere
_CLS_EMPTY = 5             # free-space voxel class (6 classes -> 21 pairs)


class GRSD(NamedTuple):
    descriptor: torch.Tensor    # [..., 21]


def _knn_normals(xyz: torch.Tensor, mask: torch.Tensor, k: int):
    """One cloud's k-NN (invalid points at PAD_VALUE) and covariance
    normals, unoriented: (idx [N, k], nbrs [N, k, 3], normals [N, 3]). RSD
    reads the same neighbourhoods again, so they are computed once."""
    pts = torch.where(mask[:, None], xyz, PAD_VALUE)
    idx = knn_indices(pts, k)
    nbrs = pts[idx]
    return idx, nbrs, covariance_normals(nbrs)


def rsd_from_neighbours(xyz, mask, idx, nbrs, normals, cfg: GRSDConfig):
    """Per-point RSD min/max surface radius from the k-NN of one cloud: for
    each neighbour, the arc model d = r alpha (d the distance, alpha the
    angle between the normals) binned in ``rsd_subdiv`` bins of alpha, the
    largest d a bin, and the extrema of d_max(alpha) / alpha over the bins,
    capped at the plane radius. Returns (r_min [N], r_max [N], ok [N])."""
    pts = torch.where(mask[:, None], xyz, PAD_VALUE)
    diff = nbrs - pts[:, None, :]
    sq = diff * diff
    d = torch.sqrt((sq[..., 0] + sq[..., 1]) + sq[..., 2])        # [N, k]
    cosang = torch.abs(torch.einsum("ni,nki->nk", normals, normals[idx]))
    alpha = torch.arccos(torch.clamp(cosang, 0.0, 1.0))          # [0, pi/2]
    valid = mask[:, None] & mask[idx] & (d > 1e-6) & (d <= cfg.voxel_width)
    nb = cfg.rsd_subdiv
    b = torch.clamp((alpha / (math.pi / 2.0) * nb).to(torch.int32), 0, nb - 1)
    w = valid[..., None] & (b[..., None] == torch.arange(nb, device=xyz.device))
    dmax = torch.where(w, d[..., None], -math.inf).amax(dim=1)  # [N, nb]
    bin_ok = w.any(dim=1)
    centers = (torch.arange(nb, device=xyz.device, dtype=d.dtype) + 0.5) * (math.pi / 2.0) / nb
    r = torch.clamp(dmax / centers, max=_PLANE_RADIUS)
    r_min = torch.where(bin_ok, r, math.inf).amin(dim=1)
    r_max = torch.where(bin_ok, r, -math.inf).amax(dim=1)
    pt_ok = bin_ok.any(dim=1) & mask
    return torch.where(pt_ok, r_min, 0.0), torch.where(pt_ok, r_max, 0.0), pt_ok


# the 13 positive-lexicographic voxel offsets: half the 26-neighbourhood,
# each unordered neighbour pair once
_OFFSETS = tuple(
    (dx, dy, dz)
    for dx in (-1, 0, 1)
    for dy in (-1, 0, 1)
    for dz in (-1, 0, 1)
    if (dz, dy, dx) > (0, 0, 0)
)


def grsd_histogram(xyz, r_min, r_max, ok, cfg: GRSDConfig) -> torch.Tensor:
    """One cloud's GRSD from its per-point radii: the radii averaged on a
    dense ``voxel_width`` grid, each occupied voxel classed as noise,
    plane, cylinder, sphere or rim (free voxels class 5), and the class
    transitions between each voxel and its 26-neighbourhood counted in the
    21 unordered class pairs, free-free pairs skipped. Returns [num_bins]
    (raw counts)."""
    w = cfg.voxel_width
    gx = int(round(2.0 * cfg.extent_xy / w))
    gz = int(round(2.0 * cfg.extent_z / w))
    ix = torch.floor((xyz[:, 0] + cfg.extent_xy) / w).to(torch.int32)
    iy = torch.floor((xyz[:, 1] + cfg.extent_xy) / w).to(torch.int32)
    iz = torch.floor((xyz[:, 2] + cfg.extent_z) / w).to(torch.int32)
    inb = (ix >= 0) & (ix < gx) & (iy >= 0) & (iy < gx) & (iz >= 0) & (iz < gz) & ok
    flat = torch.where(inb, (ix * gx + iy) * gz + iz, 0).long()
    nv = gx * gx * gz
    wgt = inb.to(xyz.dtype)
    zeros = torch.zeros((nv,), dtype=xyz.dtype, device=xyz.device)
    cnt = zeros.index_add(0, flat, wgt)
    s_min = zeros.index_add(0, flat, r_min * wgt)
    s_max = zeros.index_add(0, flat, r_max * wgt)
    occ = cnt > 0
    vmin = s_min / torch.clamp(cnt, min=1.0)
    vmax = s_max / torch.clamp(cnt, min=1.0)
    # the first condition that holds decides (jnp.select): applied last
    cls = torch.full((nv,), 4, dtype=torch.int64, device=xyz.device)   # rim/edge
    cls = torch.where((vmax - vmin) < _MAX_MIN_RADIUS_DIFF, 3, cls)     # sphere
    cls = torch.where(vmin < _MAX_RADIUS_NOISE, 0, cls)                 # noise
    cls = torch.where(vmax > _MIN_RADIUS_CYLINDER, 2, cls)              # cylinder
    cls = torch.where(vmin > _MIN_RADIUS_PLANE, 1, cls)                 # plane
    cls = torch.where(~occ, _CLS_EMPTY, cls).reshape(gx, gx, gz)
    occ3 = occ.reshape(gx, gx, gz)
    dims = (gx, gx, gz)
    ax = [torch.arange(n, device=xyz.device) for n in dims]
    ax = [ax[0][:, None, None], ax[1][None, :, None], ax[2][None, None, :]]
    counts = torch.zeros((21,), dtype=torch.int64, device=xyz.device)
    for off in _OFFSETS:
        shift = tuple(-o for o in off)
        nb_cls = torch.roll(cls, shift, dims=(0, 1, 2))
        nb_occ = torch.roll(occ3, shift, dims=(0, 1, 2))
        keep = occ3 | nb_occ                                   # skip free-free pairs
        for a, o in enumerate(off):
            if o == 1:
                keep = keep & (ax[a] < dims[a] - 1)
            elif o == -1:
                keep = keep & (ax[a] > 0)
        lo = torch.minimum(cls, nb_cls)
        hi = torch.maximum(cls, nb_cls)
        pair = lo * 6 - (lo * (lo - 1)) // 2 + (hi - lo)       # 6 classes -> 21 pairs
        counts += bin_counts(pair, keep, 21)
    hist = torch.zeros((cfg.num_bins,), dtype=xyz.dtype, device=xyz.device)
    m = min(21, cfg.num_bins)
    hist[:m] = counts[:m].to(xyz.dtype)
    return hist


def grsd_make(cloud: Cloud, cfg: GRSDConfig) -> GRSD:
    """GRSD of clouds [..., N, 3] -> [..., num_bins]."""

    def one(xyz, mask):
        idx, nbrs, normals = _knn_normals(xyz, mask, cfg.knn)
        r_min, r_max, ok = rsd_from_neighbours(xyz, mask, idx, nbrs, normals, cfg)
        return grsd_histogram(xyz, r_min, r_max, ok, cfg)

    return GRSD(walk_frames(cloud, one))


# ---------------------------------------------------------------------------
# FPFH (the SPFH of the point nearest the centroid)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FPFHConfig:
    num_bins: int = 11        # bins an angle (3 angles -> 33-D)
    knn: int = 64             # the centre point's neighbourhood
    num_candidates: int = 10
    exclude_recent: int = 30
    distance_threshold: float = 100.0


class FPFH(NamedTuple):
    descriptor: torch.Tensor    # [..., 33]


def fpfh_one(xyz: torch.Tensor, mask: torch.Tensor, normals: torch.Tensor,
             cfg: FPFHConfig) -> torch.Tensor:
    """One cloud's FPFH from its normals [N, 3]: the Darboux-frame angles
    (alpha, phi, theta) between the centre point's normal and each of its
    ``knn`` neighbours', 3 histograms normalized to 100 each."""
    pts = torch.where(mask[:, None], xyz, PAD_VALUE)
    w = mask.to(pts.dtype)
    centroid = torch.sum(pts * w[:, None], dim=0) / torch.clamp(torch.sum(w), min=1.0)
    center_idx = torch.argmin(torch.sum((pts - centroid) ** 2, dim=-1))
    p_c = pts[center_idx]
    n_c = normals[center_idx]
    nbr = smallest_k(torch.sum((pts - p_c) ** 2, dim=-1), cfg.knn)
    p_k = pts[nbr]
    n_k = normals[nbr]
    diff = p_k - p_c
    dist = torch.clamp(torch.sqrt(torch.sum(diff * diff, dim=-1)), min=1e-9)
    unit = diff / dist[:, None]
    u = n_c
    v = torch.linalg.cross(unit, u.expand_as(unit), dim=-1)
    v = v / torch.clamp(torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True)), min=1e-9)
    wv = torch.linalg.cross(u.expand_as(v), v, dim=-1)
    alpha = torch.sum(v * n_k, dim=-1)
    phi = torch.sum(u * unit, dim=-1)
    theta = torch.atan2(torch.sum(wv * n_k, dim=-1), torch.sum(u * n_k, dim=-1))
    valid = mask[nbr] & (nbr != center_idx)
    nb = cfg.num_bins

    def hist(vals, lo, hi):
        b = torch.clamp(((vals - lo) / (hi - lo) * nb).to(torch.int32), 0, nb - 1)
        return bin_counts(b, valid, nb).to(pts.dtype)

    h = torch.cat([hist(alpha, -1.0, 1.0), hist(phi, -1.0, 1.0),
                   hist(theta, -math.pi, math.pi)])
    return h / torch.clamp(valid.sum(), min=1) * 100.0


def fpfh_make(cloud: Cloud, cfg: FPFHConfig) -> FPFH:
    """FPFH of clouds [..., N, 3] -> [..., 3 num_bins] (normals from the
    16 nearest neighbours)."""
    return FPFH(walk_frames(
        cloud,
        lambda xyz, mask: fpfh_one(
            xyz, mask, estimate_normals(Cloud(xyz, mask), k=16), cfg
        ),
    ))


# ---------------------------------------------------------------------------
# the plain-vector DB (GRSD, FPFH, SHOT, M2DP)
# ---------------------------------------------------------------------------


def make_db(capacity: int, dim: int, device) -> base.DescriptorDB:
    return base.make_db(capacity, (dim,), dim, device)


def insert(db: base.DescriptorDB, d: Vector, robot: int, index: int, pos: int):
    return base.db_insert(db, d.descriptor, d.descriptor, robot, index, pos)


def vector_query(
    db: base.DescriptorDB,
    desc: torch.Tensor,
    query_robot,
    query_index: torch.Tensor,
    num_candidates: int,
    exclude_recent: int,
    threshold: float,
    mode: str = "inter",
) -> base.Match:
    """1-NN detection with an absolute L2 gate for B queries desc [B, D]:
    the ``num_candidates`` nearest keys (masked), the nearest accepted below
    ``threshold``. No yaw estimate (0)."""
    mask = base.candidate_mask(db, query_robot, query_index, mode, exclude_recent)
    d2, pos = base.topk_by_key(db.keys, desc, mask, num_candidates)
    dist = torch.sqrt(torch.clamp(d2, min=0.0))
    dist = torch.where(torch.gather(mask, 1, pos), dist, float("inf"))
    best = torch.argmin(dist, dim=1)
    best_dist = torch.gather(dist, 1, best[:, None])[:, 0]
    best_pos = torch.gather(pos, 1, best[:, None])[:, 0]
    found = best_dist < threshold
    none = torch.full_like(best_pos, -1)
    return base.Match(
        found=found,
        db_pos=torch.where(found, best_pos, none).to(torch.int32),
        robot=torch.where(found, db.robot[best_pos].long(), none).to(torch.int32),
        index=torch.where(found, db.index[best_pos].long(), none).to(torch.int32),
        distance=best_dist,
        yaw=torch.zeros_like(best_dist),
    )
