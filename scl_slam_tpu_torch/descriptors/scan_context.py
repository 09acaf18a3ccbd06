"""Scan Context descriptor (port of
``scl_slam_tpu/descriptors/scan_context.py``).

20x60 polar max-height image, ring key = row means, sector key = column
means; retrieval = masked top-k over ring keys, then the column-wise cosine
distance minimized over all sector shifts, as one einsum over the (shift,
candidate) volume. Every function is batched over a leading frame
dimension (the JAX package vmaps the single-frame form). The image is built
by kernel K2 on CUDA tensors (``ops.pointcloud.scatter_max_image``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..ops.pointcloud import Cloud, polar_bins, scatter_max_image
from . import base


@dataclass(frozen=True)
class ScanContextConfig:
    num_rings: int = 20
    num_sectors: int = 60
    max_radius: float = 80.0
    lidar_height: float = 1.65   # added to z so ground is ~0
    num_candidates: int = 10
    exclude_recent: int = 100    # intra only
    distance_threshold: float = 0.14
    max_bin_points: int = 0      # see config.ScanContextParams


class ScanContext(NamedTuple):
    """Encoded keyframes: image [..., R, S], ring key [..., R], sector key
    [..., S]."""

    image: torch.Tensor
    ring_key: torch.Tensor
    sector_key: torch.Tensor


def make(cloud: Cloud, cfg: ScanContextConfig) -> ScanContext:
    """Encode clouds [..., N, 3] -> Scan Context."""
    n = cloud.xyz.shape[-2]
    if 0 < cfg.max_bin_points < n:
        stride = -(-n // cfg.max_bin_points)
        cloud = Cloud(cloud.xyz[..., ::stride, :], cloud.mask[..., ::stride])
    ring, sector, valid = polar_bins(
        cloud.xyz, cloud.mask, cfg.num_rings, cfg.num_sectors, cfg.max_radius
    )
    z = cloud.xyz[..., 2] + cfg.lidar_height
    img = scatter_max_image(z, ring, sector, valid, cfg.num_rings, cfg.num_sectors)
    return ScanContext(img, img.mean(dim=-1), img.mean(dim=-2))


def _column_normalize(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """L2-normalize columns; returns (normalized, col_valid mask)."""
    norm = torch.linalg.norm(img, dim=-2)
    valid = norm > 1e-9
    return img / torch.clamp(norm, min=1e-9)[..., None, :], valid


def shifted_cosine_distance(
    query: torch.Tensor, candidates: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Min-over-shifts column-wise cosine distance.

    query [B, R, S]; candidates [B, K, R, S]. Returns (dist [B, K],
    best_shift [B, K]): dist(s) = mean over columns present in both of
    (1 - cos) between query column j+s and candidate column j.
    """
    S = query.shape[-1]
    qn, qv = _column_normalize(query)            # [B, R, S], [B, S]
    cn, cv = _column_normalize(candidates)       # [B, K, R, S], [B, K, S]
    j = torch.arange(S, device=query.device)
    cols = (j[None, :] + j[:, None]) % S         # [S_shift, S_col]
    q_shift = qn[..., cols].permute(0, 2, 1, 3)  # [B, S_shift, R, S_col]
    qv_shift = qv[:, cols]                       # [B, S_shift, S_col]
    cos = torch.einsum("bsrj,bkrj->bskj", q_shift, cn)   # [B, S, K, S_col]
    both = qv_shift[:, :, None, :] & cv[:, None, :, :]
    n_cols = torch.clamp(both.sum(dim=-1), min=1)
    dist = torch.where(both, 1.0 - cos, 0.0).sum(dim=-1) / n_cols  # [B, S, K]
    best_shift = torch.argmin(dist, dim=1)       # first minimum on ties
    best = torch.gather(dist, 1, best_shift[:, None])[:, 0]
    return best, best_shift


def shift_to_yaw(shift: torch.Tensor, num_sectors: int) -> torch.Tensor:
    """Sector shift -> relative yaw in radians."""
    half = num_sectors // 2
    signed = torch.where(shift > half, shift - num_sectors, shift)
    return signed.to(torch.float32) * (2.0 * math.pi / num_sectors)


def make_db(capacity: int, cfg: ScanContextConfig, device) -> base.DescriptorDB:
    return base.make_db(
        capacity, (cfg.num_rings, cfg.num_sectors), cfg.num_rings, device
    )


def insert(
    db: base.DescriptorDB, sc: ScanContext, robot: int, index: int, pos: int
) -> base.DescriptorDB:
    return base.db_insert(db, sc.image, sc.ring_key, robot, index, pos)


def from_db(db: base.DescriptorDB, slots) -> ScanContext:
    """The stored descriptors at ``slots``; the sector key is recomputed
    from the image."""
    img, key = base.rows(db, slots, ("descriptors", "keys"))
    return ScanContext(img, key, img.mean(dim=-2))


def from_wire(values: torch.Tensor, cfg: ScanContextConfig) -> ScanContext:
    """Decode a broadcast float vector (the flat image); the ring and
    sector keys are recomputed from it."""
    img = values.reshape(cfg.num_rings, cfg.num_sectors)
    return ScanContext(img, img.mean(dim=1), img.mean(dim=0))


def to_wire(sc: ScanContext) -> torch.Tensor:
    return sc.image.reshape(-1)


def query(
    db: base.DescriptorDB,
    sc: ScanContext,
    query_robot,
    query_index: torch.Tensor,
    cfg: ScanContextConfig,
    mode: str = "intra",
) -> base.Match:
    """Two-stage loop detection for B query frames at once.

    sc: batched ScanContext ([B, R, S] images); query_index [B];
    query_robot one robot, or [B] robots (a fleet batch). Stage 1:
    ``num_candidates`` nearest ring keys (masked top-k); stage 2: the full
    shifted cosine distance on them; accept the best below
    ``distance_threshold``.
    """
    mask = base.candidate_mask(db, query_robot, query_index, mode, cfg.exclude_recent)
    _, pos = base.topk_by_key(db.keys, sc.ring_key, mask, cfg.num_candidates, base.shard_of(db))
    cand = base.candidate_rows(db, pos, mask)
    dist, shift = shifted_cosine_distance(sc.image, cand.descriptors)   # [B, K]
    # masked-out slots (top-k padding)
    dist = torch.where(cand.ok, dist, float("inf"))
    best = torch.argmin(dist, dim=1)
    best_dist = torch.gather(dist, 1, best[:, None])[:, 0]
    best_pos = torch.gather(pos, 1, best[:, None])[:, 0]
    found = best_dist < cfg.distance_threshold
    none = torch.full_like(best_pos, -1)
    return base.Match(
        found=found,
        db_pos=torch.where(found, best_pos, none).to(torch.int32),
        robot=torch.where(found, base.pick(cand.robot, best), none).to(torch.int32),
        index=torch.where(found, base.pick(cand.index, best), none).to(torch.int32),
        distance=best_dist,
        yaw=shift_to_yaw(torch.gather(shift, 1, best[:, None])[:, 0], cfg.num_sectors),
    )
