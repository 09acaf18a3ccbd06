"""Fixed-capacity descriptor database and masked top-k retrieval (port of
``scl_slam_tpu/descriptors/base.py``).

The DB is a tuple of tensors; writes go in place (the JAX replay step
donates its state, so nothing else holds the old arrays). Retrieval is a
masked distance matrix plus a stable sort, which reproduces ``lax.top_k``'s
lower-index-first order on ties.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class DescriptorDB(NamedTuple):
    """``descriptors`` [cap, ...]; ``keys`` [cap, key_dim]; ``robot`` and
    ``index`` [cap] int32 (-1 = empty slot); ``count`` 0-d int32."""

    descriptors: torch.Tensor
    keys: torch.Tensor
    robot: torch.Tensor
    index: torch.Tensor
    count: torch.Tensor


def make_db(
    capacity: int, desc_shape: tuple, key_dim: int, device,
    dtype=torch.float32,
) -> DescriptorDB:
    return DescriptorDB(
        descriptors=torch.zeros((capacity, *desc_shape), dtype=dtype, device=device),
        keys=torch.zeros((capacity, key_dim), dtype=dtype, device=device),
        robot=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        index=torch.full((capacity,), -1, dtype=torch.int32, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def db_insert(
    db: DescriptorDB,
    descriptor: torch.Tensor,
    key: torch.Tensor,
    robot: int,
    index: int,
    pos: int,
) -> DescriptorDB:
    """Single-row insert at row ``pos`` (the global keyframe slot: in a
    multi-robot run the rows are not filled in arrival order), in place; a
    no-op when ``pos`` lies outside the DB."""
    if not 0 <= pos < db.robot.shape[0]:
        return db
    db.descriptors[pos] = descriptor.to(db.descriptors.dtype)
    db.keys[pos] = key.to(db.keys.dtype)
    db.robot[pos] = robot
    db.index[pos] = index
    db.count.add_(1)
    return db


def db_insert_block(
    db: DescriptorDB,
    descriptors: torch.Tensor,
    keys: torch.Tensor,
    robot: int,
    indices: torch.Tensor,
    pos0: int,
) -> DescriptorDB:
    """Contiguous B-row insert at rows ``pos0 .. pos0+B-1``, in place.
    The caller guarantees ``0 <= pos0`` and ``pos0 + B <= capacity``."""
    B = indices.shape[0]
    rows = slice(pos0, pos0 + B)
    db.descriptors[rows] = descriptors.to(db.descriptors.dtype)
    db.keys[rows] = keys.to(db.keys.dtype)
    db.robot[rows] = robot
    db.index[rows] = indices.to(torch.int32)
    db.count.add_(B)
    return db


def db_insert_rows(
    db: DescriptorDB,
    descriptors: torch.Tensor,
    keys: torch.Tensor,
    robots: torch.Tensor,
    indices: torch.Tensor,
    pos: torch.Tensor,
) -> DescriptorDB:
    """B-row insert at distinct rows ``pos`` [B], in place: a fleet batch
    interleaves robots, so its rows are consecutive per robot but not
    overall. The caller guarantees every row is in range."""
    rows = pos.long()
    db.descriptors[rows] = descriptors.to(db.descriptors.dtype)
    db.keys[rows] = keys.to(db.keys.dtype)
    db.robot[rows] = robots.to(torch.int32)
    db.index[rows] = indices.to(torch.int32)
    db.count.add_(rows.shape[0])
    return db


class Match(NamedTuple):
    """Result of a loop-closure query (batched: every field [B])."""

    found: torch.Tensor
    db_pos: torch.Tensor
    robot: torch.Tensor
    index: torch.Tensor
    distance: torch.Tensor
    yaw: torch.Tensor


def candidate_mask(
    db: DescriptorDB,
    query_robot,
    query_index: torch.Tensor,
    mode: str,
    exclude_recent: int,
) -> torch.Tensor:
    """Validity mask over DB slots, [..., cap] for query_index [...].

    ``intra``: same robot, excluding the most recent ``exclude_recent``
    keyframes; ``inter``: other robots only. ``query_robot`` is one robot
    for every query, or one per query (a tensor shaped like
    ``query_index``: a fleet batch mixes robots).
    """
    dev = db.index.device
    query_index = torch.as_tensor(query_index, device=dev)
    query_robot = torch.as_tensor(query_robot, device=dev)
    valid = db.index >= 0
    same = db.robot == query_robot[..., None]
    if mode == "intra":
        not_recent = db.index < (query_index[..., None] - exclude_recent)
        return valid & same & not_recent
    if mode == "inter":
        return (valid & ~same).expand(*query_index.shape, -1)
    raise ValueError(f"unknown mode {mode!r}")


def topk_by_key(
    db_keys: torch.Tensor,
    query_key: torch.Tensor,
    mask: torch.Tensor,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest DB entries by L2 key distance (masked). query_key [..., D],
    mask [..., cap]. Returns (d2 [..., k], pos [..., k] int64), ties in
    ascending position order."""
    d2 = torch.sum((db_keys - query_key[..., None, :]) ** 2, dim=-1)
    d2 = torch.where(mask, d2, float("inf"))
    vals, pos = torch.sort(d2, dim=-1, stable=True)
    return vals[..., :k], pos[..., :k]
