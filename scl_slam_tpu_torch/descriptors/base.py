"""Fixed-capacity descriptor database and masked top-k retrieval (port of
``scl_slam_tpu/descriptors/base.py``).

The DB is a tuple of tensors; writes go in place (the JAX replay step
donates its state, so nothing else holds the old arrays). Retrieval is a
masked distance matrix plus a stable sort, which reproduces ``lax.top_k``'s
lower-index-first order on ties.

A DB can be sharded by rows over a process group (:func:`shard_db`, a
:class:`ShardedDB`): rank r then holds only rows ``[r S / D, (r + 1) S /
D)`` of the four arrays. The functions here take either kind: inserts write
on the owning rank, :func:`candidate_mask` is evaluated on the local rows,
:func:`topk_by_key` becomes ``parallel/sharded.sharded_topk``, and
:func:`rows`, :func:`candidate_rows` and :func:`column` read global rows
(one all-reduce each on a sharded DB). The JAX package places the arrays
row-sharded and lets XLA partition the unchanged query; both give the
unsharded answers.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch


class DescriptorDB(NamedTuple):
    """``descriptors`` [cap, ...]; ``keys`` [cap, key_dim]; ``robot`` and
    ``index`` [cap] int32 (-1 = empty slot); ``count`` 0-d int32."""

    descriptors: torch.Tensor
    keys: torch.Tensor
    robot: torch.Tensor
    index: torch.Tensor
    count: torch.Tensor


class DBShard(NamedTuple):
    """Where a sharded DB's rows live: the process ``group``, this
    process's ``rank`` in it, the group's size ``world`` and the DB's
    ``rows`` in all (rank r holds rows ``[r rows / world, (r + 1) rows /
    world)``)."""

    group: Any
    rank: int
    world: int
    rows: int

    @property
    def lo(self) -> int:
        return self.rank * (self.rows // self.world)


class ShardedDB(DescriptorDB):
    """A DescriptorDB of which this rank holds only its own rows of
    ``descriptors``, ``keys``, ``robot`` and ``index`` (``count`` is the
    whole DB's, on every rank); ``shard`` says which (:class:`DBShard`)."""

    shard: DBShard | None = None

    def _replace(self, **kwargs):
        out = DescriptorDB._replace(self, **kwargs)
        out.shard = self.shard
        return out


def shard_of(db: DescriptorDB) -> DBShard | None:
    """The DB's :class:`DBShard`, or None for a whole DB."""
    return getattr(db, "shard", None)


def shard_db(db: DescriptorDB, group) -> ShardedDB:
    """This rank's rows of a whole DB (copies), as a :class:`ShardedDB`
    over ``group``. The row count must divide by the group's size."""
    import torch.distributed as dist

    rank, world = dist.get_rank(group), dist.get_world_size(group)
    S = db.index.shape[0]
    if S % world:
        raise ValueError(f"DB rows {S} not divisible by {world} ranks")
    n = S // world
    rows = slice(rank * n, (rank + 1) * n)
    out = ShardedDB(
        descriptors=db.descriptors[rows].clone(), keys=db.keys[rows].clone(),
        robot=db.robot[rows].clone(), index=db.index[rows].clone(), count=db.count.clone(),
    )
    out.shard = DBShard(group, rank, world, S)
    return out


def unshard_db(db: DescriptorDB) -> DescriptorDB:
    """The whole DB on every rank (a sharded DB's rows gathered; a whole
    DB as it is)."""
    sh = shard_of(db)
    if sh is None:
        return db
    from ..parallel import sharded

    def whole(a):
        return sharded.gather(a, sh.group).flatten(0, 1)

    return DescriptorDB(whole(db.descriptors), whole(db.keys), whole(db.robot),
                        whole(db.index), db.count.clone())


def column(db: DescriptorDB, name: str) -> torch.Tensor:
    """The whole ``robot`` or ``index`` column, [S] (gathered on a sharded
    DB)."""
    sh = shard_of(db)
    col = getattr(db, name)
    if sh is None:
        return col
    from ..parallel import sharded

    return sharded.gather(col, sh.group).flatten(0, 1)


def _take_owned(db: DescriptorDB, pos: torch.Tensor, fields, extra=()):
    """Fields of global rows ``pos`` [...] of a sharded DB, and the
    ``extra`` tensors [..., n_local] at them, from their owners in one
    all-reduce: each rank fills the rows it holds into a zero-filled
    buffer of 32-bit words, and the sum is exact."""
    from ..parallel import sharded

    sh = shard_of(db)
    n = db.index.shape[0]
    pos = pos.long()
    own = (pos >= sh.lo) & (pos < sh.lo + n)
    li = torch.clamp(pos - sh.lo, 0, n - 1)
    vals = [getattr(db, f)[li] for f in fields]
    vals += [torch.gather(e, -1, li) for e in extra]
    parts, backs = [], []
    for v in vals:
        w, back = sharded._as_words(v)
        parts.append(torch.where(own.reshape(*own.shape, *([1] * (w.dim() - own.dim()))), w, 0)
                     .reshape(*pos.shape, -1))
        backs.append((back, w.shape))
    buf = sharded.all_reduce(torch.cat(parts, -1), sh.group)
    out, at = [], 0
    for (back, shape), part in zip(backs, parts):
        width = part.shape[-1]
        out.append(back(buf[..., at : at + width].reshape(shape).contiguous()))
        at += width
    return out


def rows(db: DescriptorDB, pos, fields=("descriptors", "keys", "robot", "index")) -> list:
    """``[getattr(db, f)[pos] for f in fields]`` for global rows ``pos``
    (a tensor or an int), from their owners on a sharded DB."""
    if shard_of(db) is None:
        return [getattr(db, f)[pos] for f in fields]
    p = torch.as_tensor(pos, device=db.index.device)
    return [v.reshape(tuple(p.shape) + tuple(v.shape[1:]))
            for v in _take_owned(db, p.reshape(-1), fields)]


class Candidates(NamedTuple):
    """The rows of a query's candidates (``pos`` [B, K]): descriptors,
    robot, index, and whether the candidate mask admits each."""

    descriptors: torch.Tensor
    robot: torch.Tensor
    index: torch.Tensor
    ok: torch.Tensor


def candidate_rows(db: DescriptorDB, pos: torch.Tensor, mask: torch.Tensor) -> Candidates:
    """The candidates at ``pos`` [B, K] (from :func:`topk_by_key`) with
    ``mask`` [B, cap] (this rank's rows on a sharded DB) at them: every
    family's verification reads these. One all-reduce on a sharded DB."""
    if shard_of(db) is None:
        return Candidates(db.descriptors[pos], db.robot[pos], db.index[pos],
                          torch.gather(mask, -1, pos))
    d, r, i, ok = _take_owned(db, pos, ("descriptors", "robot", "index"), (mask,))
    return Candidates(d, r, i, ok)


def pick(x: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """A candidate field ``x`` [B, K] at each query's ``best`` [B], as
    int64."""
    return torch.gather(x, 1, best[:, None])[:, 0].long()


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
    no-op when ``pos`` lies outside the DB. On a sharded DB only the owner
    writes the row."""
    sh = shard_of(db)
    if not 0 <= pos < (db.robot.shape[0] if sh is None else sh.rows):
        return db
    db.count.add_(1)
    if sh is not None:
        pos -= sh.lo
        if not 0 <= pos < db.robot.shape[0]:
            return db
    db.descriptors[pos] = descriptor.to(db.descriptors.dtype)
    db.keys[pos] = key.to(db.keys.dtype)
    db.robot[pos] = robot
    db.index[pos] = index
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
    The caller guarantees ``0 <= pos0`` and ``pos0 + B <= capacity``. On a
    sharded DB each rank writes the rows it holds."""
    B = indices.shape[0]
    sh = shard_of(db)
    if sh is not None:
        n = db.index.shape[0]
        a, b = max(pos0, sh.lo), min(pos0 + B, sh.lo + n)
        if a < b:
            src = slice(a - pos0, b - pos0)
            db.descriptors[a - sh.lo : b - sh.lo] = descriptors[src].to(db.descriptors.dtype)
            db.keys[a - sh.lo : b - sh.lo] = keys[src].to(db.keys.dtype)
            db.robot[a - sh.lo : b - sh.lo] = robot
            db.index[a - sh.lo : b - sh.lo] = indices[src].to(torch.int32)
        db.count.add_(B)
        return db
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
    overall. The caller guarantees every row is in range. On a sharded DB
    each rank writes the rows it holds."""
    rows = pos.long()
    db.count.add_(rows.shape[0])
    sh = shard_of(db)
    if sh is not None:
        own = (rows >= sh.lo) & (rows < sh.lo + db.index.shape[0])
        rows = rows[own] - sh.lo
        descriptors, keys = descriptors[own], keys[own]
        robots, indices = robots[own], indices[own]
    db.descriptors[rows] = descriptors.to(db.descriptors.dtype)
    db.keys[rows] = keys.to(db.keys.dtype)
    db.robot[rows] = robots.to(torch.int32)
    db.index[rows] = indices.to(torch.int32)
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
    shard: DBShard | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """k nearest DB entries by L2 key distance (masked). query_key [..., D],
    mask [..., cap]. Returns (d2 [..., k], pos [..., k] int64), ties in
    ascending position order. With ``shard`` (a sharded DB's:
    ``db_keys`` and ``mask`` are this rank's rows) it is
    ``parallel/sharded.sharded_topk``, with global positions."""
    if shard is not None:
        from ..parallel import sharded

        return sharded.sharded_topk(shard.group, db_keys, query_key, mask, k, shard.lo)
    d2 = torch.sum((db_keys - query_key[..., None, :]) ** 2, dim=-1)
    d2 = torch.where(mask, d2, float("inf"))
    vals, pos = torch.sort(d2, dim=-1, stable=True)
    return vals[..., :k], pos[..., :k]
