"""Point-cloud primitives on the replay path (port of
``scl_slam_tpu/ops/pointcloud.py``).

Clouds are fixed-capacity ``[..., N, 3]`` tensors with a validity mask;
every function here takes leading batch dimensions, which replaces the JAX
package's ``vmap`` over frames, except ``voxel_downsample`` and
``voxel_downsample_hash`` (one cloud each; the mapper walks the frames).
``estimate_normals`` walks the frames itself, and its brute-force k-NN
(``knn_indices``) walks the queries in chunks, so no [N, N] (or [B, N, N])
distance matrix is ever built.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import kernels

PAD_VALUE = 1e6  # sentinel coordinate for invalid points (far outside any map)


class Cloud(NamedTuple):
    """Fixed-capacity point cloud: xyz [..., N, 3], validity mask [..., N]."""

    xyz: torch.Tensor
    mask: torch.Tensor

    def count(self) -> torch.Tensor:
        return torch.sum(self.mask, dim=-1)


def fit_capacity(xyz, capacity: int):
    """Host-side uniform-stride subsample of [M, 3] down to <= capacity
    points (identity when it already fits). Scans arrive in beam/azimuth
    order, so a stride keeps the whole field of view where truncation
    would drop sectors."""
    m = xyz.shape[0]
    if m <= capacity:
        return xyz
    step = -(-m // capacity)  # ceil
    return xyz[::step][:capacity]


def from_points(xyz: torch.Tensor, capacity: int) -> Cloud:
    """Pad (or stride-subsample) [M, 3] points to a fixed-capacity Cloud."""
    xyz = fit_capacity(xyz, capacity)
    m = xyz.shape[0]
    out = torch.full((capacity, 3), PAD_VALUE, dtype=torch.float32, device=xyz.device)
    out[:m] = xyz[:m].to(torch.float32)
    mask = torch.arange(capacity, device=xyz.device) < m
    return Cloud(out, mask)


def transform(cloud: Cloud, R: torch.Tensor, t: torch.Tensor) -> Cloud:
    """Rigid transform of a cloud; invalid points stay at the sentinel."""
    xyz = torch.einsum("...ij,...nj->...ni", R, cloud.xyz) + t[..., None, :]
    xyz = torch.where(cloud.mask[..., None], xyz, PAD_VALUE)
    return Cloud(xyz, cloud.mask)


def voxel_downsample(cloud: Cloud, leaf: float, out_capacity: int | None = None) -> Cloud:
    """Voxel-grid downsample of one cloud [N, 3], keeping per voxel the
    point closest to the voxel's center (lowest index on ties). Voxels are
    grouped exactly by a packed int32 key (11+11+8 bits around the masked
    mean, quantized to the leaf grid; points outside that range count as
    invalid). Representatives are ordered by a hash of their voxel
    coordinates, so a truncation to ``out_capacity`` keeps a spatially
    uniform subset. The same algorithm as the JAX function."""
    xyz, mask = cloud.xyz, cloud.mask
    n = xyz.shape[0]
    out_capacity = out_capacity or n
    dev = xyz.device
    inv_leaf = 1.0 / leaf
    w = mask.to(xyz.dtype)
    mean = torch.sum(xyz * w[:, None], dim=0) / torch.clamp(w.sum(), min=1.0)
    origin = torch.floor(mean * inv_leaf) * leaf
    vox = torch.floor((xyz - origin) * inv_leaf).to(torch.int32)
    valid = (
        mask
        & (vox[:, 0].abs() < 1024) & (vox[:, 1].abs() < 1024) & (vox[:, 2].abs() < 128)
    )
    packed = (vox[:, 0] + 1024) * (2048 * 256) + (vox[:, 1] + 1024) * 256 + (vox[:, 2] + 128)
    big = 2**30
    packed = torch.where(valid, packed, big)
    xyz = torch.where(valid[:, None], xyz, PAD_VALUE)
    vox = torch.where(valid[:, None], vox, big)

    # exact grouping: one sort, consecutive-difference group ids
    order = torch.argsort(packed, stable=True)
    sv = packed[order]
    new_group = sv != torch.roll(sv, 1)
    new_group[:1] = True
    gid = torch.empty(n, dtype=torch.int64, device=dev)
    gid[order] = torch.cumsum(new_group, 0) - 1

    center = (vox.to(xyz.dtype) + 0.5) * leaf + origin
    d2 = torch.sum((xyz - center) ** 2, dim=-1)
    d2 = torch.where(valid, d2, float("inf"))
    min_d2 = torch.full((n,), float("inf"), dtype=xyz.dtype, device=dev).scatter_reduce(
        0, gid, d2, "amin"
    )
    idxs = torch.arange(n, device=dev)
    is_rep = (d2 <= min_d2[gid]) & valid
    first_idx = torch.full((n,), n, dtype=torch.int64, device=dev).scatter_reduce(
        0, gid, torch.where(is_rep, idxs, n), "amin"
    )
    is_rep = is_rep & (idxs == first_idx[gid])

    # representatives first, in voxel-hash order (the JAX int32 products
    # wrap; the low 32 bits of the int64 products are the same bits)
    v64 = vox.to(torch.int64)
    h = ((v64[:, 0] * 73856093) ^ (v64[:, 1] * 19349663) ^ (v64[:, 2] * 83492791)) & 0xFFFFFFFF
    sort_key = torch.where(is_rep, h >> 1, 2**31 - 1)
    take = torch.argsort(sort_key, stable=True)[:out_capacity]
    new_mask = is_rep[take]
    return Cloud(torch.where(new_mask[:, None], xyz[take], PAD_VALUE), new_mask)


def voxel_downsample_hash(
    cloud: Cloud,
    leaf: float,
    out_capacity: int,
    hash_slots: int = 1 << 15,
    predecimate_factor: int = 4,
) -> Cloud:
    """Approximate voxel downsample of one cloud [N, 3] in one scatter pass
    (no sort): each point scatter-mins a packed (15-bit quantized distance
    to its voxel's center, 16-bit point index) word into a ``hash_slots``
    table keyed by a voxel hash, and the occupied slots are compacted in
    slot order by a cumsum. Distinct voxels that collide in the table merge
    (one representative survives); the slot order keeps the property that a
    prefix of the result is a uniform spatial subsample.

    A cloud of more than 65,536 points (the index takes 16 bits) takes the
    exact :func:`voxel_downsample`. A larger cloud than ``2 x
    predecimate_factor x out_capacity`` is first cut by a static stride to
    about ``predecimate_factor x out_capacity`` points. The hash's int32
    products wrap in the JAX function; their low 32 bits are taken from
    int64 products here, so both pick the same slot.
    """
    n = cloud.xyz.shape[0]
    if n > 65536:
        return voxel_downsample(cloud, leaf, out_capacity)
    target = predecimate_factor * out_capacity
    if predecimate_factor > 0 and n > 2 * target:
        stride = n // target
        cloud = Cloud(cloud.xyz[::stride], cloud.mask[::stride])
        n = cloud.xyz.shape[0]
    xyz, mask = cloud.xyz, cloud.mask
    dev = xyz.device
    inv_leaf = 1.0 / leaf
    w = mask.to(xyz.dtype)
    mean = torch.sum(xyz * w[:, None], dim=0) / torch.clamp(w.sum(), min=1.0)
    origin = torch.floor(mean * inv_leaf) * leaf
    vox = torch.floor((xyz - origin) * inv_leaf).to(torch.int64)
    valid = (
        mask
        & (vox[:, 0].abs() < 1024) & (vox[:, 1].abs() < 1024) & (vox[:, 2].abs() < 128)
    )
    h = (
        ((vox[:, 0] * 73856093) ^ (vox[:, 1] * 19349663) ^ (vox[:, 2] * 83492791)) & 0x7FFFFFFF
    ) % hash_slots
    center = (vox.to(xyz.dtype) + 0.5) * leaf + origin
    d2 = torch.sum((xyz - center) ** 2, dim=-1)
    # pack (15-bit quantized d2 | 16-bit index); d2 <= 3/4 leaf^2 in-voxel
    q = torch.clamp(d2 * (32767.0 / (0.75 * leaf * leaf)), max=32767.0).to(torch.int64)
    sentinel = 0x7FFFFFFF
    packed = torch.where(valid, (q << 16) | torch.arange(n, device=dev), sentinel)
    best = torch.full((hash_slots,), sentinel, dtype=torch.int64, device=dev).scatter_reduce(
        0, h, packed, "amin"
    )
    occupied = best != sentinel
    # compaction in slot order: rows past the capacity go to a scratch row
    pos = torch.cumsum(occupied, 0) - 1
    ok = occupied & (pos < out_capacity)
    out_idx = torch.zeros(out_capacity + 1, dtype=torch.int64, device=dev)
    out_idx[torch.where(ok, pos, out_capacity)] = best & 0xFFFF
    out_idx = out_idx[:out_capacity]
    out_mask = torch.arange(out_capacity, device=dev) < ok.sum()
    return Cloud(torch.where(out_mask[:, None], xyz[out_idx], PAD_VALUE), out_mask)


def stride_permute_downsample(cloud: Cloud, out_capacity: int) -> Cloud:
    """Constant-time storage downsample: a fixed coprime scramble
    ``i -> (a*i + 1) mod m`` scaled into the valid prefix — one gather.

    Every PREFIX of the result is an evenly spaced azimuthal subsample of
    the scan (the property submap gathers and ICP source slices rely on).
    Requires the input mask to be a dense prefix. The JAX module computes
    the index in uint32; int64 is exact here because ``a < m <= 2^16`` and
    ``count <= 2^16``, so no product reaches 2^32.
    """
    m = out_capacity
    dev = cloud.xyz.device
    i = torch.arange(m, dtype=torch.int64, device=dev)
    a = (2654435761 % m) | 1
    scramble = (a * i + 1) % m
    count = cloud.count().to(torch.int64)                   # [...]
    idx = (scramble * count[..., None]) // m                 # [..., m]
    ok = count > 0
    xyz = torch.gather(
        cloud.xyz, -2, idx[..., None].expand(*idx.shape, 3)
    )
    mask = ok[..., None].expand(idx.shape)
    xyz = torch.where(mask[..., None], xyz, PAD_VALUE)
    return Cloud(xyz, mask.clone())


def polar_bins(
    xyz: torch.Tensor,
    mask: torch.Tensor,
    num_rings: int,
    num_sectors: int,
    max_radius: float,
    min_radius: float = 0.0,
):
    """Ring/sector bin indices (int32) for each point, Scan Context style.

    Returns ``(ring, sector, valid)``; out-of-range points are masked out.
    The sector index truncates ``atan2``: a 1-ulp difference in atan2
    between libraries moves a point that lies on a sector boundary into
    the neighbouring sector (see the tolerance in
    ``tests/test_torch_scan_context.py``).
    """
    x, y = xyz[..., 0], xyz[..., 1]
    r = torch.sqrt(x * x + y * y)
    theta = torch.atan2(y, x)  # [-pi, pi]
    frac = (theta + math.pi) / (2.0 * math.pi)
    sector = torch.clamp((frac * num_sectors).to(torch.int32), 0, num_sectors - 1)
    ring = torch.clamp(
        ((r - min_radius) / (max_radius - min_radius) * num_rings).to(torch.int32),
        0,
        num_rings - 1,
    )
    valid = mask & (r < max_radius) & (r >= min_radius)
    return ring, sector, valid


def scatter_max_image(
    values: torch.Tensor,
    ring: torch.Tensor,
    sector: torch.Tensor,
    valid: torch.Tensor,
    num_rings: int,
    num_sectors: int,
) -> torch.Tensor:
    """Bin-wise max image [..., num_rings, num_sectors] from per-point
    values [..., N]; empty bins, and bins whose values are all <= 0, read 0
    (the JAX function with ``init=0.0``).

    Runs as kernel K2 on CUDA tensors and as its plain PyTorch version on
    CPU tensors (``ops.kernels.max_image``).
    """
    lead = values.shape[:-1]
    n = values.shape[-1]
    img = kernels.max_image(
        values.reshape(-1, n).contiguous(),
        ring.reshape(-1, n).to(torch.int32).contiguous(),
        sector.reshape(-1, n).to(torch.int32).contiguous(),
        valid.reshape(-1, n).contiguous(),
        num_rings,
        num_sectors,
    )
    return img.reshape(*lead, num_rings, num_sectors)


# distances a chunk of knn_indices' queries holds at a time, by device: on
# the card 256 MiB of f32, on the CPU a chunk that stays near the caches
_KNN_BUDGET = {"cuda": 2**26, "cpu": 2**22}


def knn_indices(xyz: torch.Tensor, k: int) -> torch.Tensor:
    """The k nearest of points [N, 3] to each of them (itself included):
    [N, k] int64, in ascending squared distance, ties by the lower index.

    Brute force in chunks of queries, at most ``_KNN_BUDGET`` distances at
    a time. The squared distance is taken per
    coordinate, ((dx dx + dy dy) + dz dz); the JAX package ranks by the
    expanded form |q|^2 - 2 q.x + |x|^2, whose rounding can reorder
    near-ties at the k-th neighbour. The k kept are in :func:`smallest_k`'s
    order; which of several points tied at the k-th distance is kept is not
    specified (the padded points of a cloud all sit at PAD_VALUE, so those
    ties are between equal points).
    """
    n = xyz.shape[0]
    rows = max(1, _KNN_BUDGET[xyz.device.type] // max(n, 1))
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    out = []
    for q0 in range(0, n, rows):
        q = xyz[q0 : q0 + rows]
        d = q[:, 0:1] - x
        d2 = d * d
        d = q[:, 1:2] - y
        d2 += d * d
        d = q[:, 2:3] - z
        d2 += d * d
        out.append(smallest_k(d2, k))
    return torch.cat(out) if out else torch.zeros((0, k), dtype=torch.int64, device=xyz.device)


def smallest_k(d2: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest values along the last axis of d2, in
    ascending order, ties by the lower index (``lax.top_k`` of -d2) among
    the k kept; which of several values tied at the k-th is kept is
    ``torch.topk``'s choice."""
    vals, idx = torch.topk(d2, k, dim=-1, largest=False, sorted=True)
    idx, perm = torch.sort(idx, dim=-1)
    _, order = torch.sort(torch.gather(vals, -1, perm), dim=-1, stable=True)
    return torch.gather(idx, -1, order)


_EIGH_BATCH = 1 << 14


def covariance_normals(nbrs: torch.Tensor) -> torch.Tensor:
    """The smallest eigenvector of each neighbourhood's covariance: nbrs
    [..., k, 3] -> [..., 3] unit vectors, with the sign the eigensolver
    gives."""
    k = nbrs.shape[-2]
    centered = nbrs - nbrs.mean(dim=-2, keepdim=True)
    cov = torch.einsum("...ki,...kj->...ij", centered, centered) / k
    flat = cov.reshape(-1, 3, 3)
    # cuSOLVER's batched eigensolver refuses a batch of 131,072 matrices
    # (CUSOLVER_STATUS_INVALID_VALUE on an H100): _EIGH_BATCH a call
    vecs = torch.cat([torch.linalg.eigh(c).eigenvectors[..., 0]  # eigenvalues ascending
                      for c in flat.split(_EIGH_BATCH)]) if flat.shape[0] else flat[:, 0]
    return vecs.reshape(*cov.shape[:-2], 3)


def estimate_normals(cloud: Cloud, k: int = 16) -> torch.Tensor:
    """Per-point normals [..., N, 3] of clouds [..., N, 3]: the smallest
    eigenvector of the covariance of each point's k nearest neighbours
    (invalid points sit at PAD_VALUE), turned towards the viewpoint at the
    origin; zeros for invalid points. Plain torch (the JAX package computes
    it in XLA, outside any Pallas kernel)."""
    lead, n = cloud.xyz.shape[:-2], cloud.xyz.shape[-2]
    outs = []
    for xyz, mask in zip(cloud.xyz.reshape(-1, n, 3), cloud.mask.reshape(-1, n)):
        pts = torch.where(mask[:, None], xyz, PAD_VALUE)
        normal = covariance_normals(pts[knn_indices(pts, k)])
        flip = torch.sum(normal * (-pts), dim=-1) < 0
        normal = torch.where(flip[:, None], -normal, normal)
        outs.append(torch.where(mask[:, None], normal, 0.0))
    if not outs:
        return torch.zeros_like(cloud.xyz)
    return torch.stack(outs).reshape(*lead, n, 3)
