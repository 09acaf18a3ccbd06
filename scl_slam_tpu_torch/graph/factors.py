"""Fixed-capacity SE(3) factor graph (port of
``scl_slam_tpu/graph/factors.py``).

Factors live in pre-allocated tensors with a count; noise models are
diagonal 6-vector sqrt-information weights (residuals are multiplied by
``sqrt_info = 1/sigma`` before squaring), twist order (omega, v). The
appends write in place and return the graph (the JAX functions return a
new one); a full graph drops the append, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..geometry import se3

# reference noise defaults (variances): odometry [1e-6] * 3 + [1e-4] * 3
# (rot, trans); prior [1e-2, 1e-2, pi^2, 1e8, 1e8, 1e8]
ODOM_SQRT_INFO = tuple(1.0 / (v ** 0.5) for v in (1e-6,) * 3 + (1e-4,) * 3)
PRIOR_SQRT_INFO = tuple(
    1.0 / (v ** 0.5) for v in (1e-2, 1e-2, math.pi ** 2, 1e8, 1e8, 1e8)
)


class FactorGraph(NamedTuple):
    """Between-factors (i -> j) plus prior factors, fixed capacity."""

    i: torch.Tensor             # [E] int32
    j: torch.Tensor             # [E] int32
    z: se3.Pose                 # [E] measured relative pose i->j
    sqrt_info: torch.Tensor     # [E, 6]
    num_edges: torch.Tensor     # 0-d int32
    prior_idx: torch.Tensor     # [P] int32
    prior_z: se3.Pose           # [P]
    prior_sqrt_info: torch.Tensor  # [P, 6]
    num_priors: torch.Tensor    # 0-d int32

    @property
    def edge_capacity(self) -> int:
        return self.i.shape[0]

    @property
    def prior_capacity(self) -> int:
        return self.prior_idx.shape[0]

    def edge_mask(self) -> torch.Tensor:
        return torch.arange(self.edge_capacity, device=self.i.device) < self.num_edges

    def prior_mask(self) -> torch.Tensor:
        return (
            torch.arange(self.prior_capacity, device=self.prior_idx.device)
            < self.num_priors
        )


def make_graph(edge_capacity: int, prior_capacity: int = 8, device=None) -> FactorGraph:
    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return FactorGraph(
        i=zeros(edge_capacity, dtype=torch.int32),
        j=zeros(edge_capacity, dtype=torch.int32),
        z=se3.identity((edge_capacity,), device=device),
        sqrt_info=zeros(edge_capacity, 6),
        num_edges=zeros(dtype=torch.int32),
        prior_idx=zeros(prior_capacity, dtype=torch.int32),
        prior_z=se3.identity((prior_capacity,), device=device),
        prior_sqrt_info=zeros(prior_capacity, 6),
        num_priors=zeros(dtype=torch.int32),
    )


def add_between(g: FactorGraph, i, j, z: se3.Pose, sqrt_info) -> FactorGraph:
    """Append a BetweenFactor in place (no-op when full)."""
    dev = g.i.device
    return add_between_block(
        g,
        torch.as_tensor(i, device=dev).reshape(1),
        torch.as_tensor(j, device=dev).reshape(1),
        se3.Pose(
            torch.as_tensor(z.R, dtype=torch.float32, device=dev).reshape(1, 3, 3),
            torch.as_tensor(z.t, dtype=torch.float32, device=dev).reshape(1, 3),
        ),
        sqrt_info,
    )


def add_between_block(
    g: FactorGraph, i, j, z: se3.Pose, sqrt_info, valid=None
) -> FactorGraph:
    """Append B between factors in place, in row order.

    Row k lands at ``num_edges`` plus the number of valid rows before it (an
    exclusive cumsum); rows that are not ``valid`` [B] and rows past the
    capacity are dropped, exactly as B sequential masked :func:`add_between`
    calls. i/j: [B]; z: batched Pose; sqrt_info: [B, 6] or [6].
    """
    dev = g.i.device
    i = torch.as_tensor(i, device=dev)
    B = i.shape[0]
    E = g.edge_capacity
    ok = (
        torch.ones((B,), dtype=torch.bool, device=dev)
        if valid is None
        else torch.as_tensor(valid, device=dev).to(torch.bool)
    )
    ok_i = ok.to(torch.int32)
    pos = g.num_edges + torch.cumsum(ok_i, 0, dtype=torch.int32) - ok_i
    ok = ok & (pos < E)
    pos_w = torch.where(ok, pos, E).long()  # row E: a scratch row, dropped
    si = torch.as_tensor(sqrt_info, dtype=torch.float32, device=dev).expand(B, 6)

    def scatter(arr, rows):
        tmp = torch.cat([arr, arr.new_zeros((1,) + arr.shape[1:])])
        tmp[pos_w] = rows.to(arr.dtype)
        arr.copy_(tmp[:E])

    scatter(g.i, i)
    scatter(g.j, torch.as_tensor(j, device=dev))
    scatter(g.z.R, z.R)
    scatter(g.z.t, z.t)
    scatter(g.sqrt_info, si)
    g.num_edges.add_(ok.sum().to(torch.int32))
    return g


def add_prior(g: FactorGraph, idx: int, z: se3.Pose, sqrt_info) -> FactorGraph:
    """Append a prior factor in place (no-op when full)."""
    cap = g.prior_capacity
    pos = torch.clamp(g.num_priors, max=cap - 1).long()
    ok = g.num_priors < cap
    si = torch.as_tensor(sqrt_info, dtype=torch.float32, device=g.prior_idx.device)
    g.prior_idx[pos] = torch.where(ok, idx, g.prior_idx[pos]).to(torch.int32)
    g.prior_z.R[pos] = torch.where(ok, z.R, g.prior_z.R[pos])
    g.prior_z.t[pos] = torch.where(ok, z.t, g.prior_z.t[pos])
    g.prior_sqrt_info[pos] = torch.where(ok, si, g.prior_sqrt_info[pos])
    g.num_priors.add_(ok.to(torch.int32))
    return g


def between_residuals(g: FactorGraph, poses: se3.Pose) -> torch.Tensor:
    """Unweighted residuals r_e = log(z^-1 (T_i^-1 T_j)) for every edge slot,
    [E, 6]; unused slots give values that callers mask."""
    Ti = se3.take(poses, g.i)
    Tj = se3.take(poses, g.j)
    return se3.log(se3.compose(se3.inverse(g.z), se3.between(Ti, Tj)))


def prior_residuals(g: FactorGraph, poses: se3.Pose) -> torch.Tensor:
    """r_p = log(z^-1 T_idx) for every prior slot, [P, 6]."""
    T = se3.take(poses, g.prior_idx)
    return se3.log(se3.compose(se3.inverse(g.prior_z), T))


def chi2(g: FactorGraph, poses: se3.Pose) -> torch.Tensor:
    """Total weighted squared error over the used slots (0-d)."""
    re = between_residuals(g, poses) * g.sqrt_info
    rp = prior_residuals(g, poses) * g.prior_sqrt_info
    re2 = torch.sum(re * re, dim=-1) * g.edge_mask()
    rp2 = torch.sum(rp * rp, dim=-1) * g.prior_mask()
    return torch.sum(re2) + torch.sum(rp2)
