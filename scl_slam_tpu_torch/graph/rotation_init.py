"""Chordal rotation averaging, the rotation stage of the two-stage solve
(port of ``scl_slam_tpu/graph/rotation_init.py``).

Treat the 9 entries of every R_i as free variables, minimize
sum_e || R_j - R_i Z_ij ||_F^2 (a sparse linear least-squares problem,
solved matrix-free by CG), then project each solution back onto SO(3).
It converges whatever the initial rotations, after which the GN pose
solve refines jointly.
"""
from __future__ import annotations

import torch

from ..geometry import se3
from . import factors as F


def chordal_rotation_init(
    g: F.FactorGraph,
    poses: se3.Pose,
    anchor: int = 0,
    cg_iters: int = 128,
) -> se3.Pose:
    """Rotation-averaged poses: rotations from the chordal solve, anchored
    strongly (weight 10) at the first prior's measured rotation and weakly
    (0.1) at every other prior pose's current rotation (see the JAX
    function for why both); translations untouched."""
    n = poses.t.shape[0]
    dtype, dev = poses.t.dtype, poses.t.device
    emask = g.edge_mask().to(dtype)
    gi, gj, gp = g.i.long(), g.j.long(), g.prior_idx.long()

    has_prior = g.num_priors > 0
    anchor = torch.where(has_prior, gp[0], anchor).reshape(1)
    anchor_R = torch.where(has_prior, g.prior_z.R[0], poses.R[anchor[0]])
    pweak = 0.1 * g.prior_mask().to(dtype)
    pweak[0] = 0.0
    Z = g.z.R

    def apply_AtA(X):  # X [n, 3, 3]
        r = (X[gi] @ Z - X[gj]) * emask[:, None, None]       # [E, 3, 3]
        out = torch.zeros_like(X)
        out.index_add_(0, gi, r @ Z.transpose(-1, -2))
        out.index_add_(0, gj, -r)
        out.index_add_(0, gp, pweak[:, None, None] * X[gp])
        out.index_add_(0, anchor, 10.0 * X[anchor])
        return out

    b = torch.zeros((n, 3, 3), dtype=dtype, device=dev)
    b.index_add_(0, gp, pweak[:, None, None] * poses.R[gp])
    b.index_add_(0, anchor, 10.0 * anchor_R[None])

    # CG on the (PSD) normal system, fixed iterations
    X = poses.R
    r = b - apply_AtA(X)
    p = r
    rs = torch.sum(r * r)
    for _ in range(cg_iters):
        Ap = apply_AtA(p)
        alpha = rs / torch.clamp(torch.sum(p * Ap), min=1e-30)
        X = X + alpha * p
        r = r - alpha * Ap
        rs2 = torch.sum(r * r)
        p = r + (rs2 / torch.clamp(rs, min=1e-30)) * p
        rs = rs2

    # project each X_i onto SO(3) through its SVD polar factor
    U, _, Vt = torch.linalg.svd(X)
    det = torch.linalg.det(U @ Vt)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    R = torch.einsum("nab,nb,nbc->nac", U, D, Vt)
    return se3.Pose(R, poses.t)


def solve_two_stage(
    g: F.FactorGraph,
    poses: se3.Pose,
    gn_iters: int = 8,
    cg_iters: int = 64,
    **kw,
):
    """Rotation init, then GN refine: the two-stage contract in one call."""
    from . import solver

    init = chordal_rotation_init(g, poses)
    return solver.solve(g, init, gn_iters=gn_iters, cg_iters=cg_iters, **kw)
