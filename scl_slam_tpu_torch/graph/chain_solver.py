"""Exact direct pose-graph solver for chains + loop closures (port of
``scl_slam_tpu/graph/chain_solver.py``).

SLAM pose graphs are odometry CHAINS plus a sparse set of LOOP factors.
This module computes the EXACT damped Gauss-Newton step in O(N + L^2): an
N-pose chain's smooth modes sit below f32 matrix-vector noise for long
chains, so an f32 Krylov method (``solver.solve``) cannot carry a loop
correction across them; a direct method in a basis where the chain is
block-diagonal sidesteps the conditioning.

The construction (see the JAX module for the derivation):

1. Each pose's correction is a WORLD twist z_k = Ad(T_k) xi_k, written as
   chain increments delta_k = z_k - z_{k-1} within each chain segment.
2. A between-factor is invariant to a common world twist of both ends, so
   a chain edge (k-1 -> k) depends on delta_k alone (the odometry part of
   the normal matrix is block diagonal, D), and a loop (a, b) on the
   difference of two prefix intervals of delta (a rank-6 row of U).
3. (D + U^T W U) delta = c is solved by Woodbury: every U-product is a
   difference of prefix sums of D^-1, and the capacitance is one dense
   6(L+P) Cholesky with iterative refinement.

As in the JAX package, no runtime path calls it: it is the offline exact
solver (the drain uses ``solver.solve``), and a caller checks
``loop_overflow`` itself.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3
from . import factors as F
from .solver import _cholesky, _cho_inverse, _JtWJ, _linearize, _mtv, _mv


class ChainSolveResult(NamedTuple):
    poses: se3.Pose
    chi2_history: torch.Tensor   # [gn_iters + 1]
    delta_norms: torch.Tensor    # [gn_iters]
    loop_overflow: torch.Tensor  # bool: more non-chain factors than loop_capacity


def _segment_structure(g: F.FactorGraph, n_poses: int):
    """Chain segmentation from the graph itself: pose k has a chain parent
    iff a valid edge (k-1 -> k) exists; poses without one start a new
    segment. Returns (chain_edge [E] bool, seg_start [N] int64: the index
    of pose k's segment start)."""
    dev = g.i.device
    chain_edge = g.edge_mask() & (g.j == g.i + 1)
    has_parent = torch.zeros(n_poses + 1, dtype=torch.bool, device=dev)
    has_parent[torch.where(chain_edge, g.j, n_poses).long()] = True
    ar = torch.arange(n_poses, device=dev)
    start_marks = torch.where(~has_parent[:n_poses], ar, -1)
    return chain_edge, torch.cummax(start_marks, 0).values


def chain_solve(
    g: F.FactorGraph,
    poses: se3.Pose,
    gn_iters: int = 6,
    loop_capacity: int = 256,
    damping: float = 1e-6,
    huber_delta: float = 1e9,
) -> ChainSolveResult:
    """Exact damped Gauss-Newton for chain + loop graphs (module note).

    ``loop_capacity`` bounds the non-chain factors (loops and stray
    edges) taken into the solve; past it ``loop_overflow`` is True and the
    later rows are left out of the solve (their factors stay in the graph),
    so a caller must check it and fall back to ``solver.solve``.
    """
    n_poses = poses.t.shape[0]
    P = g.prior_capacity
    dtype, dev = poses.t.dtype, poses.t.device
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    gi, gj, gp = g.i.long(), g.j.long(), g.prior_idx.long()
    ar_n = torch.arange(n_poses, device=dev)

    chain_edge, seg_start = _segment_structure(g, n_poses)
    is_loop = g.edge_mask() & ~chain_edge
    loop_overflow = is_loop.sum() > loop_capacity
    # stable selection of loop rows (loops first, then padding)
    loop_ids = torch.sort((~is_loop).to(torch.int8), stable=True).indices[:loop_capacity]
    loop_valid = is_loop[loop_ids]
    LR = loop_ids.shape[0] + P
    # segment end: (smallest segment-start index > k) - 1
    starts = torch.where(seg_start == ar_n, ar_n, n_poses)
    nxt = torch.cat([starts[1:], starts.new_full((1,), n_poses)])
    seg_end = torch.flip(torch.cummin(torch.flip(nxt, (0,)), 0).values, (0,)) - 1

    def prefix(x):
        """[N, ...] -> [N + 1, ...]: row p holds the sum of rows < p."""
        return torch.cat([x.new_zeros((1,) + x.shape[1:]), torch.cumsum(x, 0)])

    cur = poses
    chi2s, dnorms = [F.chi2(g, poses)], []
    for _ in range(gn_iters):
        r_e, Ji, Jj, w_e, r_p, Jp, w_p = _linearize(g, cur, huber_delta)

        # rhs in the body-twist (dx) basis, as in solver.solve
        b = torch.zeros((n_poses, 6), dtype=dtype, device=dev)
        b.index_add_(0, gi, -_mtv(Ji, w_e * r_e))
        b.index_add_(0, gj, -_mtv(Jj, w_e * r_e))
        b.index_add_(0, gp, -_mtv(Jp, w_p * r_p))

        # world-twist conversion: Ad(T_k)^-1 per pose
        ad_inv = se3.adjoint(se3.inverse(cur))              # [N, 6, 6]

        # block-diagonal chain part: D[j] += E^T W E, E = Jj Ad^-1_j
        E_e = Jj @ ad_inv[gj]                                # [E, 6, 6]
        D = torch.zeros((n_poses, 6, 6), dtype=dtype, device=dev)
        D.index_add_(0, gj, _JtWJ(E_e, w_e * chain_edge[:, None], E_e))

        # priors at segment starts fold into D exactly (left in U, their
        # Woodbury cancellation is beyond f32: see the JAX module)
        E_p = Jp @ ad_inv[gp]                                # [P, 6, 6]
        prior_at_start = seg_start[gp] == gp
        w_p_row = w_p * (~prior_at_start)[:, None]
        D.index_add_(0, gp, _JtWJ(E_p, w_p * prior_at_start[:, None], E_p))

        mag = torch.clamp(torch.diagonal(D, dim1=-2, dim2=-1).max(dim=-1).values, min=1.0)
        # segment-start increments are block gauges: a mild absolute floor
        floor = torch.where(seg_start == ar_n, 1e-3, 1e-6).to(dtype)
        D = D + (damping * mag + floor)[:, None, None] * eye6
        Dinv = _cho_inverse(_cholesky(D)[0])                # [N, 6, 6]

        # rhs in the increment basis: segmented suffix sums of Ad^-T b
        u = _mtv(ad_inv, b)
        suf = torch.cat([torch.flip(torch.cumsum(torch.flip(u, (0,)), 0), (0,)), u.new_zeros((1, 6))])
        c = suf[ar_n] - suf[seg_end + 1]                     # [N, 6]

        # loop and prior rows: B [LR, 6, 6], weights [LR, 6], two signed
        # intervals (lo, hi] each, summed as Phi[hi + 1] - Phi[lo + 1]
        a_end, b_end = gi[loop_ids], gj[loop_ids]
        B = torch.cat([E_e[loop_ids], E_p])
        w_r = torch.cat([torch.where(loop_valid[:, None], w_e[loop_ids], 0.0), w_p_row])
        zP = torch.zeros(P, dtype=torch.int64, device=dev)
        lo = torch.stack([torch.cat([seg_start[b_end] - 1, seg_start[gp] - 1]),
                          torch.cat([seg_start[a_end] - 1, zP])], dim=1)
        hi = torch.stack([torch.cat([b_end, gp]), torch.cat([a_end, zP])], dim=1)
        sgn = torch.stack([
            torch.cat([loop_valid.to(dtype), (w_p_row.max(dim=-1).values > 0).to(dtype)]),
            torch.cat([torch.where(loop_valid, -1.0, 0.0).to(dtype), zP.to(dtype)]),
        ], dim=1)                                            # [LR, 2]

        # capacitance M = W^-1 + U D^-1 U^T, from the pairwise interval
        # intersections over the 2 x 2 signed combinations
        PhiD = prefix(Dinv)                                  # [N + 1, 6, 6]
        ilo = torch.maximum(lo[:, None, :, None], lo[None, :, None, :])
        ihi = torch.minimum(hi[:, None, :, None], hi[None, :, None, :])
        cut_hi = torch.maximum(ihi + 1, ilo + 1)             # empty -> equal
        G = (PhiD[cut_hi] - PhiD[ilo + 1]) * (
            sgn[:, None, :, None] * sgn[None, :, None, :]
        )[..., None, None]
        G = G.sum(dim=(2, 3))                                # [LR, LR, 6, 6]
        Cap = (B[:, None] @ G @ B[None].transpose(-1, -2)).permute(0, 2, 1, 3).reshape(
            LR * 6, LR * 6
        )
        # W^-1 on the diagonal; a masked row gets a huge W^-1 (lambda ~ 0)
        w_diag = torch.where(w_r > 0, w_r, 1e-30).reshape(-1)
        Cap = Cap + torch.diag(1.0 / w_diag)
        Cap = 0.5 * (Cap + Cap.T)

        # rhs of the capacitance system: U D^-1 c
        PhiDc = prefix(_mv(Dinv, c))
        seg_sum = ((PhiDc[hi + 1] - PhiDc[lo + 1]) * sgn[..., None]).sum(dim=1)
        rho = _mv(B, seg_sum).reshape(-1)

        # equilibrated Cholesky + iterative refinement: the capacitance is
        # intrinsically ill-conditioned for long chains (JAX module note)
        reg = 4e-7 if dtype == torch.float32 else 1e-13
        scap = torch.rsqrt(torch.clamp(torch.diagonal(Cap), min=1e-30))
        Cap_eq = Cap * scap[:, None] * scap[None, :] + reg * torch.eye(
            LR * 6, dtype=dtype, device=dev
        )
        Lcap = _cholesky(Cap_eq)[0]
        r_eq = scap * rho
        y = torch.cholesky_solve(r_eq[:, None], Lcap)[:, 0]
        for _ in range(3):
            y = y + torch.cholesky_solve((r_eq - Cap_eq @ y)[:, None], Lcap)[:, 0]
        lam = (y * scap).reshape(LR, 6)

        # U^T lam by a difference array, then delta and z
        v = _mtv(B, lam)                                     # [LR, 6] B^T lam
        acc = torch.zeros((n_poses + 1, 6), dtype=dtype, device=dev)
        for s in range(2):
            vs = v * sgn[:, s, None]
            acc.index_add_(0, lo[:, s] + 1, vs)
            acc.index_add_(0, hi[:, s] + 1, -vs)
        ut_lam = torch.cumsum(acc[:-1], 0)                   # [N, 6]

        delta = _mv(Dinv, c - ut_lam)
        Phi_d = prefix(delta)
        z = Phi_d[ar_n + 1] - Phi_d[seg_start]
        dx = _mv(ad_inv, z)

        cur = se3.retract(cur, dx)
        chi2s.append(F.chi2(g, cur))
        dnorms.append(torch.linalg.norm(dx))
    return ChainSolveResult(
        poses=cur,
        chi2_history=torch.stack(chi2s),
        delta_norms=torch.stack(dnorms) if dnorms else poses.t.new_zeros((0,)),
        loop_overflow=loop_overflow,
    )
