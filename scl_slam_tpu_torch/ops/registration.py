"""Geometric verification: point-to-point ICP for intra-robot loops and
RANSAC for inter-robot loops (port of the replay, live and inter-robot
paths' part of ``scl_slam_tpu/ops/registration.py``).

Ported: ``kabsch``; the solo path ``nearest_select`` (kernel K4 on CUDA
tensors), ``_icp_stage`` and ``icp``; the batched path ``_matches_batched``,
``_icp_stage_batched``, the fused stage ``_icp_stage_batched_fused`` with
``_kabsch_from_moments``, and ``icp_batched``. Both keep the coarse stage,
the optional target-stride stage, the stall and hopeless exits and
``reuse_final_fitness``. The JAX ``lax.while_loop`` is a host loop that
reads the done flag(s) once per iteration. The solo path does not go
through K1: K1's default body averages the payload over exact ties, the
solo contract takes the lowest index.

The batched ICP's switches are the JAX module's, with its defaults, read
at call time: ``FUSED_ICP`` (each iteration one kernel K5 pass,
``kernels.icp_moments_batched``, and its final fitness pass too),
``MXU_NN`` (the non-exact 1-NN passes by kernel K8,
``kernels.nn_select_batched_mxu``, on recentred coordinates, the winner's
distance recomputed exactly), ``NN_INDEX`` (the 1-NN by kernel K7,
``kernels.nn_index_batched``, then one gather of the payload) and
``SELECT_VARIANT`` (K1's and K5's tie rule, ``"mineq"`` or
``"argmin"``). Each takes its path only where the JAX package on a TPU
would (:func:`_tile_shapes_ok`). They reach the replay path
(``Mapper.replay``) and the fleet's intra ICP and RANSAC 1-NN
(``FleetMapper.step``); the live path's solo ICP (K4) and the
decentralized RANSAC (K3) read none of them, as in JAX.

Inter-robot: ``nearest_neighbors`` (kernel K3 on CUDA tensors),
``rigid_from_triangles``, ``triangles_ok`` and ``ransac_align``. RANSAC
draws its minimal samples from a counter-based integer hash of (seed,
attempt, hypothesis, point) instead of ``jax.random``: the same draws on
the CPU and on the card, and a test can inject JAX's own samples.

Fleet: ``ransac_align_batched``, B verifications at once, its 1-NN through
``_matches_batched`` (exact: kernel K1, or K7 under ``NN_INDEX``) and its
hypotheses scored by kernel K6 (``kernels.ransac_counts_batched``) on
CUDA tensors. Its uniforms come from the same counter hash, of (seed,
step, lane, hypothesis, sample).

Front end: ``icp_point_to_plane``, the scan-to-map registration of
``runtime/odometry.py``, its 1-NN and the winner's normal by kernel K4 at
P = 8.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3
from . import kernels
from .pointcloud import PAD_VALUE, Cloud

# Exit rules and their constants, as in the JAX module (see its notes).
STALL_RATIO = 0.9
STALL_PATIENCE = 3
STALL_ABS_FACTOR = 100.0
HOPELESS_MARGIN = 4.0
COARSE_TOL_FACTOR = 30.0

# The batched ICP's switches, with the JAX defaults; read at call time.
FUSED_ICP = False         # JAX registration.FUSED_ICP: iterations on K5
MXU_NN = False            # JAX registration.MXU_NN: non-exact 1-NN on K8
NN_INDEX = False          # JAX registration.NN_INDEX: 1-NN on K7 + gather
SELECT_VARIANT = "mineq"  # JAX registration.SELECT_VARIANT: K1/K5 tie rule

# the JAX package's query tile and target tiles (pallas_kernels.TQ and
# pick_target_tile), kept only as the rule of which path runs
_QUERY_TILE = 256
_TARGET_TILES = (8192, 4096, 2048, 1024)


def _tile_shapes_ok(nq: int, nt: int) -> bool:
    """The JAX package's rule for which batched-ICP path runs: its Pallas
    kernels, and with them the ``FUSED_ICP``, ``MXU_NN`` and ``NN_INDEX``
    paths, take ``nq`` queries and ``nt`` targets only when ``nq`` is a
    multiple of 256 and ``nt`` of 8192, 4096, 2048 or 1024 (its
    ``pallas_kernels.TQ`` and ``pick_target_tile``). It is not a limit of
    the CUDA kernels, which take any shape. It is kept because the path
    changes the answer: the fused path ignores ``target_stride`` and
    ``reuse_final_fitness``, the MXU path selects approximately. So the
    port takes each switch's path exactly where the JAX package on a TPU
    would, on the CPU and on the card alike."""
    return nq % _QUERY_TILE == 0 and any(nt % tt == 0 for tt in _TARGET_TILES)


class ICPResult(NamedTuple):
    pose: se3.Pose          # transform mapping source into target frame
    fitness: torch.Tensor   # mean squared distance over inlier correspondences
    inlier_frac: torch.Tensor
    converged: torch.Tensor


def kabsch(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor) -> se3.Pose:
    """Weighted rigid alignment argmin_T sum_i w_i |T(src_i) - dst_i|^2 by
    the SVD of the weighted cross-covariance. src/dst [..., N, 3],
    weights [..., N]."""
    w = weights / torch.clamp(weights.sum(dim=-1, keepdim=True), min=1e-9)
    mu_s = torch.sum(src * w[..., None], dim=-2)
    mu_d = torch.sum(dst * w[..., None], dim=-2)
    cs = src - mu_s[..., None, :]
    cd = dst - mu_d[..., None, :]
    H = torch.einsum("...ni,...n,...nj->...ij", cs, w, cd)
    U, _, Vt = torch.linalg.svd(H)
    det = torch.linalg.det(Vt.transpose(-1, -2) @ U.transpose(-1, -2))
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    R = torch.einsum("...ji,...j,...kj->...ik", Vt, D, U)  # V diag(D) U^T
    t = mu_d - torch.einsum("...ij,...j->...i", R, mu_s)
    return se3.Pose(R, t)


def rigid_from_triangles(src: torch.Tensor, dst: torch.Tensor) -> se3.Pose:
    """Closed-form rigid transform from 3-point correspondences: an
    orthonormal frame on each triangle (edge, in-plane normal component,
    plane normal), R = F_dst F_src^T, t from the centroids. src/dst
    [..., 3, 3] (three points x xyz). Degenerate triples give finite but
    non-orthonormal frames: callers gate them with :func:`triangles_ok`
    (see the JAX function for why)."""
    eps = 1e-12

    def frame(p):
        u = p[..., 1, :] - p[..., 0, :]
        v = p[..., 2, :] - p[..., 0, :]
        e1 = u / (torch.linalg.norm(u, dim=-1, keepdim=True) + eps)
        w = torch.linalg.cross(e1, v, dim=-1)
        e3 = w / (torch.linalg.norm(w, dim=-1, keepdim=True) + eps)
        e2 = torch.linalg.cross(e3, e1, dim=-1)
        return torch.stack([e1, e2, e3], dim=-1)           # columns

    R = frame(dst) @ frame(src).transpose(-1, -2)
    cs = src.mean(dim=-2)
    cd = dst.mean(dim=-2)
    t = cd - torch.einsum("...ij,...j->...i", R, cs)
    return se3.Pose(R, t)


def triangles_ok(p: torch.Tensor, min_sin: float = 1e-2) -> torch.Tensor:
    """Validity of 3-point minimal samples p [..., 3, 3]: non-collinear and
    distinct (|u x v| > min_sin |u||v|, with |u|, |v| > 1e-6)."""
    u = p[..., 1, :] - p[..., 0, :]
    v = p[..., 2, :] - p[..., 0, :]
    nu = torch.linalg.norm(u, dim=-1)
    nv = torch.linalg.norm(v, dim=-1)
    area = torch.linalg.norm(torch.linalg.cross(u, v, dim=-1), dim=-1)
    return (nu > 1e-6) & (nv > 1e-6) & (area > min_sin * nu * nv)


def nearest_neighbors(query: torch.Tensor, target: torch.Tensor):
    """Brute-force 1-NN of each query point [Nq, 3] in target [Nt, 3]
    (invalid points at PAD_VALUE). Returns (sq_dist [Nq], index [Nq]
    int32), the lowest index winning exact ties. Kernel K3 on CUDA tensors
    at any shape; its plain version on CPU tensors."""
    return kernels.nearest_neighbors(query.contiguous(), target.contiguous())


def nearest_select(query: torch.Tensor, payload: torch.Tensor):
    """1-NN with fused per-match payload selection.

    payload [P, Nt]: rows 0-2 are the target cloud (invalid points already
    at PAD_VALUE), rows 3.. per-point extras (validity mask, normals, ...).
    Returns (sq_dist [Nq], selected payload [P, Nq]), the lowest target
    index winning exact ties. Kernel K4 on CUDA tensors at any shape; its
    plain version on CPU tensors.
    """
    return kernels.nn_select(query.contiguous(), payload.contiguous())


def _icp_stage(
    src, smask, payload, init: se3.Pose, max_iters, max_corr_dist, tol,
    gate_fitness=float("inf"),
):
    """One ICP loop at a fixed correspondence resolution, stopping at
    ``delta < tol``, at an armed stall or when hopeless (a host loop that
    reads the done flag once per iteration). Returns (pose, delta,
    converged, last_ms, last_ngood): the last two are the fitness
    statistics of the final iteration (what ``reuse_final_fitness``
    reports)."""
    dtype, dev = src.dtype, src.device
    eye = torch.eye(3, dtype=dtype, device=dev)
    pose = init
    delta = torch.tensor(float("inf"), dtype=dtype, device=dev)
    stall = torch.zeros((), dtype=torch.int32, device=dev)
    ms = torch.tensor(float("inf"), dtype=dtype, device=dev)
    n_good = torch.zeros((), dtype=dtype, device=dev)
    i = 0
    done = False
    while i < max_iters and not done:
        moved = se3.transform_points(pose, src)
        d2, sel = nearest_select(moved, payload)
        matched = sel[:3].T
        good = smask & (sel[3] > 0.5) & (d2 < max_corr_dist * max_corr_dist)
        w = good.to(dtype)
        update = kabsch(moved, matched, w)
        pose = se3.compose(update, pose)
        ndelta = torch.linalg.norm(update.t) + torch.linalg.norm(update.R - eye)
        n_good = torch.sum(w)
        ms = torch.where(
            n_good > 0,
            torch.sum(torch.where(good, d2, 0.0)) / torch.clamp(n_good, min=1.0),
            float("inf"),
        )
        stall = torch.where(ndelta < STALL_RATIO * delta, 0, stall + 1).to(torch.int32)
        delta = ndelta
        stalled = stall >= STALL_PATIENCE
        stall_armed = delta < STALL_ABS_FACTOR * tol
        hopeless = stalled & (ms > HOPELESS_MARGIN * gate_fitness)
        done = bool((delta < tol) | (stall_armed & stalled) | hopeless)
        i += 1
    return pose, delta, delta < tol, ms, n_good


def icp(
    source: Cloud,
    target: Cloud,
    init: se3.Pose | None = None,
    max_iters: int = 30,
    max_corr_dist: float = 10.0,
    tol: float = 1e-6,
    coarse_factor: int = 1,
    gate_fitness: float = float("inf"),
    target_stride: int = 1,
    reuse_final_fitness: bool = False,
) -> ICPResult:
    """Point-to-point ICP of source [N, 3] onto target [M, 3] with early
    exit at the update-norm tolerance (see the JAX function for each
    option). Fitness is the mean squared correspondence distance over
    matches within ``max_corr_dist``, always at full resolution: the final
    iteration's statistics when ``reuse_final_fitness``, else one more NN
    pass at the returned pose.
    """
    dtype, dev = source.xyz.dtype, source.xyz.device
    if init is None:
        init = se3.identity(dtype=dtype, device=dev)
    tgt = torch.where(target.mask[:, None], target.xyz, PAD_VALUE)
    src = source.xyz.contiguous()
    smask = source.mask
    payload = torch.cat(
        [tgt.T, target.mask[None].to(dtype)], dim=0
    ).contiguous()                                                  # [4, M]

    f = coarse_factor
    if f > 1 and src.shape[0] % f == 0 and payload.shape[1] % f == 0:
        init, _, _, _, _ = _icp_stage(
            src[::f].contiguous(), smask[::f], payload[:, ::f].contiguous(),
            init, max_iters, max_corr_dist, COARSE_TOL_FACTOR * tol, gate_fitness,
        )
    s = target_stride
    if s > 1 and payload.shape[1] % s == 0:
        init, _, _, _, _ = _icp_stage(
            src, smask, payload[:, ::s].contiguous(), init,
            max_iters, max_corr_dist, COARSE_TOL_FACTOR * tol, gate_fitness,
        )
    pose, delta, converged, last_ms, last_ng = _icp_stage(
        src, smask, payload, init, max_iters, max_corr_dist, tol, gate_fitness,
    )

    if reuse_final_fitness:
        n_good = last_ng
        fitness = torch.where(n_good > 0, last_ms, float("inf"))
    else:
        d2, sel = nearest_select(se3.transform_points(pose, src), payload)
        good = smask & (sel[3] > 0.5) & (d2 < max_corr_dist * max_corr_dist)
        n_good = torch.sum(good)
        fitness = torch.where(
            n_good > 0,
            torch.sum(torch.where(good, d2, 0.0)) / torch.clamp(n_good, min=1),
            float("inf"),
        )
    inlier_frac = n_good / torch.clamp(torch.sum(smask), min=1)
    return ICPResult(pose, fitness, inlier_frac, converged)


def _point_to_plane_terms(src, smask, payload, pose, max_corr_dist):
    """One 1-NN pass of the point-to-plane ICP at ``pose``: (moved
    sources, their signed plane residuals r = n . (moved - t), their
    weights, good [N])."""
    moved = se3.transform_points(pose, src)
    d2, sel = nearest_select(moved, payload)
    good = smask & (sel[3] > 0.5) & (d2 < max_corr_dist * max_corr_dist)
    n = sel[4:7].T
    r = torch.sum(n * (moved - sel[:3].T), dim=-1)
    return moved, n, r, good


def icp_point_to_plane(
    source: Cloud,
    target: Cloud,
    target_normals: torch.Tensor,
    init: se3.Pose | None = None,
    max_iters: int = 20,
    max_corr_dist: float = 2.0,
    damping: float = 1e-6,
    tol: float = 1e-4,
) -> ICPResult:
    """Point-to-plane ICP: Gauss-Newton on se(3) of sum over
    correspondences of (n_k . (T(s_k) - t_k))^2, the left-multiplicative
    update ``exp(xi) * pose`` from the 6 x 6 damped normal equations.

    The 1-NN and the winner's target point, validity and normal come from
    one pass over the payload [8, Nt] (xyz at PAD_VALUE where invalid,
    the mask, the normals, a zero row): kernel K4 on CUDA tensors. The
    JAX ``while_loop`` is a host loop that reads the update norm once an
    iteration and stops at ``delta < tol``. The fitness is the mean
    squared plane residual over the good correspondences of a last pass at
    the returned pose. ``target_normals``: [Nt, 3] unit normals.
    """
    dtype, dev = source.xyz.dtype, source.xyz.device
    if init is None:
        init = se3.identity(dtype=dtype, device=dev)
    tgt = torch.where(target.mask[:, None], target.xyz, PAD_VALUE)
    src = source.xyz.contiguous()
    smask = source.mask
    payload = torch.cat(
        [
            tgt.T,
            target.mask[None].to(dtype),
            target_normals.T.to(dtype),
            torch.zeros((1, tgt.shape[0]), dtype=dtype, device=dev),
        ],
        dim=0,
    ).contiguous()                                                  # [8, Nt]
    eye6 = damping * torch.eye(6, dtype=dtype, device=dev)
    pose = init
    delta = float("inf")
    delta_t = torch.tensor(delta, dtype=dtype, device=dev)
    i = 0
    while i < max_iters and delta >= tol:
        moved, n, r, good = _point_to_plane_terms(src, smask, payload, pose, max_corr_dist)
        w = good.to(dtype)
        # the residual's Jacobian in the left twist (omega, v): (moved x n, n)
        J = torch.cat([torch.linalg.cross(moved, n, dim=-1), n], dim=-1)   # [N, 6]
        H = (J * w[:, None]).T @ J + eye6
        b = -(J.T @ (w * r))
        xi = torch.linalg.solve(H, b)
        pose = se3.compose(se3.exp(xi), pose)
        delta_t = torch.linalg.norm(xi)
        delta = float(delta_t)
        i += 1
    _moved, _n, r, good = _point_to_plane_terms(src, smask, payload, pose, max_corr_dist)
    n_good = torch.sum(good)
    fitness = torch.where(
        n_good > 0,
        torch.sum(torch.where(good, r * r, 0.0)) / torch.clamp(n_good, min=1),
        float("inf"),
    )
    inlier_frac = n_good / torch.clamp(torch.sum(smask), min=1)
    return ICPResult(pose, fitness, inlier_frac, delta_t < tol)


def _recentred(payload: torch.Tensor):
    """(center [B, 3], payload [B, 4, Nt] moved by -center): each lane's
    valid-target centroid (row 3 is the validity), where the expanded
    distance form and the uncentered moment sums keep their precision."""
    tmask = payload[:, 3] > 0.5                              # [B, Nt]
    msum = torch.clamp(tmask.sum(dim=-1), min=1)
    center = (
        torch.where(tmask[:, None, :], payload[:, :3], 0.0).sum(dim=-1) / msum[:, None]
    )                                                        # [B, 3]
    payload_c = payload.clone()
    payload_c[:, :3] -= center[:, :, None]
    return center, payload_c


def _matches_batched(src, smask, payload, pose, lanes, max_corr_dist, exact=False):
    """Batched NN pass for the lanes in ``lanes``; the others get
    (d2=inf, sel=0) and so no good correspondence.

    As the JAX function, in its precedence: under ``MXU_NN`` (unless
    ``exact``) and where :func:`_tile_shapes_ok` holds, kernel K8 selects
    on coordinates recentred at each lane's valid-target centroid and the
    winner's distance is recomputed exactly; else under ``NN_INDEX`` (and
    the rule) kernel K7 gives the index and one gather the payload; else
    kernel K1 with ``SELECT_VARIANT``. ``exact=True`` (the final fitness
    pass and the RANSAC 1-NN) never takes K8.
    """
    nq, nt = src.shape[1], payload.shape[2]
    rule = _tile_shapes_ok(nq, nt)
    moved = se3.transform_points(pose, src)                 # [B, N, 3]
    if MXU_NN and rule and not exact:
        # the expanded form's absolute error is eps * |coords|^2
        center, payload_c = _recentred(payload)
        _, sel = kernels.nn_select_batched_mxu(
            (moved - center[:, None, :]).contiguous(), payload_c, lanes
        )
        sel[:, :3] += center[:, :, None]
        matched = sel[:, :3].transpose(-1, -2)               # [B, N, 3]
        # the exact distance of the selected pair
        d2 = torch.where(lanes[:, None], _sq_norm3(moved - matched), float("inf"))
    else:
        if NN_INDEX and rule:
            d2, idx = kernels.nn_index_batched(moved.contiguous(), payload, lanes)
            P = payload.shape[1]
            sel = payload.gather(2, idx.long()[:, None, :].expand(-1, P, -1))
            # inactive lanes: index 0 gathers a real column; zero it so that
            # no correspondence is good (the select kernels' contract)
            sel = torch.where(lanes[:, None, None], sel, 0.0)
        else:
            d2, sel = kernels.nn_select_batched(
                moved.contiguous(), payload, lanes, variant=SELECT_VARIANT
            )
        matched = sel[:, :3].transpose(-1, -2)               # [B, N, 3]
    good = smask & (sel[:, 3] > 0.5) & (d2 < max_corr_dist * max_corr_dist)
    return moved, d2, matched, good


def _advance_lanes(update, ms, R, t, delta, stall, done, tol, gate_fitness):
    """One batched ICP iteration's lane bookkeeping: the running lanes take
    ``update`` (composed onto their pose) and its norm as their delta; a
    lane stops at ``delta < tol``, at an armed stall, or when hopeless
    (``ms``, its mean squared correspondence distance, far above the gate).
    Frozen lanes keep everything. Returns (R, t, delta, stall, done)."""
    new_pose = se3.compose(update, se3.Pose(R, t))
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    ndelta = torch.linalg.norm(update.t, dim=-1) + torch.linalg.norm(
        update.R - eye, dim=(-2, -1)
    )
    R = torch.where(done[:, None, None], R, new_pose.R)
    t = torch.where(done[:, None], t, new_pose.t)
    stall = torch.where(
        done, stall,
        torch.where(ndelta < STALL_RATIO * delta, 0, stall + 1).to(torch.int32),
    )
    delta = torch.where(done, delta, ndelta)
    stalled = stall >= STALL_PATIENCE
    stall_armed = delta < STALL_ABS_FACTOR * tol
    hopeless = stalled & (ms > HOPELESS_MARGIN * gate_fitness)
    done = done | (delta < tol) | (stall_armed & stalled) | hopeless
    return R, t, delta, stall, done


def _icp_stage_batched(
    src, smask, payload, R0, t0, done0, max_iters, max_corr_dist, tol,
    gate_fitness=float("inf"),
):
    """Batched-lane ICP loop at one correspondence resolution.

    Returns (R, t, delta, done, last_ms, last_ngood), with each lane's
    mean-squared correspondence distance and inlier count from its last
    active iteration (what ``reuse_final_fitness`` reports). A lane stops
    at ``delta < tol``, at an armed stall, or when hopeless; the loop
    stops when every lane has.
    """
    B = src.shape[0]
    dtype, dev = src.dtype, src.device
    R, t = R0, t0
    delta = torch.full((B,), float("inf"), dtype=dtype, device=dev)
    stall = torch.zeros((B,), dtype=torch.int32, device=dev)
    done = done0
    last_ms = torch.full((B,), float("inf"), dtype=dtype, device=dev)
    last_ng = torch.zeros((B,), dtype=dtype, device=dev)
    i = 0
    while i < max_iters and bool((~done).any()):
        moved, d2, matched, good = _matches_batched(
            src, smask, payload, se3.Pose(R, t), ~done, max_corr_dist
        )
        w = good.to(dtype)
        update = kabsch(moved, matched, w)
        n_good = w.sum(dim=-1)
        ms = torch.where(
            n_good > 0,
            torch.where(good, d2, 0.0).sum(dim=-1) / torch.clamp(n_good, min=1.0),
            float("inf"),
        )
        last_ms = torch.where(done, last_ms, ms)
        last_ng = torch.where(done, last_ng, n_good)
        R, t, delta, stall, done = _advance_lanes(
            update, ms, R, t, delta, stall, done, tol, gate_fitness
        )
        i += 1
    return R, t, delta, done, last_ms, last_ng


def _kabsch_from_moments(m: torch.Tensor) -> se3.Pose:
    """Rigid update from kernel K5's moment sums m [B, 18]: :func:`kabsch`
    on (moved, matched, w), with the weighted cross-covariance rebuilt from
    uncentered moments (the caller recentres the problem near the origin,
    so the subtraction is well-conditioned). Lanes with no correspondence
    return the identity."""
    sw_raw = m[:, kernels.M_W]
    sw = torch.clamp(sw_raw, min=1e-9)[:, None]
    mu_s = m[:, kernels.M_S : kernels.M_S + 3] / sw
    mu_d = m[:, kernels.M_D : kernels.M_D + 3] / sw
    cross = m[:, kernels.M_CROSS : kernels.M_CROSS + 9].reshape(-1, 3, 3) / sw[:, :, None]
    H = cross - mu_s[:, :, None] * mu_d[:, None, :]
    U, _, Vt = torch.linalg.svd(H)
    det = torch.linalg.det(Vt.transpose(-1, -2) @ U.transpose(-1, -2))
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    R = torch.einsum("bji,bj,bkj->bik", Vt, D, U)
    t = mu_d - torch.einsum("bij,bj->bi", R, mu_s)
    none = sw_raw < 0.5
    eye = torch.eye(3, dtype=m.dtype, device=m.device)
    return se3.Pose(
        torch.where(none[:, None, None], eye, R), torch.where(none[:, None], 0.0, t)
    )


def _icp_stage_batched_fused(
    src4, payload4, R0, t0, done0, max_iters, max_corr_dist, tol,
    gate_fitness=float("inf"),
):
    """Batched-lane ICP at one resolution, each iteration one kernel K5
    pass (transform, 1-NN, gate, moment sums) and [B, 3, 3] glue; a host
    loop that reads ``any(~done)`` once per iteration. src4 [B, 4, Nq]
    local source rows + validity; payload4 [B, 4, Nt]. Returns (R, t,
    delta, done); lane semantics as :func:`_icp_stage_batched`."""
    B = src4.shape[0]
    dtype, dev = src4.dtype, src4.device
    R, t = R0, t0
    delta = torch.full((B,), float("inf"), dtype=dtype, device=dev)
    stall = torch.zeros((B,), dtype=torch.int32, device=dev)
    done = done0
    i = 0
    while i < max_iters and bool((~done).any()):
        m = kernels.icp_moments_batched(
            src4, payload4, R.contiguous(), t.contiguous(), ~done, max_corr_dist,
            variant=SELECT_VARIANT,
        )
        n_good = m[:, kernels.M_W]
        ms = torch.where(
            n_good > 0, m[:, kernels.M_WD2] / torch.clamp(n_good, min=1.0), float("inf")
        )
        R, t, delta, stall, done = _advance_lanes(
            _kabsch_from_moments(m), ms, R, t, delta, stall, done, tol, gate_fitness
        )
        i += 1
    return R, t, delta, done


def icp_batched(
    source: Cloud,
    target: Cloud,
    init: se3.Pose,
    active: torch.Tensor,
    max_iters: int = 30,
    max_corr_dist: float = 10.0,
    tol: float = 1e-6,
    coarse_factor: int = 1,
    gate_fitness: float = float("inf"),
    target_stride: int = 1,
    reuse_final_fitness: bool = False,
) -> ICPResult:
    """B independent point-to-point ICPs, lane semantics as B solo runs
    with early exit (see the JAX function for each option).

    source/target: Clouds with a leading batch dim ([B, N, 3] / [B, N]);
    init: batched Pose; active [B] bool (inactive lanes return
    fitness=inf). ``coarse_factor`` > 1 runs a strided coarse stage first;
    ``target_stride`` > 1 a mid-resolution stage; fitness is always from
    full resolution — the final iteration's statistics when
    ``reuse_final_fitness`` (not under ``MXU_NN``), else one more exact NN
    pass.

    Under ``FUSED_ICP``, where :func:`_tile_shapes_ok` holds at full
    resolution and, when the coarse stage runs, at ``(nq // f, nt // f)``,
    every iteration is one kernel K5 pass on the problem recentred at each
    lane's valid-target centroid; that path ignores ``target_stride`` and
    ``reuse_final_fitness`` (its fitness comes from one more K5 pass over
    ``active``) and reckons ``inlier_frac`` over the valid source points
    of active lanes, as the JAX function does.
    """
    dtype = source.xyz.dtype
    tgt = torch.where(target.mask[..., None], target.xyz, PAD_VALUE)
    payload = torch.cat(
        [tgt.transpose(-1, -2), target.mask[:, None, :].to(dtype)], dim=1
    ).contiguous()                                               # [B, 4, M]
    src = source.xyz.contiguous()
    smask = source.mask
    nq, nt = src.shape[1], payload.shape[2]
    f = coarse_factor
    coarse_ok = f > 1 and nq % f == 0 and nt % f == 0
    done0 = ~active

    if (
        FUSED_ICP
        and _tile_shapes_ok(nq, nt)
        and (not coarse_ok or _tile_shapes_ok(nq // f, nt // f))
    ):
        return _icp_batched_fused(
            source, payload, init, active, max_iters, max_corr_dist, tol,
            f if coarse_ok else 1, gate_fitness,
        )

    R0, t0 = init.R, init.t
    if coarse_ok:
        R0, t0, _, _, _, _ = _icp_stage_batched(
            src[:, ::f].contiguous(), smask[:, ::f], payload[:, :, ::f].contiguous(),
            R0, t0, done0, max_iters, max_corr_dist,
            COARSE_TOL_FACTOR * tol, gate_fitness,
        )
    s = target_stride
    if s > 1 and nt % s == 0:
        R0, t0, _, _, _, _ = _icp_stage_batched(
            src, smask, payload[:, :, ::s].contiguous(),
            R0, t0, done0, max_iters, max_corr_dist,
            COARSE_TOL_FACTOR * tol, gate_fitness,
        )
    R, t, delta, done, last_ms, last_ng = _icp_stage_batched(
        src, smask, payload, R0, t0, done0, max_iters, max_corr_dist, tol,
        gate_fitness,
    )
    pose = se3.Pose(R, t)

    if reuse_final_fitness and not MXU_NN:
        # under MXU_NN the iteration statistics carry its selection noise:
        # the exact pass below stays (as in JAX)
        n_good = last_ng
        fitness = torch.where((n_good > 0) & active, last_ms, float("inf"))
    else:
        _moved, d2, _matched, good = _matches_batched(
            src, smask, payload, pose, active, max_corr_dist, exact=True
        )
        n_good = good.sum(dim=-1)
        fitness = torch.where(
            (n_good > 0) & active,
            torch.where(good, d2, 0.0).sum(dim=-1) / torch.clamp(n_good, min=1),
            float("inf"),
        )
    inlier_frac = n_good / torch.clamp(smask.sum(dim=-1), min=1)
    return ICPResult(pose, fitness, inlier_frac, (delta < tol) & active)


def _icp_batched_fused(
    source, payload, init, active, max_iters, max_corr_dist, tol, f, gate_fitness,
) -> ICPResult:
    """:func:`icp_batched`'s ``FUSED_ICP`` branch: recentre at each lane's
    valid-target centroid (moment-form Kabsch subtracts uncentered sums),
    run the coarse stage on every f-th source and target point (f > 1),
    then the full stage, and take the fitness from one more K5 pass over
    ``active``."""
    dtype = source.xyz.dtype
    center, payload_c = _recentred(payload)
    src4 = torch.cat(
        [source.xyz.transpose(-1, -2), source.mask[:, None, :].to(dtype)], dim=1
    ).contiguous()                                               # [B, 4, Nq]
    done0 = ~active
    R0, t0 = init.R, init.t - center
    if f > 1:
        R0, t0, _, _ = _icp_stage_batched_fused(
            src4[:, :, ::f].contiguous(), payload_c[:, :, ::f].contiguous(),
            R0, t0, done0, max_iters, max_corr_dist, COARSE_TOL_FACTOR * tol,
            gate_fitness,
        )
    R, t, delta, _ = _icp_stage_batched_fused(
        src4, payload_c, R0, t0, done0, max_iters, max_corr_dist, tol, gate_fitness,
    )
    m = kernels.icp_moments_batched(
        src4, payload_c, R.contiguous(), t.contiguous(), active, max_corr_dist,
        variant=SELECT_VARIANT,
    )
    n_good = m[:, kernels.M_W]
    fitness = torch.where(
        (n_good > 0) & active,
        m[:, kernels.M_WD2] / torch.clamp(n_good, min=1.0),
        float("inf"),
    )
    inlier_frac = n_good / torch.clamp(m[:, kernels.M_NSRC], min=1.0)
    return ICPResult(se3.Pose(R, t + center), fitness, inlier_frac, (delta < tol) & active)


class RansacResult(NamedTuple):
    pose: se3.Pose
    inlier_ratio: torch.Tensor
    num_inliers: torch.Tensor
    success: torch.Tensor


_M32 = 0xFFFFFFFF
_HASH_MUL = 0x45D9F3B  # < 2**27, so a product with a 32-bit value fits int64


def _hash32(x):
    """A 32-bit integer mixing hash on int64 tensors or Python ints holding
    values in [0, 2**32): shifts, xors and products below 2**63, so torch's
    integer ops give the same bits on every device."""
    x = x ^ (x >> 16)
    x = (x * _HASH_MUL) & _M32
    x = x ^ (x >> 16)
    x = (x * _HASH_MUL) & _M32
    return x ^ (x >> 16)


def ransac_samples(
    valid: torch.Tensor, num_hypotheses: int, sample_size: int, seed: int,
    attempt: int,
) -> torch.Tensor:
    """[H, sample_size] indices of minimal samples among the ``valid`` [N]
    correspondences, without replacement within a hypothesis.

    Each (hypothesis, point) gets a 32-bit hash of (seed, attempt, h, n) as
    its priority; a hypothesis takes the ``sample_size`` valid points of
    highest priority (point index breaks priority ties, so the keys are
    distinct and the choice is the same on every device). Top-k of i.i.d.
    uniform priorities is a uniform sample without replacement, as the JAX
    package's gumbel top-k is. With fewer valid points than
    ``sample_size`` the rest are invalid ones (the hypothesis then fails
    :func:`triangles_ok` or scores on invalid points only).
    """
    n = valid.shape[0]
    if n >= 1 << 20:
        raise ValueError(f"ransac_samples supports fewer than 2**20 points, got {n}")
    base = _hash32((_hash32(seed & _M32) ^ (attempt & _M32)) & _M32)
    dev = valid.device
    pts = torch.arange(n, dtype=torch.int64, device=dev)
    ctr = torch.arange(num_hypotheses, dtype=torch.int64, device=dev)[:, None] * n + pts
    prio = _hash32(_hash32(ctr & _M32) ^ base)               # [H, N] in [0, 2**32)
    key = torch.where(valid[None, :], prio * (1 << 20) + pts, pts - (1 << 20))
    return torch.topk(key, sample_size, dim=-1).indices


def _transform_each(R: torch.Tensor, t: torch.Tensor, pts: torch.Tensor):
    """Points [..., N, 3] under poses (R [..., 3, 3], t [..., 3]), the
    leading axes broadcast: pts [N, 3] under H poses gives [H, N, 3], lanes
    [B, N, 3] under B poses give [B, N, 3]. Per coordinate in a fixed order,
    ``((R_i0*x + R_i1*y) + R_i2*z) + t_i`` (separate elementwise ops round
    alike on every device, where a matmul's summation order is the
    library's; K6 uses the same order)."""
    x, y, z = (pts[..., c : c + 1] for c in range(3))       # [..., N, 1]
    Rc = [R[..., None, :, c] for c in range(3)]              # [..., 1, 3]
    return ((Rc[0] * x + Rc[1] * y) + Rc[2] * z) + t[..., None, :]


def _sq_norm3(d: torch.Tensor) -> torch.Tensor:
    """((dx*dx) + (dy*dy)) + (dz*dz) over the last axis, in that order."""
    return (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]


def ransac_align(
    source: Cloud,
    target: Cloud,
    seed: int,
    attempt: int,
    num_hypotheses: int = 256,
    inlier_thresh: float = 0.25,
    min_inlier_ratio: float = 0.45,
    refine: bool = True,
    samples: torch.Tensor | None = None,
) -> RansacResult:
    """RANSAC rigid alignment over nearest-neighbor correspondences (the
    inter-robot verification; see the JAX function for the reference
    mapping): 1-NN correspondences (kernel K3 on CUDA tensors),
    ``num_hypotheses`` 3-point fits (:func:`rigid_from_triangles`, the
    JAX function's default ``sample_size``; its Kabsch branch for larger
    samples is not carried) scored as one batch by inlier count, the best
    refined by one weighted Kabsch over its inliers. Accept iff the inlier
    ratio >= ``min_inlier_ratio``.

    The minimal samples come from :func:`ransac_samples` with (``seed``,
    ``attempt``), unless ``samples`` [H, 3] is given (a test passes the
    indices JAX's gumbel top-k drew).
    """
    dtype = source.xyz.dtype
    tgt = torch.where(target.mask[:, None], target.xyz, PAD_VALUE)
    _, idx = nearest_neighbors(source.xyz, tgt)
    idx = idx.long()
    corr_valid = source.mask & target.mask[idx]
    matched = tgt[idx]                                        # [N, 3]
    if samples is None:
        samples = ransac_samples(corr_valid, num_hypotheses, 3, seed, attempt)
    samples = samples.long()

    src_s = source.xyz[samples]                               # [H, 3, 3]
    dst_s = matched[samples]
    hyp = rigid_from_triangles(src_s, dst_s)
    # both triangles must determine a rigid map (see the JAX function)
    hyp_ok = triangles_ok(src_s) & triangles_ok(dst_s)

    thr2 = inlier_thresh * inlier_thresh
    moved = _transform_each(hyp.R, hyp.t, source.xyz)        # [H, N, 3]
    res2 = _sq_norm3(moved - matched[None])                   # [H, N]
    inl = (res2 < thr2) & corr_valid[None, :]
    counts = torch.where(hyp_ok, inl.sum(dim=-1), -1)
    best = torch.argmax(counts)                               # first maximum
    any_valid = counts[best] >= 0
    eye3 = torch.eye(3, dtype=dtype, device=dst_s.device)
    best_pose = se3.Pose(
        torch.where(any_valid, hyp.R[best], eye3),
        torch.where(any_valid, hyp.t[best], torch.zeros_like(hyp.t[best])),
    )
    best_inl = inl[best] & any_valid

    if refine:
        w = best_inl.to(dtype)
        refined = kabsch(source.xyz, matched, torch.clamp(w, min=1e-12))
        moved_r = _transform_each(refined.R[None], refined.t[None], source.xyz)[0]
        inl_r = (_sq_norm3(moved_r - matched) < thr2) & corr_valid
        # no valid hypothesis: keep the identity and the empty inlier set
        # (the JAX function explains why the refine must not be adopted)
        use_refined = any_valid & (inl_r.sum() >= best_inl.sum())
        best_pose = se3.Pose(
            torch.where(use_refined, refined.R, best_pose.R),
            torch.where(use_refined, refined.t, best_pose.t),
        )
        best_inl = torch.where(use_refined, inl_r, best_inl)

    num_inliers = best_inl.sum()
    n_corr = torch.clamp(corr_valid.sum(), min=1)
    ratio = num_inliers / n_corr
    return RansacResult(best_pose, ratio, num_inliers, ratio >= min_inlier_ratio)


def ransac_uniforms(
    B: int, num_hypotheses: int, sample_size: int, seed: int, step: int, device,
) -> torch.Tensor:
    """[B, H, sample_size] f32 uniforms in [0, 1) on a 2**-24 grid: the top
    24 bits of a 32-bit hash of (seed, step, lane, hypothesis, sample), in
    torch integer ops, so every device draws the same values."""
    base = _hash32((_hash32(seed & _M32) ^ (step & _M32)) & _M32)
    n = B * num_hypotheses * sample_size
    ctr = torch.arange(n, dtype=torch.int64, device=device) & _M32
    bits = _hash32(_hash32(ctr) ^ base) >> 8                      # 24 bits
    u = bits.to(torch.float32) * (1.0 / (1 << 24))
    return u.reshape(B, num_hypotheses, sample_size)


def ransac_align_batched(
    source: Cloud,
    target: Cloud,
    seed: int,
    step: int,
    active: torch.Tensor,
    num_hypotheses: int = 256,
    inlier_thresh: float = 0.25,
    min_inlier_ratio: float = 0.45,
    refine: bool = True,
    uniforms: torch.Tensor | None = None,
) -> RansacResult:
    """B independent :func:`ransac_align` runs at once (the fleet's
    inter-robot verification; see the JAX function for the reference
    mapping).

    Steps: the ungated exact 1-NN pass of every active lane (kernel K1, or
    K7 under ``NN_INDEX``; inactive lanes get no correspondence); per lane
    ``num_hypotheses`` minimal samples by the inverse CDF over the valid
    correspondences (a uniform
    times the lane's count of them, then a searchsorted over their
    cumulative count: with replacement, duplicates rejected by
    :func:`triangles_ok`); closed-form triangle fits; scoring by inlier
    count (kernel K6); the first best valid hypothesis, its inlier set,
    and one weighted Kabsch refine over it, adopted when it keeps at least
    as many inliers (never on a lane without a valid hypothesis).

    source/target: Clouds [B, N, 3] / [B, M, 3]; active [B] bool. The
    uniforms come from :func:`ransac_uniforms` with (``seed``, ``step``)
    unless ``uniforms`` [B, H, 3] is given (a test passes JAX's own).
    Inactive lanes return the identity with ``success=False``.
    """
    B, n = source.xyz.shape[:2]
    dtype, dev = source.xyz.dtype, source.xyz.device
    H = num_hypotheses
    tgt = torch.where(target.mask[..., None], target.xyz, PAD_VALUE)
    payload = torch.cat(
        [tgt.transpose(-1, -2), target.mask[:, None, :].to(dtype)], dim=1
    ).contiguous()                                               # [B, 4, M]
    src = source.xyz.contiguous()
    # big-but-finite gate: the correspondences are ungated; validity comes
    # from the masks
    _, _, matched, good = _matches_batched(
        src, source.mask, payload, se3.identity((B,), dtype=dtype, device=dev),
        active, 1e6, exact=True,
    )                                         # matched [B, N, 3], good [B, N]
    matched = matched.contiguous()

    cnt = torch.cumsum(good.to(torch.int32), dim=-1)               # [B, N]
    n_good_pts = cnt[:, -1]
    if uniforms is None:
        uniforms = ransac_uniforms(B, H, 3, seed, step, dev)
    u = uniforms.to(dtype) * torch.clamp(n_good_pts, min=1).to(dtype)[:, None, None]
    samples = torch.searchsorted(
        cnt.to(dtype).contiguous(), u.reshape(B, -1), right=True
    ).reshape(B, H, 3)
    samples = torch.clamp(samples, max=n - 1)       # lanes with n_good = 0
    bidx = torch.arange(B, device=dev)
    src_s = src[bidx[:, None, None], samples]                     # [B, H, 3, 3]
    dst_s = matched[bidx[:, None, None], samples]
    hyp = rigid_from_triangles(src_s, dst_s)                      # [B, H] poses
    hyp_ok = triangles_ok(src_s) & triangles_ok(dst_s)

    thr2 = inlier_thresh * inlier_thresh
    counts = kernels.ransac_counts_batched(
        src, matched, good, hyp.R.contiguous(), hyp.t.contiguous(), thr2
    )
    counts = torch.where(hyp_ok, counts, -1)
    best = torch.argmax(counts, dim=-1)             # first maximum
    any_valid = counts[bidx, best] >= 0
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    best_pose = se3.Pose(
        torch.where(any_valid[:, None, None], hyp.R[bidx, best], eye3),
        torch.where(any_valid[:, None], hyp.t[bidx, best], 0.0),
    )

    def inliers_of(pose):
        moved = _transform_each(pose.R, pose.t, src)              # [B, N, 3]
        return (_sq_norm3(moved - matched) < thr2) & good

    best_inl = inliers_of(best_pose) & any_valid[:, None]
    if refine:
        w = best_inl.to(dtype)
        refined = kabsch(src, matched, torch.clamp(w, min=1e-12))
        inl_r = inliers_of(refined)
        use_r = any_valid & (inl_r.sum(dim=-1) >= best_inl.sum(dim=-1))
        best_pose = se3.Pose(
            torch.where(use_r[:, None, None], refined.R, best_pose.R),
            torch.where(use_r[:, None], refined.t, best_pose.t),
        )
        best_inl = torch.where(use_r[:, None], inl_r, best_inl)

    num_inliers = best_inl.sum(dim=-1)
    n_corr = torch.clamp(good.sum(dim=-1), min=1)
    ratio = torch.where(active, num_inliers / n_corr, 0.0)
    pose = se3.Pose(
        torch.where(active[:, None, None], best_pose.R, eye3),
        torch.where(active[:, None], best_pose.t, 0.0),
    )
    return RansacResult(pose, ratio, num_inliers, active & (ratio >= min_inlier_ratio))
