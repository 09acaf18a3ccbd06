"""Point-to-point ICP for loop verification (port of the replay and live
paths' part of ``scl_slam_tpu/ops/registration.py``).

Ported: ``kabsch``; the solo path ``nearest_select`` (kernel K4 on CUDA
tensors), ``_icp_stage`` and ``icp``; the batched path ``_matches_batched``
(the default branch: exact per-coordinate NN, kernel K1 on CUDA tensors),
``_icp_stage_batched`` and ``icp_batched`` (the non-fused branch). Both
keep the coarse stage, the optional target-stride stage, the stall and
hopeless exits and ``reuse_final_fitness``. The JAX ``lax.while_loop`` is
a host loop that reads the done flag(s) once per iteration. The solo path
does not go through K1: K1 averages the payload over exact ties, the solo
contract takes the lowest index. ``nearest_neighbors`` (K3), point-to-plane
ICP, RANSAC and the fused-moments path are not ported yet (ROADMAP queues 1
and 2).
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


def _matches_batched(src, smask, payload, pose, lanes, max_corr_dist):
    """Batched NN pass for the lanes in ``lanes``; the others get
    (d2=inf, sel=0) from K1 and so no good correspondence."""
    moved = se3.transform_points(pose, src)                 # [B, N, 3]
    d2, sel = kernels.nn_select_batched(moved, payload, lanes)
    matched = sel[:, :3].transpose(-1, -2)                   # [B, N, 3]
    good = smask & (sel[:, 3] > 0.5) & (d2 < max_corr_dist * max_corr_dist)
    return moved, d2, matched, good


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
    eye = torch.eye(3, dtype=dtype, device=dev)
    R, t = R0, t0
    delta = torch.full((B,), float("inf"), dtype=dtype, device=dev)
    stall = torch.zeros((B,), dtype=torch.int32, device=dev)
    done = done0
    last_ms = torch.full((B,), float("inf"), dtype=dtype, device=dev)
    last_ng = torch.zeros((B,), dtype=dtype, device=dev)
    i = 0
    while i < max_iters and bool((~done).any()):
        pose = se3.Pose(R, t)
        moved, d2, matched, good = _matches_batched(
            src, smask, payload, pose, ~done, max_corr_dist
        )
        w = good.to(dtype)
        update = kabsch(moved, matched, w)
        new_pose = se3.compose(update, pose)
        ndelta = torch.linalg.norm(update.t, dim=-1) + torch.linalg.norm(
            update.R - eye, dim=(-2, -1)
        )
        n_good = w.sum(dim=-1)
        ms = torch.where(
            n_good > 0,
            torch.where(good, d2, 0.0).sum(dim=-1) / torch.clamp(n_good, min=1.0),
            float("inf"),
        )
        R = torch.where(done[:, None, None], R, new_pose.R)
        t = torch.where(done[:, None], t, new_pose.t)
        last_ms = torch.where(done, last_ms, ms)
        last_ng = torch.where(done, last_ng, n_good)
        stall = torch.where(
            done, stall,
            torch.where(ndelta < STALL_RATIO * delta, 0, stall + 1).to(torch.int32),
        )
        delta = torch.where(done, delta, ndelta)
        stalled = stall >= STALL_PATIENCE
        stall_armed = delta < STALL_ABS_FACTOR * tol
        hopeless = stalled & (ms > HOPELESS_MARGIN * gate_fitness)
        done = done | (delta < tol) | (stall_armed & stalled) | hopeless
        i += 1
    return R, t, delta, done, last_ms, last_ng


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
    ``reuse_final_fitness``, else one more exact NN pass.
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
    done0 = ~active

    R0, t0 = init.R, init.t
    if f > 1 and nq % f == 0 and nt % f == 0:
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

    if reuse_final_fitness:
        n_good = last_ng
        fitness = torch.where((n_good > 0) & active, last_ms, float("inf"))
    else:
        _moved, d2, _matched, good = _matches_batched(
            src, smask, payload, pose, active, max_corr_dist
        )
        n_good = good.sum(dim=-1)
        fitness = torch.where(
            (n_good > 0) & active,
            torch.where(good, d2, 0.0).sum(dim=-1) / torch.clamp(n_good, min=1),
            float("inf"),
        )
    inlier_frac = n_good / torch.clamp(smask.sum(dim=-1), min=1)
    return ICPResult(pose, fitness, inlier_frac, (delta < tol) & active)
