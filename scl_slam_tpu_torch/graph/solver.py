"""Manifold Gauss-Newton pose-graph solver (port of
``scl_slam_tpu/graph/solver.py``).

Per-edge 6x6 Jacobian blocks are the closed form of what the JAX module
takes by forward-mode autodiff of the f32 residual (``jacfwd``): the SE(3)
right Jacobian inverse and an adjoint, a handful of batched 6x6 products
where autodiff through the log and exp costs hundreds of small launches,
times one map that carries the residual's f32 arccos (``_arccos_tangent``).
That map matters: so3.log's angle is ``arccos(cos_t)``, which turns one
rounding of ``cos_t`` into ~1e-5 rad near a 3e-3 rad optimum, and
forward mode takes arccos's tangent at that same rounded ``cos_t``, which
scales the Jacobian's axial row by the inverse factor, so the gradient
J^T W r carries no such noise and f32 Gauss-Newton settles. The exact
Jacobian alone leaves the noise in the gradient, and f32 Gauss-Newton
kept stepping ~1e-3 m at its optimum (``tests/test_torch_chain_solver.py``
holds both against the JAX module).

The Gauss-Newton matrix is never formed: it is applied matrix-free with
gathers and ``index_add_`` scatter-sums, and solved by preconditioned
conjugate gradients (block-Jacobi 6x6 Cholesky, plus optional coarse
levels). The iteration counts are fixed (the JAX ``scan``s
are Python loops), so no step reads a value back to the host.

The Jacobian blocks are kept as [E, 6, 6]; the JAX module transposes them to
[6, 6, E] for the TPU's (8, 128) tiling, which a GPU does not need. On CUDA,
``index_add_`` sums with atomics in an order that changes from run to run,
so two solves of one graph on the card agree to f32 rounding, not bit for
bit (``tests/test_torch_solver.py`` states the tolerance against JAX).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3, so3
from . import factors as F


class SolveResult(NamedTuple):
    poses: se3.Pose
    chi2_history: torch.Tensor   # [gn_iters + 1]
    cg_residuals: torch.Tensor   # [gn_iters] final CG residual norms
    delta_norms: torch.Tensor    # [gn_iters] update magnitudes
    # 0-d int32, the port's own: 0 while no step broke down, else the
    # first Gauss-Newton step that did and its flags (breakdown_stages)
    breakdown: torch.Tensor


# the per-step flags of SolveResult.breakdown, one bit each: the linear
# system (the block diagonal or the right-hand side) non-finite, a 6x6
# block of the block-Jacobi preconditioner not factored or its inverse
# non-finite, the coarse levels' start of PCG non-finite, a PCG step's
# curvature p.Ap <= 0 while r.z > 0 (its step size then comes from the
# 1e-30 clamp), its r.z <= 0 (the preconditioned residual norm: PCG stops
# there, see solve), a PCG step size (alpha or beta) non-finite, the PCG
# solution non-finite, the step after the coarse post-correction
# non-finite, the chi2 after the retraction non-finite
BREAKDOWN_FLAGS = (
    "linear system", "block-Jacobi", "coarse start", "p.Ap <= 0", "r.z <= 0",
    "PCG step size", "PCG solution", "coarse correction", "chi2",
)


def breakdown_stages(code: int) -> str:
    """A SolveResult.breakdown code in words ("" for 0)."""
    code = int(code)
    if code == 0:
        return ""
    step, mask = divmod(code - 1, 1 << len(BREAKDOWN_FLAGS))
    names = [n for b, n in enumerate(BREAKDOWN_FLAGS) if mask >> b & 1]
    return f"GN step {step}: " + ", ".join(names)


def _edge_pose(xi_i, xi_j, Ti_R, Ti_t, Tj_R, Tj_t, z_R, z_t) -> se3.Pose:
    """z^-1 (Ti exp(xi_i))^-1 (Tj exp(xi_j)): the pose whose log is the
    edge residual."""
    Ti = se3.retract(se3.Pose(Ti_R, Ti_t), xi_i)
    Tj = se3.retract(se3.Pose(Tj_R, Tj_t), xi_j)
    return se3.compose(se3.inverse(se3.Pose(z_R, z_t)), se3.between(Ti, Tj))


def _prior_pose(xi, T_R, T_t, z_R, z_t) -> se3.Pose:
    """z^-1 T exp(xi): the pose whose log is the prior residual."""
    T = se3.retract(se3.Pose(T_R, T_t), xi)
    return se3.compose(se3.inverse(se3.Pose(z_R, z_t)), T)


def _se3_left_jacobian_inv(xi: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian of SE(3) at twists xi [..., 6] (omega, v):
    [[Jl^-1, 0], [-Jl^-1 Q Jl^-1, Jl^-1]], with Jl the SO(3) left Jacobian
    of omega and Q its coupling block (Barfoot, State Estimation for
    Robotics, eq. 7.86). The coefficients switch to their Taylor series
    below theta = 1, where the closed forms cancel in f32."""
    w, v = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1.0
    safe2 = torch.where(small, torch.ones_like(theta2), theta2)
    th = torch.sqrt(safe2)
    s, c = torch.sin(th), torch.cos(th)
    t4 = theta2 * theta2
    c1 = torch.where(   # (th - sin th) / th^3
        small, 1.0 / 6.0 - theta2 / 120.0 + t4 / 5040.0 - theta2 * t4 / 362880.0,
        (th - s) / (safe2 * th),
    )
    c2 = torch.where(   # (th^2 / 2 + cos th - 1) / th^4
        small, 1.0 / 24.0 - theta2 / 720.0 + t4 / 40320.0 - theta2 * t4 / 3628800.0,
        (0.5 * safe2 + c - 1.0) / (safe2 * safe2),
    )
    c3 = torch.where(   # (th - sin th - th^3 / 6) / th^5
        small,
        -1.0 / 120.0 + theta2 / 5040.0 - t4 / 362880.0 + theta2 * t4 / 39916800.0,
        (th - s - safe2 * th / 6.0) / (safe2 * safe2 * th),
    )
    W, V = so3.hat(w), so3.hat(v)
    WV, VW = W @ V, V @ W
    WVW = WV @ W
    WW = W @ W
    Q = (
        0.5 * V
        + c1[..., None, None] * (WV + VW + WVW)
        + c2[..., None, None] * (W @ WV + VW @ W - 3.0 * WVW)
        + (0.5 * (c2 + 3.0 * c3))[..., None, None] * (WVW @ W + WW @ VW)
    )
    Ji = so3.left_jacobian_inv(w)
    zeros = torch.zeros_like(Ji)
    top = torch.cat([Ji, zeros], dim=-1)
    bottom = torch.cat([-(Ji @ Q @ Ji), Ji], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def _edge_jac(r, Ti: se3.Pose, Tj: se3.Pose):
    """Per-edge Jacobians (d r / d xi_i, d r / d xi_j) at xi = 0 of
    r = log(z^-1 Ti^-1 Tj) under the right retraction T exp(xi): Jr^-1(r)
    for xi_j, and -Jr^-1(r) Ad(Tj^-1 Ti) for xi_i, with
    Jr^-1(r) = Jl^-1(-r). The JAX module takes them by forward-mode
    autodiff (``vmap(jacfwd)``); the closed form is held equal to it in
    ``tests/test_torch_solver.py``."""
    Jr_inv = _se3_left_jacobian_inv(-r)
    return -(Jr_inv @ se3.adjoint(se3.between(Tj, Ti))), Jr_inv


def _prior_jac(r):
    """Per-prior Jacobian d r / d xi at xi = 0 of r = log(z^-1 T exp(xi))."""
    return _se3_left_jacobian_inv(-r)


def _arccos_tangent(T: se3.Pose) -> torch.Tensor:
    """The 6x6 map M, [..., 6, 6], that takes the exact Jacobian of log(T)
    to the derivative of the f32 residual as forward mode takes it (the
    JAX module's ``jacfwd``): in so3.log's generic branch the angle is
    theta_q = arccos(cos_t) of the rounded cos_t, and its tangent is
    d cos_t / sqrt(1 - cos_t^2) at that same cos_t. So the axial row of
    d omega scales by kappa = sin(theta) / sqrt(1 - cos_t^2), the other
    two by theta_q / theta (theta the exact angle, atan2(|u| / 2, cos_t)),
    and d v = d(Jl^-1(omega) t) takes the change through 0.5 hat(t) (its
    first order in omega). The series and near-pi branches take no arccos
    of cos_t, and M is the identity there. cos_t is so3.log's (the same
    operations on the same matrix)."""
    R = so3.orthonormalize(T.R)
    cos_t = torch.clamp((R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0) * 0.5, -1.0, 1.0)
    u = so3.vee(R - R.transpose(-1, -2))
    generic = (cos_t <= 1.0 - 1e-6) & (cos_t >= -1.0 + 1e-6)
    one = torch.ones_like(cos_t)
    n = torch.sqrt(torch.where(generic, torch.sum(u * u, dim=-1), one))
    c = torch.where(generic, cos_t, torch.zeros_like(cos_t))
    theta = torch.atan2(0.5 * n, c)
    kappa = torch.where(generic, 0.5 * n * torch.rsqrt((1.0 - c) * (1.0 + c)), one)
    rho = torch.where(generic, torch.arccos(c) / theta, one)
    a = u / n[..., None]
    aa = a[..., :, None] * a[..., None, :]
    eye3 = torch.eye(3, dtype=R.dtype, device=R.device).expand_as(aa)
    A_I = (kappa - 1.0)[..., None, None] * aa + (rho - 1.0)[..., None, None] * (eye3 - aa)
    M = torch.eye(6, dtype=R.dtype, device=R.device).repeat(*R.shape[:-2], 1, 1)
    M[..., :3, :3] += A_I
    M[..., 3:, :3] = 0.5 * so3.hat(T.t) @ A_I
    return M


def huber_weight(r_norm2: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weight for the Huber kernel on the weighted residual norm."""
    r = torch.sqrt(torch.clamp(r_norm2, min=1e-12))
    return torch.where(r <= delta, 1.0, delta / r)


def _linearize(g: F.FactorGraph, poses: se3.Pose, huber_delta: float):
    """Residuals, Jacobian blocks [E, 6, 6] / [P, 6, 6], and IRLS x noise x
    validity weights at ``poses``. Returns (r_e, Ji, Jj, w_e, r_p, Jp, w_p)."""
    E = g.edge_capacity
    zeros6 = poses.t.new_zeros((E, 6))
    Ti = se3.take(poses, g.i)
    Tj = se3.take(poses, g.j)
    T_e = _edge_pose(zeros6, zeros6, Ti.R, Ti.t, Tj.R, Tj.t, g.z.R, g.z.t)
    r_e = se3.log(T_e)
    M_e = _arccos_tangent(T_e)
    Ji, Jj = (M_e @ J for J in _edge_jac(r_e, Ti, Tj))

    zerosP = poses.t.new_zeros((g.prior_capacity, 6))
    Tp = se3.take(poses, g.prior_idx)
    T_p = _prior_pose(zerosP, Tp.R, Tp.t, g.prior_z.R, g.prior_z.t)
    r_p = se3.log(T_p)
    Jp = _arccos_tangent(T_p) @ _prior_jac(r_p)

    # weights: diagonal information * robust kernel * validity mask
    info_e = g.sqrt_info ** 2
    wr_e = r_e * g.sqrt_info
    rho_e = huber_weight(torch.sum(wr_e * wr_e, dim=-1), huber_delta)
    w_e = info_e * (rho_e * g.edge_mask())[:, None]
    w_p = g.prior_sqrt_info ** 2 * g.prior_mask()[:, None]
    return r_e, Ji, Jj, w_e, r_p, Jp, w_p


def _scatter_add(n: int, idx: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Sum of ``rows`` into ``n`` slots by index (``zeros.at[idx].add``)."""
    out = rows.new_zeros((n,) + rows.shape[1:])
    return out.index_add_(0, idx.long(), rows)


# The products below are batched matmuls rather than einsums: the PCG loop
# is host-bound on the card (tens of small launches a step), and an einsum
# costs several times a matmul's host time to dispatch.
def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched A x: A [..., m, n], x [..., n] -> [..., m]."""
    return (A @ x[..., None])[..., 0]


def _mtv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched A^T x: A [..., m, n], x [..., m] -> [..., n]."""
    return (x[..., None, :] @ A)[..., 0, :]


def _JtWJ(Ja: torch.Tensor, w: torch.Tensor, Jb: torch.Tensor) -> torch.Tensor:
    """Per-factor blocks Ja^T diag(w) Jb: [F, 6, 6]."""
    return Ja.transpose(-1, -2) @ (w[..., None] * Jb)


def _apply_H(x, idx, Ji, Jj, w_e, Jp, w_p, D_damp_only):
    """y = (J^T W J + damping) x, matrix-free. x, y: [N, 6]; ``idx`` the
    (edge i, edge j, prior) index tensors as int64."""
    gi, gj, gp = idx
    u = (_mv(Ji, x[gi]) + _mv(Jj, x[gj])) * w_e
    y = torch.zeros_like(x)
    y.index_add_(0, gi, _mtv(Ji, u))
    y.index_add_(0, gj, _mtv(Jj, u))
    y.index_add_(0, gp, _mtv(Jp, _mv(Jp, x[gp]) * w_p))
    # damping term (D_damp_only holds just the added diagonal part)
    return y + _mv(D_damp_only, x)


def _cholesky(A: torch.Tensor):
    """Cholesky factor and a failure flag per matrix, never raising (the
    JAX factorization returns NaN where this one reports ``info != 0``)."""
    L, info = torch.linalg.cholesky_ex(A)
    bad = (info != 0) | torch.isnan(L).any(dim=-1).any(dim=-1)
    return L, bad


def _cho_inverse(L: torch.Tensor) -> torch.Tensor:
    """(L L^T)^-1 = L^-T L^-1 from the Cholesky factors [..., n, n]: the
    block-Jacobi preconditioner is then one batched matmul a PCG step
    instead of two batched triangular solves (one launch, where the step
    is bound by launches)."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand_as(L)
    L_inv = torch.linalg.solve_triangular(L, eye, upper=False)
    return L_inv.transpose(-1, -2) @ L_inv


def make_dense_coarse(
    cur_poses: se3.Pose,
    Ji, Jj, Jp,             # Jacobian blocks [E, 6, 6] / [P, 6, 6]
    w_e, w_p,               # [E, 6] / [P, 6] weights (validity folded in)
    gi, gj, p_idx,          # endpoint indices of the edge/prior arrays
    n_poses: int,
    stride_l: int,
):
    """Assemble and factor the dense Galerkin coarsest level; return its
    solve ``coarse_apply(v) -> [N, 6]`` (P A_c^-1 P^T v with one iterative
    refinement step; the zero map if no factorization is finite).

    The coarse space, the flat-index assembly in chunk copies, the f32
    equilibration and the shift ladder follow the JAX function, whose
    inline notes give the reasons for each.
    """
    dtype, dev = Ji.dtype, Ji.device
    gi, gj, p_idx = gi.long(), gj.long(), p_idx.long()
    C = (n_poses + stride_l - 1) // stride_l
    cidx = torch.arange(n_poses, device=dev) // stride_l
    n6 = C * 6
    assert n6 * n6 < 2**31, (
        "dense coarse level too big; raise coarse_stride or coarse_levels"
    )
    u = (torch.arange(n_poses, dtype=dtype, device=dev) + 0.5) / stride_l - 0.5
    cn0 = torch.clamp(torch.floor(u).long(), 0, C - 1)
    cn1 = torch.clamp(cn0 + 1, max=C - 1)
    wn1 = torch.clamp(u - cn0.to(dtype), 0.0, 1.0)
    wn0 = 1.0 - wn1

    # cell centroids of the current translations
    t_cur = cur_poses.t
    m_c = _scatter_add(C, cidx, t_cur) / torch.clamp(
        _scatter_add(C, cidx, torch.ones_like(t_cur[:, 0])), min=1.0
    )[:, None]
    RT = cur_poses.R.transpose(-1, -2)

    def pblock(node, w):
        """[N, 6, 6] body-frame prolongation blocks (weight folded in): a
        world rigid twist about the cell centroid, seen from pose k."""
        skew_r = so3.hat(t_cur - m_c[node])
        top = torch.cat([RT, torch.zeros_like(RT)], dim=-1)
        bot = torch.cat([-(RT @ skew_r), RT], dim=-1)
        return torch.cat([top, bot], dim=-2) * w[:, None, None]

    P0 = pblock(cn0, wn0)
    P1 = pblock(cn1, wn1)

    slots_e = [
        (cn0[gi], Ji @ P0[gi]),
        (cn1[gi], Ji @ P1[gi]),
        (cn0[gj], Jj @ P0[gj]),
        (cn1[gj], Jj @ P1[gj]),
    ]
    slots_p = [(cn0[p_idx], Jp @ P0[p_idx]), (cn1[p_idx], Jp @ P1[p_idx])]
    a6 = torch.arange(6, device=dev)

    def rows(c):
        return c[:, None] * 6 + a6

    def flat_blk(r, c):
        return (r[:, :, None] * n6 + c[:, None, :]).reshape(-1, 36)

    # chunk copies cut the serial depth of the scatter-sums (JAX note)
    E_local = Ji.shape[0]
    K = 1
    while K < 256 and stride_l // K > 64 and 2 * K * n6 * n6 * 4 <= (1 << 30):
        K *= 2
    chunk = (torch.arange(E_local, device=dev) % K) * (n6 * n6)
    Hc = torch.zeros((K * n6 * n6,), dtype=dtype, device=dev)
    for na, Ka in slots_e:
        for nb, Kb in slots_e:
            idx = flat_blk(rows(na), rows(nb)) + chunk[:, None]
            Hc.index_add_(0, idx.reshape(-1), _JtWJ(Ka, w_e, Kb).reshape(-1))
    Hc = Hc.reshape(K, n6 * n6).sum(0)
    for na, Ka in slots_p:
        for nb, Kb in slots_p:
            Hc.index_add_(
                0, flat_blk(rows(na), rows(nb)).reshape(-1), _JtWJ(Ka, w_p, Kb).reshape(-1)
            )
    Hc = Hc.reshape(n6, n6)
    Hc = 0.5 * (Hc + Hc.T)
    eyen = torch.eye(n6, dtype=dtype, device=dev)
    # invertibility floor for empty supernodes only
    eps_c = 1e-8 * torch.max(torch.diagonal(Hc)) + 1e-12
    Hc = Hc + eps_c * eyen
    sc = torch.rsqrt(torch.clamp(torch.diagonal(Hc), min=1e-20))
    Hc_eq = Hc * sc[:, None] * sc[None, :] + 1e-6 * eyen
    # shift ladder: escalate until the factorization is finite, else drop
    # the coarse term
    Lc, bad = _cholesky(Hc_eq)
    for shift in (1e-3, 1e-1):
        retry, retry_bad = _cholesky(Hc_eq + shift * eyen)
        Lc = torch.where(bad, retry, Lc)
        bad = torch.where(bad, retry_bad, bad)
    coarse_ok = (~bad).to(dtype)
    Lc = torch.where(bad, eyen, Lc)
    # the factor's inverse, once: every PCG step applies the coarse solve,
    # and two dense triangular solves of 1,536 unknowns (the 4,096-pose
    # KITTI capacity) are sequential on the card (~90 us each) where two
    # matrix-vector products are not
    Lc_inv = torch.linalg.solve_triangular(Lc, eyen, upper=False)

    def solve_eq(r):
        return Lc_inv.T @ (Lc_inv @ r)

    def coarse_apply(v):
        vc = _scatter_add(C, cn0, _mtv(P0, v))
        vc.index_add_(0, cn1, _mtv(P1, v))
        r_eq = sc * vc.reshape(-1)
        y = solve_eq(r_eq)
        y = y + solve_eq(r_eq - Hc_eq @ y)
        yc = (y * sc).reshape(C, 6) * coarse_ok
        return _mv(P0, yc[cn0]) + _mv(P1, yc[cn1])

    return coarse_apply


def auto_coarse(n_poses: int) -> tuple[int, int]:
    """Preconditioner hierarchy from the pose count (``coarse_stride = -1``):
    none up to 2,048 poses, else stride 16 with enough levels that the
    dense coarsest grid stays at most 256 supernodes."""
    if n_poses <= 2048:
        return 0, 1
    stride, levels = 16, 1
    while n_poses / stride**levels > 256:
        levels += 1
    return stride, levels


def solve(
    g: F.FactorGraph,
    poses: se3.Pose,
    gn_iters: int = 10,
    cg_iters: int = 64,
    damping: float = 1e-6,
    huber_delta: float = 1e9,
    coarse_stride: int = 0,
    coarse_levels: int = 1,
) -> SolveResult:
    """Damped Gauss-Newton with PCG inner solves, over the whole
    fixed-capacity pose array (slots without factors are held in place by
    damping). ``coarse_stride`` > 0 adds coarse levels to the
    preconditioner (-1: :func:`auto_coarse`); see the JAX function for the
    multilevel scheme and the coarse-first start and post-correction.
    """
    n_poses = poses.t.shape[0]
    if coarse_stride < 0:
        coarse_stride, coarse_levels = auto_coarse(n_poses)
    dtype, dev = poses.t.dtype, poses.t.device
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    gi, gj, gp = g.i.long(), g.j.long(), g.prior_idx.long()

    cur = poses
    chi2s, cg_res, dnorms = [F.chi2(g, poses)], [], []
    breakdown = torch.zeros((), dtype=torch.int32, device=dev)
    flag_bits = 1 << torch.arange(len(BREAKDOWN_FLAGS), dtype=torch.int32, device=dev)
    for step in range(gn_iters):
        r_e, Ji, Jj, w_e, r_p, Jp, w_p = _linearize(g, cur, huber_delta)

        # block diagonal of J^T W J, and the damping blocks that keep
        # factor-less pose slots invertible
        Hi = _JtWJ(Ji, w_e, Ji)
        Hj = _JtWJ(Jj, w_e, Jj)
        Hp = _JtWJ(Jp, w_p, Jp)
        H_diag = _scatter_add(n_poses, gi, Hi)
        H_diag.index_add_(0, gj, Hj).index_add_(0, gp, Hp)
        mag = torch.clamp(torch.diagonal(H_diag, dim1=-2, dim2=-1).max(dim=-1).values, min=1.0)
        damp_blocks = (damping * mag + 1e-6)[:, None, None] * eye6
        D = H_diag + damp_blocks

        # rhs b = -J^T W r
        b = _scatter_add(n_poses, gi, -_mtv(Ji, w_e * r_e))
        b.index_add_(0, gj, -_mtv(Jj, w_e * r_e))
        b.index_add_(0, gp, -_mtv(Jp, w_p * r_p))

        # block-Jacobi preconditioner: the exact inverse of each 6x6 block
        # (from its Cholesky factor)
        L_D, bad_D = _cholesky(D)
        D_inv = _cho_inverse(L_D)

        if coarse_stride > 0:
            Hij = _JtWJ(Ji, w_e, Jj)
            jacobi_levels = []  # (cidx, scale, cholesky) per mid level
            for lvl in range(1, coarse_levels + 1):
                stride_l = coarse_stride**lvl
                C = (n_poses + stride_l - 1) // stride_l
                cidx = torch.arange(n_poses, device=dev) // stride_l
                ci, cj, cp = cidx[gi], cidx[gj], cidx[gp]
                if lvl < coarse_levels:
                    # Galerkin supernode diagonal; row C is the dump slot
                    # for edges between supernodes
                    Dl = _scatter_add(C + 1, ci, Hi)
                    Dl.index_add_(0, cj, Hj).index_add_(0, cp, Hp)
                    dump = torch.where(ci == cj, ci, C)
                    Dl.index_add_(0, dump, Hij + Hij.transpose(1, 2))
                    Dl = Dl[:C].clone().index_add_(0, cidx, damp_blocks)
                    sl = torch.rsqrt(
                        torch.clamp(torch.diagonal(Dl, dim1=1, dim2=2), min=1e-20)
                    )                                            # [C, 6]
                    Dl_eq = Dl * sl[:, :, None] * sl[:, None, :] + 1e-5 * eye6
                    Ll, badb = _cholesky(Dl_eq)
                    retry, retry_bad = _cholesky(Dl_eq + 1e-2 * eye6)
                    Ll = torch.where(badb[:, None, None], retry, Ll)
                    still = badb & retry_bad
                    Ll = torch.where(still[:, None, None], eye6, Ll)
                    jacobi_levels.append((cidx, sl, _cho_inverse(Ll)))
                else:
                    coarse_apply = make_dense_coarse(
                        cur, Ji, Jj, Jp, w_e, w_p, g.i, g.j, g.prior_idx,
                        n_poses, stride_l,
                    )

            def precond(v):
                z = _mv(D_inv, v)
                for cidx_l, sl, Dl_inv in jacobi_levels:
                    vc = _scatter_add(Dl_inv.shape[0], cidx_l, v)
                    z = z + (_mv(Dl_inv, sl * vc) * sl)[cidx_l]
                return z + coarse_apply(v)
        else:

            def precond(v):
                return _mv(D_inv, v)

        def Hx(v):
            return _apply_H(v, (gi, gj, gp), Ji, Jj, w_e, Jp, w_p, damp_blocks)

        # PCG, fixed iterations; a coarse-first start where there is a
        # coarse level (see the JAX function for why)
        if coarse_stride > 0:
            x = coarse_apply(b)
            r = b - Hx(x)
            bad_start = ~torch.isfinite(x).all()
        else:
            x = torch.zeros_like(b)
            r = b
            bad_start = bad_D.new_zeros(())
        def dot(a, c):
            return torch.dot(a.reshape(-1), c.reshape(-1))

        # r.z is clamped at 0: in f32 the preconditioner (its coarse term is
        # one refinement step on an approximate inverse) can turn indefinite
        # on a residual, and a step with r.z <= 0 then made beta ~1e30 and
        # the update non-finite (about one start in 30 at 4,096 poses on an
        # H100). With r.z = 0, alpha and beta are 0, so r does not move:
        # PCG stops at its last iterate, or restarts from p = z where r.z
        # recomputed from that r comes back above 0. Where r.z > 1e-30 the
        # steps are the JAX function's (beta = r.z' / max(r.z, 1e-30)).
        z = precond(r)
        p = z
        rz_raw = [dot(r, z)]
        rz = torch.clamp(rz_raw[0], min=0.0)
        curvatures, steps = [], []
        for _ in range(cg_iters):
            Ap = Hx(p)
            pAp = dot(p, Ap)
            curvatures.append(pAp)
            alpha = rz / torch.clamp(pAp, min=1e-30)
            x = torch.addcmul(x, alpha, p)
            r = torch.addcmul(r, alpha, Ap, value=-1.0)
            z = precond(r)
            rz_raw.append(dot(r, z))
            rz2 = torch.clamp(rz_raw[-1], min=0.0)
            # 0 after a stop (r.z = 0): r.z recomputed from the same r can
            # come back a rounding above 0, and a restart from p = z is
            # then a steepest-descent step, not a step of ~1e30
            beta = torch.nan_to_num(rz2 / rz, nan=0.0, posinf=0.0)
            steps += [alpha, beta]
            p = torch.addcmul(z, beta, p)
            rz = rz2
        dx = x
        if coarse_stride > 0:
            # post coarse correction against the undamped operator
            dx = dx + coarse_apply(b - (Hx(dx) - _mv(damp_blocks, dx)))

        cur = se3.retract(cur, dx)
        chi2s.append(F.chi2(g, cur))
        cg_res.append(torch.linalg.norm(r))
        dnorms.append(torch.linalg.norm(dx))
        # where this step broke down, if it did (no host read: a handful of
        # launches against the step's thousands)
        flags = torch.stack([
            ~(torch.isfinite(H_diag).all() & torch.isfinite(b).all()),
            bad_D.any() | ~torch.isfinite(D_inv).all(),
            bad_start,
            ((torch.stack(curvatures) <= 0) & (torch.stack(rz_raw[:-1]) > 0)).any()
            if curvatures else bad_D.new_zeros(()),
            (torch.stack(rz_raw) <= 0).any(),
            ~torch.isfinite(torch.stack(steps)).all() if steps else bad_D.new_zeros(()),
            ~torch.isfinite(x).all(),
            ~torch.isfinite(dx).all(),
            ~torch.isfinite(chi2s[-1]),
        ])
        mask = (flags.to(torch.int32) * flag_bits).sum().to(torch.int32)
        code = 1 + step * (1 << len(BREAKDOWN_FLAGS)) + mask
        breakdown = torch.where((breakdown == 0) & (mask != 0), code, breakdown)
    empty = poses.t.new_zeros((0,))
    return SolveResult(
        poses=cur,
        chi2_history=torch.stack(chi2s),
        cg_residuals=torch.stack(cg_res) if cg_res else empty,
        delta_norms=torch.stack(dnorms) if dnorms else empty,
        breakdown=breakdown,
    )
