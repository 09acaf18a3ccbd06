"""Full 15-state IMU factors: pose + velocity + bias window smoothing (port
of ``scl_slam_tpu/graph/imu_factor.py``).

On-manifold preintegration factors (Forster et al., TRO 2017) over a
sliding window of states ``x_k = (R_k, p_k, v_k, b^g_k, b^a_k)``, with
scan-matching relative-pose factors, a prior on the first state and a bias
random walk. Each Gauss-Newton step re-preintegrates every interval at the
current bias estimate, as the JAX module does.

The JAX module takes the Jacobian by ``jax.jacfwd`` through the
re-preintegration, over all 15n variables. Here it is a closed form
(:func:`_linearize`):

- the rotation, position and velocity blocks from the manifold
  derivatives (at an orthonormal R, ``orthonormalize``'s derivative is the
  identity on the tangent);
- the six bias columns of each interval carried by hand through the same
  sample loop as the integration (``runtime/imu.integrate(...,
  tangents=True)``): only node i's biases enter interval i's
  preintegration;
- every row that passes through ``so3.log`` times the map that gives it
  the tangent of the f32 arccos as forward mode takes it
  (``solver._arccos_tangent``; see ``graph/solver.py`` for why f32
  Gauss-Newton settles where JAX's does only with it).

The step is dense: Jacobi equilibration, damping, Cholesky, one step of
iterative refinement, accepted only if chi2 improves. No step reads a
value back to the host.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import se3, so3
from ..runtime import imu as imu_mod
from .solver import _arccos_tangent, _se3_left_jacobian_inv


class ImuStates(NamedTuple):
    """Batched window states [N]."""

    R: torch.Tensor    # [N, 3, 3]
    p: torch.Tensor    # [N, 3]
    v: torch.Tensor    # [N, 3]
    bg: torch.Tensor   # [N, 3] gyro bias
    ba: torch.Tensor   # [N, 3] accel bias


class ImuWindowData(NamedTuple):
    """Raw IMU samples per interval, padded to a fixed count M with dt = 0
    (ignored by the integrator)."""

    accel: torch.Tensor  # [N-1, M, 3] specific force (body frame)
    gyro: torch.Tensor   # [N-1, M, 3]
    dt: torch.Tensor     # [N-1, M]


class ImuFactorConfig(NamedTuple):
    gravity: float = 9.81
    # per-sqrt-second noise densities
    gyro_noise: float = 1.5e-3
    accel_noise: float = 4e-2
    gyro_walk: float = 3.5e-5
    accel_walk: float = 6.4e-5
    # scan-matching relative pose factor sigmas (rot, trans)
    odom_rot_sigma: float = 1e-2
    odom_trans_sigma: float = 1e-1
    # first-state prior sigmas
    prior_rot_sigma: float = 1e-3
    prior_trans_sigma: float = 1e-3
    prior_vel_sigma: float = 1.0
    prior_bias_sigma: float = 0.1
    # the largest information weight (1/sigma): the bias walk's raw ~6e4
    # loses the bias common mode in the f32 solve (see the JAX module)
    weight_cap: float = 1e4


def make_states(n: int, device="cuda") -> ImuStates:
    dev = torch.device(device)
    z = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    return ImuStates(
        R=torch.eye(3, dtype=torch.float32, device=dev).repeat(n, 1, 1),
        p=z, v=z.clone(), bg=z.clone(), ba=z.clone(),
    )


def imu_states_to_numpy(x: ImuStates) -> ImuStates:
    """The states with numpy leaves (the JAX ``ImuStates``' fields)."""
    return ImuStates(*(a.detach().cpu().numpy() for a in x))


def imu_states_from_numpy(x, device="cuda") -> ImuStates:
    """:class:`ImuStates` (f32) on ``device`` from any object with the
    fields ``R``, ``p``, ``v``, ``bg``, ``ba`` holding arrays, such as the
    JAX ``ImuStates`` or :func:`imu_states_to_numpy`'s."""
    dev = torch.device(device)
    return ImuStates(*(
        torch.as_tensor(np.array(getattr(x, f)), device=dev).to(torch.float32)
        for f in ImuStates._fields
    ))


def retract(x: ImuStates, delta: torch.Tensor) -> ImuStates:
    """x (+) delta with delta [N, 15] = (d theta, dp, dv, dbg, dba)."""
    return ImuStates(
        R=so3.orthonormalize(x.R @ so3.exp(delta[:, 0:3])),
        p=x.p + delta[:, 3:6],
        v=x.v + delta[:, 6:9],
        bg=x.bg + delta[:, 9:12],
        ba=x.ba + delta[:, 12:15],
    )


def _mv(A, x):
    return torch.einsum("...ij,...j->...i", A, x)


def _weights(T: torch.Tensor, cfg: ImuFactorConfig):
    """The capped information weights (w_imu [N-1, 9], w_walk [N-1, 6],
    w_odom [N-1, 6], w_prior [15]) for intervals of total time T [N-1]."""
    m = T.shape[0]
    dtype, dev = T.dtype, T.device

    def full(shape, val):
        return torch.full(shape, val, dtype=dtype, device=dev)

    Tc = torch.clamp(T, min=1e-6)[:, None]
    sT = torch.sqrt(Tc)
    w_imu = torch.cat([
        full((m, 3), 1.0 / cfg.gyro_noise) / sT,
        full((m, 3), 1.0 / cfg.accel_noise) / sT,
        full((m, 3), 1.0 / cfg.accel_noise) / (sT * Tc),
    ], dim=1)
    w_walk = torch.cat([
        full((m, 3), 1.0 / cfg.gyro_walk) / sT,
        full((m, 3), 1.0 / cfg.accel_walk) / sT,
    ], dim=1)
    w_odom = torch.tensor(
        [1.0 / cfg.odom_rot_sigma] * 3 + [1.0 / cfg.odom_trans_sigma] * 3,
        dtype=dtype, device=dev,
    ).repeat(m, 1)
    w_prior = torch.cat([
        full((3,), 1.0 / cfg.prior_rot_sigma), full((3,), 1.0 / cfg.prior_trans_sigma),
        full((3,), 1.0 / cfg.prior_vel_sigma), full((6,), 1.0 / cfg.prior_bias_sigma),
    ])
    cap = cfg.weight_cap
    return tuple(torch.clamp(w, max=cap) for w in (w_imu, w_walk, w_odom, w_prior))


def _terms(x, data, odom_rel, prior, cfg, tangents: bool):
    """Every factor's unweighted residual at x, and what the Jacobian needs.

    Returns (r_imu [N-1, 9], r_walk [N-1, 6], r_odom [N-1, 6], r_prior
    [15], T [N-1], aux) with aux None unless ``tangents``."""
    Ri, pi, vi = x.R[:-1], x.p[:-1], x.v[:-1]
    Rj, pj, vj = x.R[1:], x.p[1:], x.v[1:]
    pre, tan = imu_mod.integrate(
        data.accel, data.gyro, data.dt, x.bg[:-1], x.ba[:-1], tangents=tangents
    )
    g = torch.tensor([0.0, 0.0, -cfg.gravity], dtype=x.p.dtype, device=x.p.device)
    T = pre.dt_total[:, None]
    RiT = Ri.transpose(-1, -2)
    E_imu = pre.delta_R.transpose(-1, -2) @ (RiT @ Rj)
    r_R = so3.log(E_imu)
    y_v = _mv(RiT, vj - vi - g * T)
    y_p = _mv(RiT, pj - pi - vi * T - 0.5 * g * T * T)
    r_imu = torch.cat([r_R, y_v - pre.delta_v, y_p - pre.delta_p], dim=1)

    r_walk = torch.cat([x.bg[1:] - x.bg[:-1], x.ba[1:] - x.ba[:-1]], dim=1)

    pred = se3.between(se3.Pose(Ri, pi), se3.Pose(Rj, pj))
    T_odom = se3.compose(se3.inverse(odom_rel), pred)
    r_odom = se3.log(T_odom)

    E_prior = prior.R[0].T @ x.R[0]
    r_rot0 = so3.log(E_prior)
    r_prior = torch.cat([
        r_rot0, x.p[0] - prior.p[0], x.v[0] - prior.v[0],
        x.bg[0] - prior.bg[0], x.ba[0] - prior.ba[0],
    ])
    aux = None
    if tangents:
        aux = dict(pre=pre, tan=tan, RiT=RiT, E_imu=E_imu, y_v=y_v, y_p=y_p,
                   pred=pred, T_odom=T_odom, E_prior=E_prior)
    return r_imu, r_walk, r_odom, r_prior, pre.dt_total, aux


def residuals(
    x: ImuStates,
    data: ImuWindowData,
    odom_rel: se3.Pose,       # [N-1] scan-matching relative poses i -> i+1
    prior: ImuStates,         # first-state prior (index 0 read)
    cfg: ImuFactorConfig,
) -> torch.Tensor:
    """Weighted residual vector of the whole window: the IMU factors [N-1,
    9], the bias walk [N-1, 6], the relative poses [N-1, 6] and the prior
    [15], each row-major, as the JAX function orders them."""
    r_imu, r_walk, r_odom, r_prior, T, _ = _terms(x, data, odom_rel, prior, cfg, False)
    w_imu, w_walk, w_odom, w_prior = _weights(T, cfg)
    return torch.cat([
        (r_imu * w_imu).reshape(-1), (r_walk * w_walk).reshape(-1),
        (r_odom * w_odom).reshape(-1), r_prior * w_prior,
    ])


def _rot_tangent(E: torch.Tensor) -> torch.Tensor:
    """The arccos map of ``so3.log(E)`` [..., 3, 3] (solver._arccos_tangent
    of a pure rotation)."""
    return _arccos_tangent(se3.Pose(E, torch.zeros_like(E[..., 0])))[..., :3, :3]


def _linearize(x, data, odom_rel, prior, cfg):
    """(r [21(N-1) + 15], J [21(N-1) + 15, 15N]) of :func:`residuals` at
    ``retract(x, 0)`` in the variables delta of ``retract``: what the JAX
    module's ``jacfwd(r_of)(0)`` computes, in closed form."""
    n = x.p.shape[0]
    m = n - 1
    dtype, dev = x.p.dtype, x.p.device
    r_imu, r_walk, r_odom, r_prior, T, a = _terms(x, data, odom_rel, prior, cfg, True)
    w_imu, w_walk, w_odom, w_prior = _weights(T, cfg)
    r = torch.cat([
        (r_imu * w_imu).reshape(-1), (r_walk * w_walk).reshape(-1),
        (r_odom * w_odom).reshape(-1), r_prior * w_prior,
    ])
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    RiT, pre, tan = a["RiT"], a["pre"], a["tan"]
    r_R = r_imu[:, :3]

    # IMU factor of interval i: node i's block A and node i+1's block B
    A = torch.zeros((m, 9, 15), dtype=dtype, device=dev)
    B = torch.zeros_like(A)
    MR = _rot_tangent(a["E_imu"])
    # log(E) with E = dR^T Ri^T Rj: a right perturbation of Rj moves it by
    # Jr^-1(r) = Jl^-1(-r); of Ri (or of dR, by the bias) by -Jl^-1(r) dR^T
    # (or -Jl^-1(r) phi)
    Jl_inv = so3.left_jacobian_inv(r_R)
    A[:, 0:3, 0:3] = MR @ (-Jl_inv @ pre.delta_R.transpose(-1, -2))
    A[:, 0:3, 9:15] = MR @ (-Jl_inv @ tan.phi)
    B[:, 0:3, 0:3] = MR @ so3.left_jacobian_inv(-r_R)
    A[:, 3:6, 0:3] = so3.hat(a["y_v"])
    A[:, 3:6, 6:9] = -RiT
    A[:, 3:6, 9:15] = -tan.v
    B[:, 3:6, 6:9] = RiT
    A[:, 6:9, 0:3] = so3.hat(a["y_p"])
    A[:, 6:9, 3:6] = -RiT
    A[:, 6:9, 6:9] = -RiT * T[:, None, None]
    A[:, 6:9, 9:15] = -tan.p
    B[:, 6:9, 3:6] = RiT
    A = A * w_imu[:, :, None]
    B = B * w_imu[:, :, None]

    # bias random walk
    Aw = torch.zeros((m, 6, 15), dtype=dtype, device=dev)
    Aw[:, 0:3, 9:12] = -eye3
    Aw[:, 3:6, 12:15] = -eye3
    Bw = -Aw
    Aw = Aw * w_walk[:, :, None]
    Bw = Bw * w_walk[:, :, None]

    # relative pose: r = log(z^-1 pred), pred = (Ri^T Rj, Ri^T (pj - pi));
    # each variable moves pred by a right twist (phi, rho), and the log by
    # Jr^-1(r) = _se3_left_jacobian_inv(-r) of it
    K = _arccos_tangent(a["T_odom"]) @ _se3_left_jacobian_inv(-r_odom)
    Kw, Kv = K[..., :3], K[..., 3:]
    RjT_Ri = a["pred"].R.transpose(-1, -2)
    RjT = x.R[1:].transpose(-1, -2)
    Ao = torch.zeros((m, 6, 15), dtype=dtype, device=dev)
    Bo = torch.zeros_like(Ao)
    Ao[:, :, 0:3] = Kw @ (-RjT_Ri) + Kv @ (RjT_Ri @ so3.hat(a["pred"].t))
    Ao[:, :, 3:6] = Kv @ (-RjT)
    Bo[:, :, 0:3] = Kw
    Bo[:, :, 3:6] = Kv @ RjT
    Ao = Ao * w_odom[:, :, None]
    Bo = Bo * w_odom[:, :, None]

    # prior on node 0
    Jp = torch.eye(15, dtype=dtype, device=dev)
    Jp[0:3, 0:3] = _rot_tangent(a["E_prior"]) @ so3.left_jacobian_inv(-r_prior[:3])
    Jp = Jp * w_prior[:, None]

    ar = torch.arange(m, device=dev)
    J_imu = torch.zeros((m, 9, n, 15), dtype=dtype, device=dev)
    J_imu[ar, :, ar, :] = A
    J_imu[ar, :, ar + 1, :] = B
    J_walk = torch.zeros((m, 6, n, 15), dtype=dtype, device=dev)
    J_walk[ar, :, ar, :] = Aw
    J_walk[ar, :, ar + 1, :] = Bw
    J_odom = torch.zeros((m, 6, n, 15), dtype=dtype, device=dev)
    J_odom[ar, :, ar, :] = Ao
    J_odom[ar, :, ar + 1, :] = Bo
    J_prior = torch.zeros((15, n, 15), dtype=dtype, device=dev)
    J_prior[:, 0, :] = Jp
    J = torch.cat([
        J_imu.reshape(9 * m, 15 * n), J_walk.reshape(6 * m, 15 * n),
        J_odom.reshape(6 * m, 15 * n), J_prior.reshape(15, 15 * n),
    ])
    return r, J


def _where_states(c: torch.Tensor, a: ImuStates, b: ImuStates) -> ImuStates:
    return ImuStates(*(torch.where(c, u, w) for u, w in zip(a, b)))


def solve_window(
    x0: ImuStates,
    data: ImuWindowData,
    odom_rel: se3.Pose,
    prior: ImuStates,
    cfg: ImuFactorConfig = ImuFactorConfig(),
    gn_iters: int = 8,
    damping: float = 1e-6,
):
    """Dense Gauss-Newton over the window: ``gn_iters`` steps, each taken
    only if it lowers chi2. Returns (states, chi2 [gn_iters] at the start
    of each step). A failed Cholesky gives a NaN step, which is refused, as
    JAX's NaN factor is."""
    n = x0.p.shape[0]
    dtype, dev = x0.p.dtype, x0.p.device
    zero = torch.zeros((n, 15), dtype=dtype, device=dev)
    eye = torch.eye(15 * n, dtype=dtype, device=dev)
    x = x0
    chis = []
    for _ in range(gn_iters):
        r, J = _linearize(retract(x, zero), data, odom_rel, prior, cfg)
        H = J.T @ J
        # Jacobi equilibration (the weights span ~1e12 in H), damping, one
        # step of iterative refinement (see the JAX module)
        d = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-12))
        Hs = H / (d[:, None] * d[None, :]) + damping * eye
        b = (-(J.T @ r)) / d
        L, info = torch.linalg.cholesky_ex(Hs)
        L = torch.where(info != 0, float("nan"), L)
        y = torch.cholesky_solve(b[:, None], L)[:, 0]
        y = y + torch.cholesky_solve((b - Hs @ y)[:, None], L)[:, 0]
        x2 = retract(x, (y / d).reshape(n, 15))
        r2 = residuals(x2, data, odom_rel, prior, cfg)
        chi2 = torch.sum(r * r)
        x = _where_states(torch.sum(r2 * r2) < chi2, x2, x)
        chis.append(chi2)
    return x, torch.stack(chis)


def _np32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.array(a, np.float32)


class ImuSmoother:
    """Sliding-window pose/velocity/bias smoother over keyframe intervals
    on ``device`` (the card unless ``device="cpu"``): feed it each
    interval's raw IMU samples and scan-matching relative pose; it keeps
    the window, solves, and exposes the velocity and bias estimates."""

    def __init__(
        self,
        window: int = 8,
        max_samples: int = 64,
        cfg: ImuFactorConfig = ImuFactorConfig(),
        device="cuda",
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ImuSmoother runs on the GPU by default and torch.cuda.is_available() "
                "is false; pass device='cpu' to run on the CPU"
            )
        self.window = window
        self.max_samples = max_samples
        self.cfg = cfg
        self._accel: list = []
        self._gyro: list = []
        self._dt: list = []
        self._rel: list = []
        self.states = make_states(window, self.device)
        self._n = 1  # states constrained (the first is the anchor)

    def push_interval(self, accel, gyro, dt, rel_pose: se3.Pose) -> None:
        """One keyframe interval: raw samples (at most ``max_samples``
        kept) and the scan-matching relative pose."""
        M = self.max_samples
        a = np.zeros((M, 3), np.float32)
        g = np.zeros((M, 3), np.float32)
        h = np.zeros((M,), np.float32)
        k = min(len(dt), M)
        a[:k] = np.asarray(accel)[:k]
        g[:k] = np.asarray(gyro)[:k]
        h[:k] = np.asarray(dt)[:k]
        self._accel.append(a)
        self._gyro.append(g)
        self._dt.append(h)
        self._rel.append((_np32(rel_pose.R), _np32(rel_pose.t)))
        if len(self._accel) > self.window - 1:
            for buf in (self._accel, self._gyro, self._dt, self._rel):
                buf.pop(0)
            # slide the states with the data: node k takes node k+1's
            # estimate, the last node starts from the previous last
            self.states = ImuStates(*(torch.cat([s[1:], s[-1:]]) for s in self.states))
        self._n = min(self._n + 1, self.window)

    @property
    def node_count(self) -> int:
        """States constrained (1 anchor + pushed intervals)."""
        return self._n

    def _set(self, field: str, k: int, value) -> None:
        s = getattr(self.states, field).clone()
        s[k] = torch.as_tensor(_np32(value), device=self.device)
        self.states = self.states._replace(**{field: s})

    def set_node_pose(self, k: int, R, p) -> None:
        """Write a pose estimate (e.g. from scan matching) into node k."""
        self._set("R", k, R)
        self._set("p", k, p)

    def set_node_velocity(self, k: int, v) -> None:
        """Seed node k's world-frame velocity (e.g. a pose finite
        difference): at v = 0 on a fast trajectory the solve would start far
        outside its basin."""
        self._set("v", k, v)

    def solve(self, init: ImuStates | None = None, gn_iters: int = 8):
        """Solve the window; returns (states, chi2 history). Intervals not
        yet filled carry zero-dt samples and identity relative poses, as in
        the JAX class."""
        W, M = self.window, self.max_samples
        k = len(self._accel)
        accel = np.zeros((W - 1, M, 3), np.float32)
        gyro = np.zeros((W - 1, M, 3), np.float32)
        dt = np.zeros((W - 1, M), np.float32)
        if k:
            accel[:k] = np.stack(self._accel)
            gyro[:k] = np.stack(self._gyro)
            dt[:k] = np.stack(self._dt)
        # samples after the last valid one in every interval are pads, which
        # change nothing (h = 0): the loop over samples stops before them
        used = int(np.max(np.nonzero(dt > 0)[1], initial=0)) + 1
        accel, gyro, dt = accel[:, :used], gyro[:, :used], dt[:, :used]
        relR = np.tile(np.eye(3, dtype=np.float32), (W - 1, 1, 1))
        relt = np.zeros((W - 1, 3), np.float32)
        for i, (R, t) in enumerate(self._rel):
            relR[i] = R
            relt[i] = t

        def dev(a):
            return torch.from_numpy(a).to(self.device)

        data = ImuWindowData(dev(accel), dev(gyro), dev(dt))
        rel = se3.Pose(dev(relR), dev(relt))
        x0 = self.states if init is None else init
        self.states, chis = solve_window(x0, data, rel, x0, cfg=self.cfg, gn_iters=gn_iters)
        return self.states, chis
