"""IMU preintegration (port of ``scl_slam_tpu/runtime/imu.py``).

On-manifold forward preintegration (Forster et al.) of the accel/gyro
samples between two LiDAR frames: the relative (delta R, delta v, delta p)
the interval implies. It seeds the scan-to-map ICP's rotation
(``runtime/odometry.py``) and is the measurement of the IMU window factor
(``graph/imu_factor.py``).

The JAX ``lax.scan`` over samples is a loop over the sample axis; leading
batch dimensions replace its ``vmap`` over intervals, so a window's
intervals integrate in one loop. :func:`integrate` can also carry the
derivatives of the result with respect to the six biases through the same
loop (the IMU factor's Jacobian).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import se3, so3


class ImuConfig(NamedTuple):
    gravity: float = 9.81
    accel_noise: float = 0.01      # m/s^2 /sqrt(Hz)
    gyro_noise: float = 0.001      # rad/s /sqrt(Hz)
    accel_bias_noise: float = 6.4e-5
    gyro_bias_noise: float = 3.5e-5
    # extrinsic rotation IMU -> LiDAR; identity by default
    R_lidar_imu: tuple = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)


class PreintegratedImu(NamedTuple):
    delta_R: torch.Tensor    # [..., 3, 3] rotation over the interval (body frame)
    delta_v: torch.Tensor    # [..., 3] velocity change (gravity-free, body frame at t0)
    delta_p: torch.Tensor    # [..., 3] position change (gravity-free, body frame at t0)
    dt_total: torch.Tensor   # [...]
    count: torch.Tensor      # [...] samples integrated


class BiasTangents(NamedTuple):
    """Derivatives of a preintegration with respect to the biases, columns
    (b_g x, y, z, b_a x, y, z): ``phi`` the right perturbation of delta_R
    (delta_R(b + db) = delta_R exp(phi db)), ``v`` and ``p`` of delta_v and
    delta_p. Each [..., 3, 6]."""

    phi: torch.Tensor
    v: torch.Tensor
    p: torch.Tensor


def integrate(
    accel: torch.Tensor,      # [..., N, 3] specific force (body frame, includes -g)
    gyro: torch.Tensor,       # [..., N, 3] angular velocity (body frame)
    dt: torch.Tensor,         # [..., N] intervals (s); <= 0 samples ignored
    gyro_bias: torch.Tensor | None = None,   # [..., 3]
    accel_bias: torch.Tensor | None = None,  # [..., 3]
    cfg: ImuConfig = ImuConfig(),
    tangents: bool = False,
):
    """Forward preintegration, the JAX function's step on every sample:
    ``a = E (a - b_a)``, ``w = E (w - b_g)``, ``p += v h + a_w h^2 / 2``,
    ``v += a_w h`` with ``a_w = R a``, ``R = orthonormalize(R exp(w h))``;
    a sample with dt <= 0 leaves the state as it was (its h is 0, so it adds
    exact zeros to v and p).

    Only the rotation is a loop over the samples; the rotation increments
    before it are one batched ``so3.exp``, and v and p after it are running
    sums of ``a_w h`` over the rotations the loop kept (the JAX ``lax.scan``
    adds them one sample at a time, so v and p may round apart by an ulp of
    their size).

    Returns ``(PreintegratedImu, BiasTangents | None)``. With ``tangents``
    the bias derivatives come from the same rotations: at an orthonormal R
    the orthonormalization's derivative is the identity on the tangent and
    exp's is its right Jacobian, so the step's recurrence ``phi' = exp(w
    h)^T phi + Jr(w h) h dw`` sums to ``phi_k = R_k^T C_k`` with ``C_k`` the
    running sum of ``R_(j+1) Jr(w_j h_j) h_j dw``; then ``d a_w = R dA -
    hat(a_w) C``, ``v' = v + d a_w h`` and ``p' = p + v h + d a_w h^2 / 2``
    are running sums as well."""
    dtype, dev = accel.dtype, accel.device
    lead, n = accel.shape[:-2], accel.shape[-2]
    if gyro_bias is None:
        gyro_bias = torch.zeros(3, dtype=dtype, device=dev)
    if accel_bias is None:
        accel_bias = torch.zeros(3, dtype=dtype, device=dev)
    E = torch.tensor(cfg.R_lidar_imu, dtype=dtype).reshape(3, 3).to(dev)
    valid = dt > 0
    h = torch.clamp(dt, min=0.0)
    a = torch.einsum("ij,...nj->...ni", E, accel - accel_bias[..., None, :])
    w = torch.einsum("ij,...nj->...ni", E, gyro - gyro_bias[..., None, :])
    wh = w * h[..., None]
    dR = so3.exp(wh)                                            # [..., N, 3, 3]
    R = torch.eye(3, dtype=dtype, device=dev).expand(*lead, 3, 3)
    Rs = [R]                                                    # before each sample
    for k in range(n):
        R = torch.where(valid[..., k, None, None], so3.orthonormalize(R @ dR[..., k, :, :]), R)
        Rs.append(R)
    Rb = torch.stack(Rs[:-1], dim=-3)                           # [..., N, 3, 3]
    hv = h[..., None]
    a_w = torch.einsum("...nij,...nj->...ni", Rb, a)            # [..., N, 3]
    dv = a_w * hv
    v_seq = torch.cumsum(dv, dim=-2)                            # v after each sample
    v_before = torch.cat([torch.zeros_like(dv[..., :1, :]), v_seq[..., :-1, :]], dim=-2)
    p_seq = torch.cumsum(v_before * hv + 0.5 * a_w * hv * hv, dim=-2)
    t = torch.cumsum(h, dim=-1)[..., -1] if n else torch.zeros(lead, dtype=dtype, device=dev)
    zero3 = torch.zeros((*lead, 3), dtype=dtype, device=dev)
    pre = PreintegratedImu(
        delta_R=R, delta_v=v_seq[..., -1, :] if n else zero3,
        delta_p=p_seq[..., -1, :] if n else zero3, dt_total=t,
        count=torch.sum(valid.to(torch.int32), dim=-1),
    )
    if not tangents:
        return pre, None
    if n == 0:
        z = torch.zeros((*lead, 3, 6), dtype=dtype, device=dev)
        return pre, BiasTangents(z, z, z)
    # dw / d(b_g, b_a) and da / d(b_g, b_a): [3, 6]
    DW = torch.cat([-E, torch.zeros_like(E)], dim=-1)
    DA = torch.cat([torch.zeros_like(E), -E], dim=-1)
    Ra = torch.stack(Rs[1:], dim=-3)                            # after each sample
    JrDW = (so3.left_jacobian(-wh) * h[..., None, None]) @ DW   # [..., N, 3, 6]
    C_seq = torch.cumsum(Ra @ JrDW, dim=-3)
    C_before = torch.cat([torch.zeros_like(C_seq[..., :1, :, :]), C_seq[..., :-1, :, :]], dim=-3)
    dAw = Rb @ DA - so3.hat(a_w) @ C_before                     # d a_w: [..., N, 3, 6]
    hm = h[..., None, None]
    dV = dAw * hm
    V_seq = torch.cumsum(dV, dim=-3)
    V_before = torch.cat([torch.zeros_like(dV[..., :1, :, :]), V_seq[..., :-1, :, :]], dim=-3)
    P = torch.sum(V_before * hm + 0.5 * dAw * hm * hm, dim=-3)
    phi = R.transpose(-1, -2) @ C_seq[..., -1, :, :]
    return pre, BiasTangents(phi, V_seq[..., -1, :, :], P)


def preintegrate(
    accel: torch.Tensor,
    gyro: torch.Tensor,
    dt: torch.Tensor,
    gyro_bias: torch.Tensor | None = None,
    accel_bias: torch.Tensor | None = None,
    cfg: ImuConfig = ImuConfig(),
) -> PreintegratedImu:
    """Forward preintegration of [..., N] samples (see :func:`integrate`).
    Gravity is not removed: delta_v and delta_p integrate the measured
    specific force."""
    return integrate(accel, gyro, dt, gyro_bias, accel_bias, cfg)[0]


def gyro_delta_rotation(
    gyro: torch.Tensor, dt: torch.Tensor, gyro_bias: torch.Tensor | None = None,
    cfg: ImuConfig = ImuConfig(),
) -> torch.Tensor:
    """Rotation-only integration (the prediction seed): [..., 3, 3]."""
    return preintegrate(torch.zeros_like(gyro), gyro, dt, gyro_bias, None, cfg).delta_R


def synthesize_between_frames(T0, T1, n_samples: int, rate_dt: float, g=9.81):
    """Test and simulation helper: constant-twist IMU samples that realize
    the motion T0 -> T1 (4 x 4) over ``n_samples`` of spacing ``rate_dt``.
    Returns (accel [N, 3], gyro [N, 3], dt [N]) f32 in the body frame (the
    specific force includes the reaction to gravity). Host numpy; the twist
    and the per-sample rotations are the port's f32 ``se3.log`` and
    ``so3.exp`` on the CPU, as the JAX helper takes them in f32."""
    T0 = np.asarray(T0)
    T1 = np.asarray(T1)
    total = n_samples * rate_dt
    rel = np.linalg.inv(T0) @ T1
    xi = se3.log(se3.Pose(
        torch.tensor(rel[:3, :3], dtype=torch.float32),
        torch.tensor(rel[:3, 3], dtype=torch.float32),
    )).numpy()
    w = xi[:3] / total              # body angular velocity (constant)
    v_body = xi[3:] / total
    gyro = np.tile(w, (n_samples, 1))
    acc = []
    R = T0[:3, :3].copy()
    g_world = np.array([0.0, 0.0, -g])
    Rd = so3.exp(torch.tensor(w * rate_dt, dtype=torch.float32)).numpy()
    for _ in range(n_samples):
        acc.append(-(R.T @ g_world) + np.cross(w, v_body))
        R = R @ Rd
    return (
        np.asarray(acc, np.float32),
        gyro.astype(np.float32),
        np.full(n_samples, rate_dt, np.float32),
    )
