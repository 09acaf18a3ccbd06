"""Batched SO(3) operations (port of ``scl_slam_tpu/geometry/so3.py``).

Shape-polymorphic over leading batch dimensions, f32 throughout. The
small-angle branches are the same wide Taylor series as the JAX module
(the closed forms cancel catastrophically in f32 below theta ~ 0.5), and
every divisor is made benign in the unselected branch ("double where"),
so values and autograd stay finite at identity and at pi.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def _eye(ref: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=ref.dtype, device=ref.device).expand(
        *ref.shape[:-2], 3, 3
    )


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: [..., 3] -> [..., 3, 3] skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: [..., 3, 3] -> [..., 3]."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def orthonormalize(R: torch.Tensor, iters: int = 2) -> torch.Tensor:
    """Project a near-rotation back onto SO(3) (Newton-Schulz polar
    iteration R <- R (3I - R^T R) / 2; see the JAX module for why chained
    f32 compositions need it)."""
    eye3 = _eye(R)
    for _ in range(iters):
        R = R @ (1.5 * eye3 - 0.5 * (R.transpose(-1, -2) @ R))
    return R


def exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula: axis-angle [..., 3] -> rotation [..., 3, 3]."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 0.25
    safe_theta2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe_theta2)
    a = torch.where(
        small,
        1.0 - theta2 / 6.0 + theta2 * theta2 / 120.0,
        torch.sin(theta) / theta,
    )
    b = torch.where(
        small,
        0.5 - theta2 / 24.0 + theta2 * theta2 / 720.0,
        (1.0 - torch.cos(theta)) / safe_theta2,
    )
    W = hat(w)
    W2 = W @ W
    return _eye(W) + a[..., None, None] * W + b[..., None, None] * W2


def log(R: torch.Tensor) -> torch.Tensor:
    """Matrix log: rotation [..., 3, 3] -> axis-angle [..., 3].

    Stable near identity and near pi (diagonal-based axis extraction in
    the near-pi region), as in the JAX module.
    """
    R = orthonormalize(R)
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    u = vee(R - R.transpose(-1, -2))
    u2 = torch.sum(u * u, dim=-1)  # = 4 sin^2(theta)
    # thresholds far above f32 eps (1 - 1e-8 would round to exactly 1)
    small = cos_t > 1.0 - 1e-6
    near_pi = cos_t < -1.0 + 1e-6
    either = small | near_pi
    safe_cos = torch.where(either, torch.zeros_like(cos_t), cos_t)
    theta = torch.arccos(safe_cos)
    scale_small = 0.5 * (1.0 + u2 / 24.0)
    safe_u2 = torch.where(either, torch.ones_like(u2), u2)
    scale_mid = theta / torch.sqrt(safe_u2)
    scale = torch.where(small, scale_small, scale_mid)
    w_generic = scale[..., None] * u
    theta_pi = torch.arccos(torch.clamp(cos_t, -1.0 + 1e-7, 1.0 - 1e-7))

    B = (R + _eye(R)) * 0.5
    diag = torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], dim=-1)
    axis_abs = torch.sqrt(torch.clamp(diag, min=0.0))
    k = torch.argmax(diag, dim=-1)
    Bk = torch.gather(
        B, -2, k[..., None, None].expand(*k.shape, 1, 3)
    )[..., 0, :]
    signs = torch.where(Bk < 0, -1.0, 1.0).to(R.dtype)
    sign_k = torch.gather(signs, -1, k[..., None])
    axis = axis_abs * signs * sign_k
    norm = torch.linalg.norm(axis, dim=-1, keepdim=True)
    axis = axis / torch.clamp(norm, min=_EPS)
    w_pi = theta_pi[..., None] * axis
    return torch.where(near_pi[..., None], w_pi, w_generic)


def left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian J_l(w): [..., 3] -> [..., 3, 3]."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 0.25
    safe_theta2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe_theta2)
    b = torch.where(
        small,
        0.5 - theta2 / 24.0 + theta2 * theta2 / 720.0,
        (1.0 - torch.cos(theta)) / safe_theta2,
    )
    c = torch.where(
        small,
        1.0 / 6.0 - theta2 / 120.0 + theta2 * theta2 / 5040.0,
        (theta - torch.sin(theta)) / (safe_theta2 * theta),
    )
    W = hat(w)
    W2 = W @ W
    return _eye(W) + b[..., None, None] * W + c[..., None, None] * W2


def left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """Inverse SO(3) left Jacobian: [..., 3] -> [..., 3, 3]."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 0.25
    safe_theta2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe_theta2)
    sin_t = torch.sin(theta)
    safe_sin = torch.where(
        torch.abs(sin_t) < _EPS, torch.full_like(sin_t, _EPS), sin_t
    )
    cot_coef = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0 + theta2 * theta2 / 30240.0,
        (1.0 / safe_theta2)
        - (1.0 + torch.cos(theta)) / (2.0 * theta * safe_sin),
    )
    W = hat(w)
    W2 = W @ W
    return _eye(W) - 0.5 * W + cot_coef[..., None, None] * W2


def from_euler(rpy: torch.Tensor) -> torch.Tensor:
    """Roll-pitch-yaw (x-y-z intrinsic, PCL/ROS convention) -> matrix,
    R = Rz(yaw) Ry(pitch) Rx(roll)."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    row0 = torch.stack(
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], dim=-1
    )
    row1 = torch.stack(
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], dim=-1
    )
    row2 = torch.stack([-sp, cp * sr, cp * cr], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def to_euler(R: torch.Tensor) -> torch.Tensor:
    """Matrix -> roll-pitch-yaw (inverse of :func:`from_euler`). At pitch
    = +-pi/2 the clip keeps arcsin finite, and roll and yaw are the two
    atan2 readings of the degenerate rows, as in the JAX function."""
    sp = torch.clamp(-R[..., 2, 0], -1.0, 1.0)
    pitch = torch.arcsin(sp)
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([roll, pitch, yaw], dim=-1)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion [..., 4] (w, x, y, z), normalized first -> rotation
    matrix [..., 3, 3]."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack(
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1
    )
    row1 = torch.stack(
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1
    )
    row2 = torch.stack(
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1
    )
    return torch.stack([row0, row1, row2], dim=-2)


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> unit quaternion [..., 4] (w, x, y, z)
    with w >= 0: Shepperd's method without branches, all four candidate
    extractions computed and the one keyed to the largest of (trace, R00,
    R11, R22) kept (the first on ties, as ``jnp.argmax``)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def s(x):
        return torch.sqrt(torch.clamp(x, min=_EPS)) * 2.0

    s0 = s(1.0 + tr)
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], dim=-1)
    s1 = s(1.0 + m00 - m11 - m22)
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], dim=-1)
    s2 = s(1.0 - m00 + m11 - m22)
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], dim=-1)
    s3 = s(1.0 - m00 - m11 + m22)
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], dim=-1)
    cases = torch.stack([q0, q1, q2, q3], dim=-2)              # [..., 4, 4]
    idx = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)
    q = torch.gather(cases, -2, idx[..., None, None].expand(*idx.shape, 1, 4))[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    # canonical sign: w >= 0
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)
