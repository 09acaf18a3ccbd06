"""Batched SE(3) operations on (R, t) pairs (port of
``scl_slam_tpu/geometry/se3.py``).

Poses are ``(R [..., 3, 3], t [..., 3])`` pairs, structure-of-arrays as in
the JAX module.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import so3


class Pose(NamedTuple):
    """Batched SE(3) element: rotation [..., 3, 3], translation [..., 3]."""

    R: torch.Tensor
    t: torch.Tensor


def identity(batch_shape=(), dtype=torch.float32, device=None) -> Pose:
    R = torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3)
    t = torch.zeros((*batch_shape, 3), dtype=dtype, device=device)
    return Pose(R.clone(), t)


def compose(a: Pose, b: Pose) -> Pose:
    """a * b (apply b then a)."""
    R = a.R @ b.R
    t = torch.einsum("...ij,...j->...i", a.R, b.t) + a.t
    return Pose(R, t)


def inverse(p: Pose) -> Pose:
    Rt = p.R.transpose(-1, -2)
    return Pose(Rt, -torch.einsum("...ij,...j->...i", Rt, p.t))


def between(a: Pose, b: Pose) -> Pose:
    """Relative pose a^{-1} * b (GTSAM ``Pose3::between`` semantics)."""
    return compose(inverse(a), b)


def exp(xi: torch.Tensor) -> Pose:
    """se(3) exp: twist [..., 6] (omega, v) -> Pose."""
    w, v = xi[..., :3], xi[..., 3:]
    R = so3.exp(w)
    J = so3.left_jacobian(w)
    t = torch.einsum("...ij,...j->...i", J, v)
    return Pose(R, t)


def log(p: Pose) -> torch.Tensor:
    """SE(3) log: Pose -> twist [..., 6] (omega, v)."""
    w = so3.log(p.R)
    Jinv = so3.left_jacobian_inv(w)
    v = torch.einsum("...ij,...j->...i", Jinv, p.t)
    return torch.cat([w, v], dim=-1)


def transform_points(p: Pose, pts: torch.Tensor) -> torch.Tensor:
    """Apply pose to points [..., N, 3]."""
    return torch.einsum("...ij,...nj->...ni", p.R, pts) + p.t[..., None, :]


def retract(p: Pose, xi: torch.Tensor) -> Pose:
    """Right-multiplicative retraction p * exp(xi) used by the GN solver,
    re-orthonormalized (chained f32 compositions drift off SO(3))."""
    q = compose(p, exp(xi))
    return Pose(so3.orthonormalize(q.R), q.t)


def local(a: Pose, b: Pose) -> torch.Tensor:
    """log(a^{-1} b): the local coordinates of b around a."""
    return log(between(a, b))


def adjoint(p: Pose) -> torch.Tensor:
    """SE(3) adjoint [..., 6, 6] mapping twists between frames."""
    zeros = torch.zeros_like(p.R)
    top = torch.cat([p.R, zeros], dim=-1)
    bottom = torch.cat([so3.hat(p.t) @ p.R, p.R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def to_matrix(p: Pose) -> torch.Tensor:
    """Pose -> homogeneous [..., 4, 4]."""
    batch = p.t.shape[:-1]
    top = torch.cat([p.R, p.t[..., None]], dim=-1)
    bottom = torch.tensor(
        [0.0, 0.0, 0.0, 1.0], dtype=p.t.dtype, device=p.t.device
    ).expand(*batch, 1, 4)
    return torch.cat([top, bottom], dim=-2)


def from_matrix(T: torch.Tensor) -> Pose:
    return Pose(T[..., :3, :3], T[..., :3, 3])


def from_xyzrpy(xyzrpy: torch.Tensor) -> Pose:
    """[..., 6] (x, y, z, roll, pitch, yaw) -> Pose (the reference's
    ``PointPose6D`` storage)."""
    return Pose(so3.from_euler(xyzrpy[..., 3:]), xyzrpy[..., :3])


def to_xyzrpy(p: Pose) -> torch.Tensor:
    return torch.cat([p.t, so3.to_euler(p.R)], dim=-1)


def from_quat_trans(q: torch.Tensor, t: torch.Tensor) -> Pose:
    """Quaternion [..., 4] (w, x, y, z) and translation [..., 3] -> Pose."""
    return Pose(so3.quat_to_matrix(q), t)


def to_quat_trans(p: Pose):
    """Pose -> (quaternion [..., 4] (w, x, y, z) with w >= 0, translation)."""
    return so3.matrix_to_quat(p.R), p.t


def stack(poses, dim=0) -> Pose:
    return Pose(
        torch.stack([p.R for p in poses], dim=dim),
        torch.stack([p.t for p in poses], dim=dim),
    )


def index(p: Pose, idx) -> Pose:
    return Pose(p.R[idx], p.t[idx])


def take(p: Pose, indices: torch.Tensor) -> Pose:
    """Rows ``indices`` of a batched pose (``jnp.take`` along axis 0)."""
    indices = indices.long()
    return Pose(p.R[indices], p.t[indices])
