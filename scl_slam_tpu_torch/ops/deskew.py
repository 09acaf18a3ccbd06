"""Scan deskewing, motion compensation of a spinning LiDAR's sweep (port of
``scl_slam_tpu/ops/deskew.py``).

Elementwise tensor code on the scan's device; the JAX package fuses it in
XLA, outside any Pallas kernel.

- :func:`azimuth_sweep_times`: per-point sweep fractions from azimuth,
  for packets without timestamps.
- :func:`deskew_constant_twist`: every point into the sweep-end frame
  under a constant twist, ``p_end = exp((tau - 1) log(M)) p``.
- :func:`gyro_rotation_samples` + :func:`deskew_gyro`: the rotation from
  the gyro-integrated trajectory (piecewise per IMU sample), the
  translation from the constant-velocity prediction.

Times are sweep fractions in [0, 1]; the output is in the sensor frame at
the end of the sweep, the frame a frame's odometry pose stamps.
"""
from __future__ import annotations

import math

import torch

from ..geometry import se3, so3
from .pointcloud import PAD_VALUE


def azimuth_sweep_times(
    xyz: torch.Tensor, mask: torch.Tensor, clockwise: bool = False
) -> torch.Tensor:
    """Per-point sweep fraction tau in [0, 1]: ``(atan2(y, x) + pi) / 2pi``
    for a counter-clockwise spin starting at azimuth -pi, ``1 - tau`` for
    a clockwise one; masked points get 1 (the identity correction).

    atan2 may differ from XLA's by an ulp, so a point may move by ~1e-7
    of a sweep against the JAX function."""
    az = torch.atan2(xyz[..., 1], xyz[..., 0])
    tau = (az + math.pi) / (2.0 * math.pi)
    if clockwise:
        tau = 1.0 - tau
    return torch.where(mask, tau, torch.ones_like(tau))


def deskew_constant_twist(
    xyz: torch.Tensor,      # [N, 3] sensor-frame points as measured
    mask: torch.Tensor,     # [N]
    times: torch.Tensor,    # [N] sweep fractions in [0, 1]
    motion: se3.Pose,       # the pose at tau = 1 in the tau = 0 frame
) -> torch.Tensor:
    """Move every point into the sweep-end frame under a constant twist:
    ``exp((tau - 1) xi) p`` with ``xi = log(motion)``; exact for constant
    twist motion, the identity at tau = 1. Masked points go to PAD_VALUE."""
    xi = se3.log(motion)                                        # [6]
    corr = se3.exp((times[:, None] - 1.0) * xi[None, :])        # [N]
    out = torch.einsum("nij,nj->ni", corr.R, xyz) + corr.t
    return torch.where(mask[:, None], out, PAD_VALUE)


def gyro_rotation_samples(
    gyro: torch.Tensor,                 # [M, 3] body rates over the sweep
    dt: torch.Tensor,                   # [M] intervals (s); <= 0 are pads
    gyro_bias: torch.Tensor | None = None,
):
    """Cumulative gyro-integrated rotations at each sample boundary:
    ``(R [M, 3, 3], tfrac [M])``, ``R[k]`` the frame at boundary k+1 in
    the sweep-start frame, ``tfrac[k]`` its time as a fraction of the
    valid samples' total. A pad (dt <= 0) holds the value before it.

    The JAX ``lax.scan`` is a loop over the M samples; the M rotation
    increments are one batched ``so3.exp`` before it (the same values)."""
    if gyro_bias is None:
        gyro_bias = torch.zeros(3, dtype=gyro.dtype, device=gyro.device)
    valid = dt > 0
    h = torch.clamp(dt, min=0.0)
    dR = so3.exp((gyro - gyro_bias) * h[:, None])               # [M, 3, 3]
    R = torch.eye(3, dtype=gyro.dtype, device=gyro.device)
    t = torch.zeros((), dtype=gyro.dtype, device=gyro.device)
    Rs, ts = [], []
    for k in range(gyro.shape[0]):
        R = torch.where(valid[k], so3.orthonormalize(R @ dR[k]), R)
        t = t + h[k]
        Rs.append(R)
        ts.append(t)
    Rs = torch.stack(Rs)
    ts = torch.stack(ts)
    return Rs, ts / torch.clamp(t, min=1e-9)


def deskew_gyro(
    xyz: torch.Tensor,            # [N, 3] sensor-frame points as measured
    mask: torch.Tensor,           # [N]
    times: torch.Tensor,          # [N] sweep fractions in [0, 1]
    sample_R: torch.Tensor,       # [M, 3, 3] from gyro_rotation_samples
    sample_tfrac: torch.Tensor,   # [M]
    translation: torch.Tensor,    # [3] sweep translation in the start frame
) -> torch.Tensor:
    """Gyro rotation + constant-velocity translation deskew to the sweep
    end: each point moves by ``D(1)^-1 D(tau)``, ``D(tau) = (R(tau), tau
    t)`` with R(tau) the rotation at the last sample boundary at or before
    tau; points before the first boundary keep the identity (the
    sweep-start frame). A point whose tau lies within an ulp of a boundary
    may take the neighbouring sample against the JAX function."""
    raw = torch.searchsorted(sample_tfrac.contiguous(), times.contiguous(), right=True) - 1
    idx = torch.clamp(raw, 0, sample_R.shape[0] - 1)
    eye = torch.eye(3, dtype=sample_R.dtype, device=sample_R.device)
    R_tau = torch.where((raw < 0)[:, None, None], eye, sample_R[idx])   # [N, 3, 3]
    R_end = sample_R[-1]
    Rc = torch.einsum("ji,njk->nik", R_end, R_tau)            # R_end^T R_tau
    tc = torch.einsum("ji,nj->ni", R_end, (times[:, None] - 1.0) * translation[None, :])
    out = torch.einsum("nij,nj->ni", Rc, xyz) + tc
    return torch.where(mask[:, None], out, PAD_VALUE)
