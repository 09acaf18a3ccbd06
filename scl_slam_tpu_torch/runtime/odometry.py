"""Scan-to-map ICP odometry, the LiDAR(-inertial) front end (port of
``scl_slam_tpu/runtime/odometry.py``).

A fixed-capacity rolling local map with per-point normals, a
constant-velocity (or gyro) motion prediction, deskew of the raw sweep,
and point-to-plane scan-to-map ICP a frame (its 1-NN on kernel K4 at P =
8). :class:`ImuFusedOdometry` adds the 15-state IMU window smoother of
``graph/imu_factor.py``. Both produce the per-frame poses that
``Mapper.add_frame`` consumes.

The JAX ``odometry_step`` is one jitted program; here it is the same
operations in the same order on the state's device, the frame counter a
host integer. :func:`odometry_state_from_numpy` and
:func:`odometry_state_to_numpy` carry a state between the two packages.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import se3, so3
from ..ops import deskew as dsk
from ..ops import pointcloud as pc
from ..ops import registration as reg


class OdometryConfig(NamedTuple):
    map_capacity: int = 32768       # rolling local map points
    scan_capacity: int = 4096       # downsampled input scan points
    scan_leaf: float = 0.5
    map_leaf: float = 0.5
    icp_iters: int = 12
    max_corr_dist: float = 2.0
    normal_knn: int = 12
    insert_every: int = 1           # insert the scan into the map every N frames
    # motion compensation (ops/deskew.py): "none" takes the scan as
    # deskewed; "const" removes a constant twist (the prediction, its
    # rotation from the gyro where given); "gyro" takes the gyro-integrated
    # rotation trajectory where samples are given, else "const". Per-point
    # times come from azimuth (one revolution a sweep).
    deskew: str = "none"
    deskew_clockwise: bool = False  # spin direction for azimuth times


class OdometryState(NamedTuple):
    map_xyz: torch.Tensor       # [M, 3]
    map_mask: torch.Tensor      # [M]
    map_normals: torch.Tensor   # [M, 3]
    pose: se3.Pose              # current sensor pose in the odometry frame
    prev_pose: se3.Pose         # the pose a frame before (constant velocity)
    frame: int                  # frames stepped


def make_odometry(cfg: OdometryConfig, device="cuda") -> OdometryState:
    dev = torch.device(device)
    M = cfg.map_capacity
    return OdometryState(
        map_xyz=torch.full((M, 3), pc.PAD_VALUE, dtype=torch.float32, device=dev),
        map_mask=torch.zeros((M,), dtype=torch.bool, device=dev),
        map_normals=torch.zeros((M, 3), dtype=torch.float32, device=dev),
        pose=se3.identity(device=dev),
        prev_pose=se3.identity(device=dev),
        frame=0,
    )


def odometry_state_to_numpy(state: OdometryState) -> OdometryState:
    """The state with numpy leaves (the JAX ``OdometryState``'s fields)."""
    def arr(x):
        return x.detach().cpu().numpy()

    return OdometryState(
        arr(state.map_xyz), arr(state.map_mask), arr(state.map_normals),
        se3.Pose(arr(state.pose.R), arr(state.pose.t)),
        se3.Pose(arr(state.prev_pose.R), arr(state.prev_pose.t)),
        np.int32(state.frame),
    )


def odometry_state_from_numpy(s, device="cuda") -> OdometryState:
    """An :class:`OdometryState` on ``device`` from any object with the JAX
    ``OdometryState``'s fields (``map_xyz``, ``map_mask``, ``map_normals``,
    ``pose`` and ``prev_pose`` with ``.R`` / ``.t``, ``frame``) holding
    arrays, such as the JAX state or :func:`odometry_state_to_numpy`'s."""
    dev = torch.device(device)

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.array(x), device=dev).to(dtype)

    return OdometryState(
        t(s.map_xyz), t(s.map_mask, torch.bool), t(s.map_normals),
        se3.Pose(t(s.pose.R), t(s.pose.t)),
        se3.Pose(t(s.prev_pose.R), t(s.prev_pose.t)),
        int(np.asarray(s.frame)),
    )


def odometry_step(
    state: OdometryState,
    xyz: torch.Tensor,
    mask: torch.Tensor,
    cfg: OdometryConfig,
    imu_delta_R: torch.Tensor | None = None,
    gyro: torch.Tensor | None = None,
    gyro_dt: torch.Tensor | None = None,
):
    """One frame: predict, deskew, downsample, register and merge into the
    local map, in the JAX function's order.

    ``imu_delta_R``: a gyro-preintegrated rotation over the frame interval,
    which replaces the constant-velocity prediction's rotation.
    ``gyro``/``gyro_dt``: the interval's samples ([M, 3] body rates, [M]
    spacings, dt <= 0 ignored); their integrated rotation takes the place of
    ``imu_delta_R`` when that is not given, and they drive
    ``deskew="gyro"``. Returns (new_state, pose, fitness).
    """
    vel = se3.between(state.prev_pose, state.pose)
    sample_R = sample_tfrac = None
    if gyro is not None:
        sample_R, sample_tfrac = dsk.gyro_rotation_samples(gyro, gyro_dt)
        if imu_delta_R is None:
            imu_delta_R = sample_R[-1]
    if imu_delta_R is not None:
        vel = se3.Pose(imu_delta_R, vel.t)

    # motion compensation on the raw scan (before the voxel binning: a
    # smeared cloud bins differently), by the predicted sweep motion; the
    # first frame has none (vel is the identity)
    if cfg.deskew != "none":
        times = dsk.azimuth_sweep_times(xyz, mask, cfg.deskew_clockwise)
        if cfg.deskew == "gyro" and sample_R is not None:
            xyz = dsk.deskew_gyro(xyz, mask, times, sample_R, sample_tfrac, vel.t)
        else:
            xyz = dsk.deskew_constant_twist(xyz, mask, times, vel)

    scan = pc.voxel_downsample(pc.Cloud(xyz, mask), cfg.scan_leaf, cfg.scan_capacity)

    pred = se3.compose(state.pose, vel)
    pred = se3.Pose(so3.orthonormalize(pred.R), pred.t)

    res = reg.icp_point_to_plane(
        scan,
        pc.Cloud(state.map_xyz, state.map_mask),
        state.map_normals,
        init=pred,
        max_iters=cfg.icp_iters,
        max_corr_dist=cfg.max_corr_dist,
    )
    # the first frame keeps its pose (it registers against the empty map)
    new_pose = state.pose if state.frame == 0 else res.pose

    # ring-buffer write of the scan (odometry frame) over the oldest rows,
    # then normals for the written rows only
    map_xyz, map_mask, map_normals = state.map_xyz, state.map_mask, state.map_normals
    if state.frame % cfg.insert_every == 0:
        world = se3.transform_points(new_pose, scan.xyz)
        world = torch.where(scan.mask[:, None], world, pc.PAD_VALUE)
        S, M = cfg.scan_capacity, cfg.map_capacity
        dev = world.device
        rows = ((state.frame * S) % M + torch.arange(S, device=dev)) % M
        map_xyz = map_xyz.clone()
        map_xyz[rows] = world
        map_mask = map_mask.clone()
        map_mask[rows] = scan.mask
        map_normals = map_normals.clone()
        map_normals[rows] = _normals_for_rows(pc.Cloud(map_xyz, map_mask), rows, cfg.normal_knn)

    new_state = OdometryState(
        map_xyz=map_xyz,
        map_mask=map_mask,
        map_normals=map_normals,
        pose=new_pose,
        prev_pose=state.pose,
        frame=state.frame + 1,
    )
    return new_state, new_pose, res.fitness


def _normals_for_rows(cloud: pc.Cloud, rows: torch.Tensor, k: int) -> torch.Tensor:
    """Normals of the map's ``rows``: the smallest eigenvector of the
    covariance of each row's k nearest map points (brute force over the
    whole map, in chunks of rows; ties by the lower index, as
    ``lax.top_k`` of -d2), turned towards -q (the sensor, roughly). The
    squared distance is taken per coordinate, ((dx dx + dy dy) + dz dz).
    A neighbour tied at the k-th distance and the sign of a normal nearly
    orthogonal to q may differ from the JAX function's (see
    tests/test_torch_odometry.py)."""
    xyz = torch.where(cloud.mask[:, None], cloud.xyz, pc.PAD_VALUE)
    q = xyz[rows]
    n = xyz.shape[0]
    chunk = max(1, pc._KNN_BUDGET[xyz.device.type] // max(n, 1))
    x, y, z = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    idx = []
    for q0 in range(0, q.shape[0], chunk):
        qb = q[q0 : q0 + chunk]
        d = qb[:, 0:1] - x
        d2 = d * d
        d = qb[:, 1:2] - y
        d2 += d * d
        d = qb[:, 2:3] - z
        d2 += d * d
        idx.append(pc.smallest_k(d2, k))
    normal = pc.covariance_normals(xyz[torch.cat(idx)])
    flip = torch.sum(normal * (-q), dim=-1) < 0
    return torch.where(flip[:, None], -normal, normal)


def _require_device(device, who: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who} runs on the GPU by default and torch.cuda.is_available() "
            "is false; pass device='cpu' to run on the CPU"
        )
    return dev


class Odometry:
    """Host-side wrapper: numpy scans in, poses out, on ``device`` (the
    card unless ``device="cpu"``)."""

    def __init__(self, cfg: OdometryConfig = OdometryConfig(), device="cuda"):
        self.device = _require_device(device, "Odometry")
        self.cfg = cfg
        self.state = make_odometry(cfg, self.device)

    def step(
        self,
        xyz: np.ndarray,
        gyro: np.ndarray | None = None,
        imu_dt: np.ndarray | None = None,
    ) -> tuple[se3.Pose, float]:
        """Register one scan [N, 3] (stride-subsampled to twice the scan
        capacity). Optional gyro samples (body rates [M, 3], spacings [M])
        seed the rotation prediction and, with ``cfg.deskew="gyro"``, drive
        the deskew's rotation trajectory. The JAX wrapper pads the samples
        to a multiple of 32 against recompiles; pads are ignored, so none
        are added here (an empty interval is one pad)."""
        pts = pc.fit_capacity(np.asarray(xyz), self.cfg.scan_capacity * 2)
        pts = torch.from_numpy(np.ascontiguousarray(pts, dtype=np.float32)).to(self.device)
        cloud = pc.from_points(pts, self.cfg.scan_capacity * 2)
        g = gdt = None
        if gyro is not None:
            g = np.array(gyro, np.float32).reshape(-1, 3)
            gdt = np.array(imu_dt, np.float32).reshape(-1)
            if len(gdt) == 0:
                g, gdt = np.zeros((1, 3), np.float32), np.zeros(1, np.float32)
            g = torch.from_numpy(g).to(self.device)
            gdt = torch.from_numpy(gdt).to(self.device)
        self.state, pose, fitness = odometry_step(
            self.state, cloud.xyz, cloud.mask, self.cfg, None, g, gdt
        )
        return pose, float(fitness)


class ImuFusedOdometry:
    """The LiDAR-inertial front end: scan-to-map ICP fused with the
    15-state IMU window smoother (``graph/imu_factor.py``). A frame:

    1. the interval's gyro samples, less the smoother's current gyro bias,
       seed the ICP rotation (and drive a gyro deskew);
    2. point-to-plane ICP registers the scan;
    3. the interval's raw IMU and the ICP relative pose enter the window,
       which re-estimates poses, velocities and both biases;
    4. the smoothed pose is returned, unless it lies more than
       ``max_smooth_gap`` m from the ICP pose (then the ICP pose).

    The ICP chain goes on from the raw ICP pose, as in the JAX class."""

    def __init__(
        self,
        cfg: OdometryConfig = OdometryConfig(),
        imu_cfg=None,
        window: int = 8,
        max_samples: int = 64,
        solve_iters: int = 4,
        max_smooth_gap: float = 0.5,
        device="cuda",
    ):
        from ..graph import imu_factor as IF

        self.odo = Odometry(cfg, device=device)
        self.device = self.odo.device
        self.smoother = IF.ImuSmoother(
            window, max_samples, imu_cfg or IF.ImuFactorConfig(), device=self.device
        )
        self.solve_iters = solve_iters
        self.max_smooth_gap = max_smooth_gap
        self._last_pose: se3.Pose | None = None

    def step(
        self,
        xyz: np.ndarray,
        accel: np.ndarray,
        gyro: np.ndarray,
        imu_dt: np.ndarray,
    ) -> tuple[se3.Pose, float, dict]:
        """Register one scan with its interval's IMU samples. Returns
        (pose, ICP fitness, info with the velocity and bias estimates and
        the gap between the smoothed and the ICP pose)."""
        sm = self.smoother
        n = min(sm.node_count, sm.window - 1)
        bg = sm.states.bg[max(n - 1, 0)].cpu().numpy()
        pose, fitness = self.odo.step(xyz, gyro=np.asarray(gyro) - bg, imu_dt=imu_dt)
        if self._last_pose is None:
            # the first frame anchors node 0
            sm.set_node_pose(0, pose.R, pose.t)
            self._last_pose = pose
            return pose, fitness, {"velocity": np.zeros(3), "bg": bg,
                                   "ba": sm.states.ba[0].cpu().numpy()}
        rel = se3.between(self._last_pose, pose)
        sm.push_interval(accel, gyro, imu_dt, rel)
        n = min(sm.node_count - 1, sm.window - 1)
        sm.set_node_pose(n, pose.R, pose.t)
        # seed the new node's velocity from the ICP poses' finite difference
        # (and node 0's on the first interval): at v = 0 the solve would
        # linearize far outside its basin on a fast trajectory
        T = float(np.sum(np.maximum(np.asarray(imu_dt), 0.0)))
        if T > 1e-6:
            v_fd = (pose.t - self._last_pose.t).cpu().numpy() / T
            sm.set_node_velocity(n, v_fd)
            if n == 1:
                sm.set_node_velocity(0, v_fd)
        states, _ = sm.solve(gn_iters=self.solve_iters)
        smoothed = se3.Pose(states.R[n], states.p[n])
        # divergence gate: inconsistent IMU never replaces a good ICP pose
        gap = float(torch.linalg.norm(smoothed.t - pose.t))
        if gap > self.max_smooth_gap:
            smoothed = pose
        self._last_pose = pose
        return smoothed, fitness, {
            "velocity": states.v[n].cpu().numpy(),
            "bg": states.bg[n].cpu().numpy(),
            "ba": states.ba[n].cpu().numpy(),
            "smooth_gap": gap,
        }
