"""The front end of the PyTorch port against the JAX package: point-to-plane
ICP (``ops/registration.icp_point_to_plane``), scan-to-map odometry
(``runtime/odometry.py``: ``odometry_step``, ``Odometry``,
``ImuFusedOdometry``), and the runner and daemon that drive them, at small
widths (map 2,048, scan 512, 8 ICP iterations; the IMU-fused runs map
4,096, scan 1,024, a window of 4 with 16 samples).

On the CPU the JAX package's 1-NN (``nearest_select``) is an argmin of the
expanded-form distance plus a gather; the port's plain K4 ranks by the
exact per-coordinate distance, lowest index on ties. So a correspondence
may differ where two targets tie within the expanded form's rounding.

Tolerances, with their measured sizes:
- point-to-plane ICP from the same init: pose 1e-4 (measured ~1e-7),
  fitness 1e-3 relative;
- one odometry step from the same carried state: pose 1e-4 (measured
  ~1e-7); the written map rows 1e-4 m; the written normals: 99% of the
  valid rows within 1e-3, the others either a neighbour set that differs
  at the k-th neighbour (ties of the per-coordinate and the expanded
  distance, as the descriptor families' k-NN) or a sign flip of a normal within 1e-2
  of orthogonal to q (the sign rule's tie);
- 8-frame runs: poses 1e-3 m / 1e-3 (measured <= 4.4e-5 m, 3.4e-6: the
  NN ranking above moves a pose by ulps, which the next frames carry);
- ImuFusedOdometry, each frame from JAX's carried state: the pose 2e-2 m /
  5e-3, the velocity 5e-2 m/s (the window solve's first step starts at
  chi2 ~1e8 from the unfilled nodes; its f32 solve carries ~10% error in
  both packages, so the two solves part by mm to cm: measured 9e-3 m,
  4e-2 m/s at map 2,048; a free run compounds it through the gyro-bias
  feedback into the ICP, 3e-2 m in 8 frames at map 4,096).
"""
import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scl_slam_tpu.geometry import se3 as jse3
from scl_slam_tpu.ops import pointcloud as jpc
from scl_slam_tpu.ops import registration as jreg
from scl_slam_tpu.runtime import odometry as JO
from scl_slam_tpu_torch import config as tconfig
from scl_slam_tpu_torch import run as trun
from scl_slam_tpu_torch import serve
from scl_slam_tpu_torch.geometry import se3
from scl_slam_tpu_torch.graph import imu_factor as IF
from scl_slam_tpu_torch.io import kitti, lidar_sim
from scl_slam_tpu_torch.ops import pointcloud as pc
from scl_slam_tpu_torch.ops import registration as reg
from scl_slam_tpu_torch.runtime import Mapper
from scl_slam_tpu_torch.runtime import imu as timu
from scl_slam_tpu_torch.runtime import odometry as O
from test_imu_factor import simulate
from test_imu_odometry import poses_4x4
from test_torch_checkpoint import tiny
from test_torch_kernels import release_jax_programs  # noqa: F401 (autouse)

torch.set_num_threads(2)

SMALL = dict(map_capacity=2048, scan_capacity=512, icp_iters=8)
FUSED = dict(map_capacity=4096, scan_capacity=1024, icp_iters=8, scan_leaf=0.3)
N_FRAMES = 8


def T(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def _assert_pose(p_t, p_j, atol_t, atol_R):
    np.testing.assert_allclose(p_t.t.cpu().numpy(), np.asarray(p_j.t), atol=atol_t)
    np.testing.assert_allclose(p_t.R.cpu().numpy(), np.asarray(p_j.R), atol=atol_R)


@pytest.fixture(scope="module")
def sweeps():
    """tests/test_deskew.py's skewed sweeps (2 m a frame around a corner of
    the urban scene, 360 azimuths), the first N_FRAMES, and the gyro
    samples of each interval (20 at 5 ms, from the circuit's motion)."""
    scene = lidar_sim.UrbanScene(seed=4)
    sim = lidar_sim.LidarSim(scene, n_azimuth=360, device="cpu")
    circuit = scene.circuit(step=2.0)[:N_FRAMES]
    scans = [sim.scan_at_skewed(circuit[max(k - 1, 0)], circuit[k], seed=100 + k)
             for k in range(N_FRAMES)]
    gyro = [None] + [timu.synthesize_between_frames(circuit[k - 1], circuit[k], 20, 0.005)[1:]
                     for k in range(1, N_FRAMES)]
    return circuit, scans, gyro


def _plane_scene():
    """tests/test_odometry.py's three planes, fewer points."""
    rng = np.random.RandomState(0)
    floor = np.column_stack([rng.uniform(-20, 20, 1000), rng.uniform(-20, 20, 1000), np.zeros(1000)])
    wall1 = np.column_stack([rng.uniform(-20, 20, 500), np.full(500, 10.0), rng.uniform(0, 5, 500)])
    wall2 = np.column_stack([np.full(500, -15.0), rng.uniform(-20, 20, 500), rng.uniform(0, 5, 500)])
    return np.concatenate([floor, wall1, wall2]).astype(np.float32)


def test_point_to_plane_icp_matches_jax():
    scene = _plane_scene()
    jt = jpc.from_points(scene, 2048)
    normals = np.asarray(jpc.estimate_normals(jt, k=12))
    gt = jse3.Pose(jse3.so3.exp(jnp.array([0.01, -0.02, 0.05])), jnp.array([0.3, -0.2, 0.1]))
    src = np.asarray(jse3.transform_points(jse3.inverse(gt), jt.xyz[:1900]))
    init = jse3.Pose(jse3.so3.exp(jnp.array([0.0, 0.0, 0.03])), jnp.array([0.2, 0.0, 0.0]))
    want = jreg.icp_point_to_plane(jpc.from_points(src, 512 * 4), jt, jnp.asarray(normals),
                                   init=init, max_iters=8)
    got = reg.icp_point_to_plane(
        pc.from_points(T(src), 512 * 4), pc.Cloud(T(jt.xyz), torch.tensor(np.asarray(jt.mask))),
        T(normals), init=se3.Pose(T(init.R), T(init.t)), max_iters=8,
    )
    _assert_pose(got.pose, want.pose, 1e-4, 1e-4)
    _assert_pose(got.pose, gt, 5e-2, 2e-3)
    assert float(got.fitness) == pytest.approx(float(want.fitness), rel=1e-3, abs=1e-7)
    assert float(got.inlier_frac) == pytest.approx(float(want.inlier_frac), abs=1e-6)
    assert bool(got.converged) == bool(want.converged)


def _written_normals_agree(n_t, n_j, q):
    """The written rows' normals: within 1e-3, or a sign flip of a normal
    nearly orthogonal to q. Returns the share within 1e-3."""
    close = np.abs(n_t - n_j).max(axis=1) < 1e-3
    flipped = np.abs(n_t + n_j).max(axis=1) < 1e-3
    cos_q = np.abs(np.sum(n_j * q, axis=1)) / np.maximum(np.linalg.norm(q, axis=1), 1e-9)
    assert np.all(~flipped | close | (cos_q < 1e-2))
    return close.mean()


def test_one_step_from_the_carried_state(sweeps):
    """JAX runs 4 frames; its state is carried into the port, and both take
    the 5th: the pose, the written rows and their normals."""
    circuit, scans, _ = sweeps
    cfg_j, cfg_t = JO.OdometryConfig(deskew="const", **SMALL), O.OdometryConfig(deskew="const", **SMALL)
    jo = JO.Odometry(cfg_j)
    for s in scans[:4]:
        jo.step(s)
    st = O.odometry_state_from_numpy(jo.state, "cpu")
    back = O.odometry_state_to_numpy(st)
    np.testing.assert_array_equal(back.map_xyz, np.asarray(jo.state.map_xyz))
    np.testing.assert_array_equal(back.pose.R, np.asarray(jo.state.pose.R))
    assert back.frame == int(jo.state.frame) == 4

    cloud_j = jpc.from_points(scans[4], 2 * SMALL["scan_capacity"])
    js, jpose, jfit = JO.odometry_step(jo.state, cloud_j.xyz, cloud_j.mask, cfg_j)
    ts, tpose, tfit = O.odometry_step(st, T(cloud_j.xyz), torch.tensor(np.asarray(cloud_j.mask)), cfg_t)
    _assert_pose(tpose, jpose, 1e-4, 1e-4)
    assert float(tfit) == pytest.approx(float(jfit), rel=1e-3)
    S, M = SMALL["scan_capacity"], SMALL["map_capacity"]
    rows = (4 * S + np.arange(S)) % M
    np.testing.assert_array_equal(ts.map_mask.numpy(), np.asarray(js.map_mask))
    np.testing.assert_allclose(ts.map_xyz[rows].numpy(), np.asarray(js.map_xyz)[rows], atol=1e-4)
    others = np.setdiff1d(np.arange(M), rows)
    np.testing.assert_array_equal(ts.map_normals[others].numpy(), np.asarray(jo.state.map_normals)[others])
    valid = np.asarray(js.map_mask)[rows]
    share = _written_normals_agree(ts.map_normals[rows].numpy()[valid],
                                   np.asarray(js.map_normals)[rows][valid],
                                   np.asarray(js.map_xyz)[rows][valid])
    assert share >= 0.99, share
    assert ts.frame == 5 and torch.equal(ts.prev_pose.t, st.pose.t)


_ATE = {}  # each run's ATE, by deskew mode


@pytest.mark.parametrize("deskew", ["none", "const", "gyro"])
def test_odometry_runs_match_jax(sweeps, deskew):
    """8 frames of skewed sweeps through both packages' ``Odometry``, the
    gyro samples given in gyro mode; the constant-twist deskew beats none
    (the JAX test's factor 0.7 and 0.6 m, at these widths)."""
    circuit, scans, gyro = sweeps
    jo = JO.Odometry(JO.OdometryConfig(deskew=deskew, **SMALL))
    to = O.Odometry(O.OdometryConfig(deskew=deskew, **SMALL), device="cpu")
    errs = []
    for k, s in enumerate(scans):
        g, dt = gyro[k] if deskew == "gyro" and gyro[k] is not None else (None, None)
        pj, fj = jo.step(s, gyro=g, imu_dt=dt)
        pt, ft = to.step(s, gyro=g, imu_dt=dt)
        _assert_pose(pt, pj, 1e-3, 1e-3)
        assert ft == pytest.approx(fj, rel=1e-2) or not np.isfinite(fj)
        gt_rel = np.linalg.inv(circuit[0]) @ circuit[k]
        errs.append(float(np.linalg.norm(pt.t.numpy() - gt_rel[:3, 3])))
    _ATE[deskew] = float(np.sqrt(np.mean(np.square(errs))))
    if deskew != "none" and "none" in _ATE:
        assert _ATE[deskew] < 0.7 * _ATE["none"] and _ATE[deskew] < 0.6, _ATE


def _carry_fused(jf, tf):
    """Put the JAX front end's whole state into the port's: the odometry
    state, the window's states and buffers, the last ICP pose."""
    tf.odo.state = O.odometry_state_from_numpy(jf.odo.state, "cpu")
    js, sm = jf.smoother, tf.smoother
    sm.states = IF.imu_states_from_numpy(js.states, "cpu")
    sm._accel, sm._gyro, sm._dt = ([a.copy() for a in buf] for buf in (js._accel, js._gyro, js._dt))
    sm._rel = [(np.array(z.R), np.array(z.t)) for z in js._rel]
    sm._n = js._n
    tf._last_pose = None if jf._last_pose is None else se3.Pose(T(jf._last_pose.R), T(jf._last_pose.t))


def test_imu_fused_odometry_matches_jax():
    """tests/test_imu_odometry.py's tracking run at a window of 4: 8 frames,
    past the window twice. JAX runs free; before each frame the port takes
    JAX's state, so each frame's step is held alone."""
    n = N_FRAMES
    gt, data, _ = simulate(n_states=n, m=16, h=0.0125, seed=2)
    Ts = poses_4x4(gt)
    world = kitti.SyntheticWorld(seed=11, extent=60.0, n_clusters=60, pts_per_cluster=600,
                                 max_range=50.0)
    jf = JO.ImuFusedOdometry(JO.OdometryConfig(**FUSED), window=4, max_samples=16)
    tf = O.ImuFusedOdometry(O.OdometryConfig(**FUSED), window=4, max_samples=16, device="cpu")
    for k in range(n):
        scan = world.scan_at(Ts[k], max_points=4096, seed=k)
        if k == 0:
            acc, gyr, dt = np.zeros((1, 3), np.float32), np.zeros((1, 3), np.float32), np.zeros(1, np.float32)
        else:
            acc, gyr, dt = (np.asarray(a[k - 1]) for a in (data.accel, data.gyro, data.dt))
        _carry_fused(jf, tf)
        pt, ft, it = tf.step(scan, acc, gyr, dt)
        pj, fj, ij = jf.step(scan, acc, gyr, dt)
        _assert_pose(pt, pj, 2e-2, 5e-3)
        np.testing.assert_allclose(it["velocity"], ij["velocity"], atol=5e-2)
        assert ("smooth_gap" in it) == ("smooth_gap" in ij) == (k > 0)
        gt_rel = np.linalg.inv(Ts[0]) @ Ts[k]
        assert np.linalg.norm(pt.t.numpy() - gt_rel[:3, 3]) < 0.5
    assert tf.smoother.node_count == 4 and len(tf.smoother._accel) == 3
    np.testing.assert_allclose(it["velocity"], np.asarray(gt.v[-1]), atol=0.5)


def _small_odometry(monkeypatch):
    monkeypatch.setattr(O, "OdometryConfig", functools.partial(O.OdometryConfig, **SMALL))


# the keys of the JAX runner's report with --odometry icp|imu --no-figure
# (no odometry-only ATE), and the port's "device"
REPORT_KEYS = {"frames", "keyframes", "loops_closed", "wall_s", "frames_per_s", "output",
               "ate_rmse_m", "device"}


@pytest.mark.parametrize("mode, deskew", [("icp", "const"), ("imu", "gyro")])
def test_runner_front_ends_on_cpu(tmp_path, capsys, monkeypatch, mode, deskew):
    """``run --device cpu --odometry icp|imu --deskew ...`` on a short
    synthetic run (the front end at the small widths): exit 0 and the JAX
    runner's report; ``--batch`` still requires ``--odometry gt``."""
    _small_odometry(monkeypatch)
    out = str(tmp_path / "run")
    argv = ["--device", "cpu", "--frames", "8", "--odometry", mode, "--deskew", deskew,
            "--output", out, "--no-figure"]
    assert trun.main(argv) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(report) == REPORT_KEYS
    assert report["frames"] == 8 and report["keyframes"] >= 2 and np.isfinite(report["ate_rmse_m"])
    assert trun.main([*argv, "--batch", "4"]) == 2
    assert "--batch requires --odometry gt" in capsys.readouterr().err


def test_server_answers_poseless_frames():
    """``SlamServer(odometry="icp", device="cpu")`` answers frames sent
    without a pose through its own ``Odometry`` (here at map 4,096):
    the same poses as an in-process Odometry + Mapper fed the same scans."""
    world = kitti.SyntheticWorld(seed=11, extent=60.0, n_clusters=60, pts_per_cluster=600,
                                 max_range=50.0)
    traj = kitti.loop_trajectory(n_frames=120, radius=20.0, revisit=False)[:6]
    scans = [world.scan_at(traj[k], max_points=4096, seed=k) for k in range(6)]
    server = serve.SlamServer(tiny(tconfig), odometry="icp", device="cpu")
    assert server.odo.cfg == O.OdometryConfig() and server.odo.device.type == "cpu"
    server.odo = O.Odometry(O.OdometryConfig(**FUSED), device="cpu")
    odo = O.Odometry(O.OdometryConfig(**FUSED), device="cpu")
    mapper = Mapper(tiny(tconfig), device="cpu")
    for k, s in enumerate(scans):
        resp = server.handle("frame", {"xyz": s, "pose": None, "stamp": 0.1 * k})
        assert "error" not in resp and np.isfinite(resp["pose"]).all()
        pose, _ = odo.step(s)
        assert (mapper.add_frame(pose, s, stamp=0.1 * k) is not None) == resp["keyframe"]
    np.testing.assert_allclose(server.mapper.trajectory(), mapper.trajectory(), atol=1e-6)
    np.testing.assert_allclose(server.odo.state.pose.t.numpy(), odo.state.pose.t.numpy(), atol=1e-6)
    # ~1 m a frame: the front end followed the truth
    gt_rel = np.linalg.inv(traj[0]) @ traj[-1]
    assert np.linalg.norm(odo.state.pose.t.numpy() - gt_rel[:3, 3]) < 0.5
    plain = serve.SlamServer(tiny(tconfig), device="cpu")
    assert "error" in plain.handle("frame", {"xyz": scans[0], "pose": None, "stamp": 0.0})


def test_front_ends_default_to_the_card():
    if torch.cuda.is_available():
        assert O.Odometry(O.OdometryConfig(**SMALL)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            O.Odometry(O.OdometryConfig(**SMALL))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            O.ImuFusedOdometry(O.OdometryConfig(**SMALL))
