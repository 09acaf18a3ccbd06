"""The port's LiDAR simulator (``scl_slam_tpu_torch/io/lidar_sim.py``)
against the JAX package's, on the same poses.

Stated tolerances, with their reasons:
- the scene's boxes and the circuits' poses are numpy in both: equal;
- the direction table within 1e-6 (torch's and XLA's f32 cos/sin differ by
  an ulp in some entries; the angles themselves are bit-equal);
- rendered at range_sigma 0: the valid masks equal (0 rays flipped at the
  poses below; a ray grazing a box edge could flip) and the points within
  1e-4 m (3.8e-5 m measured at 512 and 1,800 azimuths: an ulp of a
  direction at a grazing wall hit);
- with JAX's own range noise injected, the three golden scans give the
  fixture's point counts and Scan Context images within the fixture test's
  1e-4 / 1e-5 (no bin moved by the atan2 sector tolerance here).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scl_slam_tpu.io import lidar_sim as J
from scl_slam_tpu_torch.descriptors import scan_context as sc
from scl_slam_tpu_torch.io import lidar_sim as T
from scl_slam_tpu_torch.ops import pointcloud as pc
from test_torch_kernels import release_jax_programs  # noqa: F401 (autouse)

torch.set_num_threads(2)

# rays whose valid flag may differ between the packages at the tested poses
FLIPPED_RAYS = 0


def _anchor_scene():
    return J.UrbanScene(seed=7, blocks=1, block_size=40.0), T.UrbanScene(seed=7, blocks=1, block_size=40.0)


@pytest.mark.parametrize("kw", [
    dict(seed=7, blocks=1, block_size=40.0), dict(seed=3), dict(seed=0, blocks=2, max_boxes=60),
])
def test_scene_boxes_and_circuits_equal(kw):
    js, ts = J.UrbanScene(**kw), T.UrbanScene(**kw)
    assert ts.boxes.dtype == np.float32
    np.testing.assert_array_equal(ts.boxes, np.asarray(js.boxes))
    assert ts.span == js.span
    for ckw in (dict(), dict(lane_offset=2.5), dict(step=0.7, reverse=True)):
        np.testing.assert_array_equal(np.stack(ts.circuit(**ckw)), np.stack(js.circuit(**ckw)))


@pytest.mark.parametrize("n_azimuth", [512, 1024, 1800])
def test_sensor_dirs_agree(n_azimuth):
    ref = np.asarray(jax.jit(J._sensor_dirs, static_argnums=0)(n_azimuth))
    got = T._sensor_dirs(n_azimuth).numpy()
    assert got.shape == ref.shape == (T.N_BEAMS * n_azimuth, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def _render_both(js, ts, pose, n_azimuth, seed, range_sigma, noise=None):
    R, t = np.float32(pose[:3, :3]), np.float32(pose[:3, 3])
    jx, jm = J._render(js.boxes, jnp.asarray(R), jnp.asarray(t), jax.random.PRNGKey(seed),
                       n_azimuth=n_azimuth, range_sigma=range_sigma)
    tx, tm = T._render(torch.from_numpy(ts.boxes), torch.from_numpy(R), torch.from_numpy(t), seed,
                       n_azimuth, range_sigma, noise=noise)
    return np.asarray(jx), np.asarray(jm), tx.numpy(), tm.numpy()


def test_render_matches_jax_without_noise():
    js, ts = _anchor_scene()
    lap = js.circuit(lane_offset=1.0)
    for k in (5, 100, 150):
        jx, jm, tx, tm = _render_both(js, ts, lap[k], 512, k, 0.0)
        assert int((jm != tm).sum()) <= FLIPPED_RAYS
        both = jm & tm
        assert both.sum() > 25_000
        np.testing.assert_allclose(tx[both], jx[both], rtol=0, atol=1e-4)
        assert (tx[~tm] == 1e6).all()


def test_golden_fixtures_with_jax_noise():
    """tests/golden/realistic_sc.npz through the port: the JAX draws of
    each scan's PRNGKey injected as ``noise``."""
    _, ts = _anchor_scene()
    sim = T.LidarSim(ts, n_azimuth=1800, device="cpu")
    lap = ts.circuit(step=1.0)
    gold = np.load("tests/golden/realistic_sc.npz")
    cfg = sc.ScanContextConfig(lidar_height=T.SENSOR_HEIGHT)
    for i in (5, 100, 150):
        noise = np.asarray(jax.random.normal(jax.random.PRNGKey(i), (sim.points_per_scan,)))
        scan = sim.scan_at(lap[i], seed=i, noise=noise)
        assert scan.shape[0] == int(gold[f"n_points_{i}"])
        d = sc.make(pc.from_points(torch.from_numpy(scan), 131072), cfg)
        np.testing.assert_allclose(d.image.numpy(), gold[f"image_{i}"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(d.ring_key.numpy(), gold[f"ring_key_{i}"], rtol=0, atol=1e-5)


def test_skewed_scans():
    """``scan_at_skewed`` with T0 == T1 equals ``scan_at`` exactly, and a
    moving sweep (tests/test_deskew.py's) agrees with JAX's under JAX's
    noise."""
    js, ts = J.UrbanScene(seed=3), T.UrbanScene(seed=3)
    jsim, tsim = J.LidarSim(js, n_azimuth=360), T.LidarSim(ts, n_azimuth=360, device="cpu")
    c = ts.circuit(step=1.0)
    T0, T1 = c[10], c[13].copy()
    yaw = 0.12
    T1[:3, :3] = T1[:3, :3] @ np.array(
        [[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1.0]])
    np.testing.assert_array_equal(tsim.scan_at_skewed(T0, T0, seed=7), tsim.scan_at(T0, seed=7))
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (tsim.points_per_scan,)))
    ref = jsim.scan_at_skewed(T0, T1, seed=7)
    got = tsim.scan_at_skewed(T0, T1, seed=7, noise=noise)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_noise_stream():
    """The port's own draws: reproducible by seed, another seed moves the
    ranges, and the valid set never depends on them."""
    _, ts = _anchor_scene()
    sim = T.LidarSim(ts, n_azimuth=256, device="cpu")
    pose = ts.circuit()[40]
    a, b = sim.scan_at(pose, seed=1), sim.scan_at(pose, seed=1)
    other = sim.scan_at(pose, seed=2)
    quiet = sim.scan_at(pose, noise=np.zeros(sim.points_per_scan, np.float32))
    np.testing.assert_array_equal(a, b)
    assert a.shape == other.shape == quiet.shape
    assert 0.0 < np.abs(a - other).max() < 0.2
    r_a, r_q = np.linalg.norm(a, axis=1), np.linalg.norm(quiet, axis=1)
    assert 0.01 < np.std(r_a - r_q) < 0.03          # range_sigma 0.02


def test_lidar_sim_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.LidarSim(T.UrbanScene(seed=0, blocks=1))
