"""Scan deskewing of the PyTorch port (``ops/deskew.py``) against the JAX
package's ``scl_slam_tpu/ops/deskew.py`` on the same numpy inputs.

Tolerances, with their measured sizes:
- sweep times 1e-6 (atan2 and the division may round an ulp apart;
  measured equal);
- the constant-twist deskew 2e-4 m on points up to ~47 m (se3.exp/log and
  the einsum sum in another order: measured 3.8e-6 m);
- the gyro rotations 1e-6 (measured equal);
- the gyro deskew on JAX's own samples 1e-4 m (measured 3.8e-6 m). A point
  whose sweep time lies within an ulp of a sample boundary may take the
  neighbouring sample (one sample's rotation); the inputs here move the 12
  times that fell within 1e-4 of a boundary off it, and the test asserts
  that none is left.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scl_slam_tpu.geometry import se3 as jse3
from scl_slam_tpu.geometry import so3 as jso3
from scl_slam_tpu.ops import deskew as jdsk
from scl_slam_tpu_torch.geometry import se3, so3
from scl_slam_tpu_torch.io import lidar_sim
from scl_slam_tpu_torch.ops import deskew as dsk
from test_torch_kernels import release_jax_programs  # noqa: F401 (autouse)

torch.set_num_threads(2)


def _points(seed, n=2048, masked=64):
    rng = np.random.default_rng(seed)
    xyz = (rng.normal(size=(n, 3)) * 12.0).astype(np.float32)
    mask = np.ones(n, bool)
    mask[rng.choice(n, masked, replace=False)] = False
    return xyz, mask


def _twist(seed, rot=0.3, trans=1.5):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=3)
    w = w / np.linalg.norm(w) * rot
    return np.concatenate([w, rng.normal(size=3) * trans]).astype(np.float32)


@pytest.mark.parametrize("clockwise", [False, True])
def test_azimuth_sweep_times_match_jax(clockwise):
    xyz, mask = _points(0)
    want = np.asarray(jdsk.azimuth_sweep_times(jnp.asarray(xyz), jnp.asarray(mask), clockwise))
    got = dsk.azimuth_sweep_times(torch.from_numpy(xyz), torch.from_numpy(mask), clockwise).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert np.all(got[~mask] == 1.0)


@pytest.mark.parametrize("seed", [1, 2])
def test_deskew_constant_twist_matches_jax(seed):
    xyz, mask = _points(seed)
    tau = np.random.default_rng(seed + 10).uniform(size=len(xyz)).astype(np.float32)
    xi = _twist(seed)
    jm = jse3.exp(jnp.asarray(xi))
    want = np.asarray(jdsk.deskew_constant_twist(
        jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(tau), jm))
    got = dsk.deskew_constant_twist(
        torch.from_numpy(xyz), torch.from_numpy(mask), torch.from_numpy(tau),
        se3.Pose(torch.tensor(np.asarray(jm.R)), torch.tensor(np.asarray(jm.t))),
    ).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)
    assert np.all(got[~mask] == 1e6)


def _gyro(seed, m=48, pads=16):
    """m samples of a varying body rate over a 0.1 s sweep, the last
    ``pads`` of them pads (dt <= 0) holding garbage rates."""
    rng = np.random.default_rng(seed)
    gyro = (rng.normal(size=(m, 3)) * 2.0 + [0.0, 0.0, 4.0]).astype(np.float32)
    dt = rng.uniform(0.5, 1.5, m).astype(np.float32) * np.float32(0.1 / (m - pads))
    dt[m - pads:] = [0.0, -1.0] * (pads // 2)
    gyro[m - pads:] = 99.0
    return gyro, dt


@pytest.mark.parametrize("with_bias", [False, True])
def test_gyro_rotation_samples_match_jax(with_bias):
    gyro, dt = _gyro(3)
    bias = np.float32([0.02, -0.01, 0.05]) if with_bias else None
    Rj, tj = jdsk.gyro_rotation_samples(
        jnp.asarray(gyro), jnp.asarray(dt), None if bias is None else jnp.asarray(bias))
    Rt, tt = dsk.gyro_rotation_samples(
        torch.from_numpy(gyro), torch.from_numpy(dt),
        None if bias is None else torch.from_numpy(bias))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-6)
    # the pads hold the last valid sample's rotation; the fraction ends at 1
    np.testing.assert_array_equal(Rt[-16:].numpy(), Rt[-17:-16].expand(16, 3, 3).numpy())
    assert float(tt[-1]) == 1.0


def test_deskew_gyro_matches_jax():
    """On JAX's own samples: the piecewise rotation and the translation,
    points before the first boundary at the identity rotation."""
    gyro, dt = _gyro(4)
    Rj, tj = jdsk.gyro_rotation_samples(jnp.asarray(gyro), jnp.asarray(dt))
    xyz, mask = _points(5)
    tau = np.random.default_rng(6).uniform(size=len(xyz)).astype(np.float32)
    tau[:32] = np.float32(tj[0]) * 0.5         # before the first boundary
    near = np.min(np.abs(tau[:, None] - np.asarray(tj)[None]), axis=1) < 1e-4
    tau[near] -= np.float32(3e-4)               # boundaries lie ~0.02 apart
    assert np.min(np.abs(tau[:, None] - np.asarray(tj)[None])) > 1e-4
    trans = np.float32([1.2, -0.4, 0.05])
    want = np.asarray(jdsk.deskew_gyro(
        jnp.asarray(xyz), jnp.asarray(mask), jnp.asarray(tau), Rj, tj, jnp.asarray(trans)))
    got = dsk.deskew_gyro(
        torch.from_numpy(xyz), torch.from_numpy(mask), torch.from_numpy(tau),
        torch.tensor(np.asarray(Rj)), torch.tensor(np.asarray(tj)),
        torch.from_numpy(trans),
    ).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert np.all(got[~mask] == 1e6)


def test_constant_rate_gyro_deskew_agrees_with_constant_twist():
    """A constant body rate makes the gyro trajectory the constant twist:
    the two deskews agree within one sample's rotation (the JAX test's
    bound, 0.12 m on ~10 m points)."""
    rng = np.random.default_rng(2)
    xyz = torch.from_numpy((rng.normal(size=(256, 3)) * 5).astype(np.float32))
    mask = torch.ones(256, dtype=torch.bool)
    tau = torch.from_numpy(rng.uniform(size=256).astype(np.float32))
    w = torch.tensor([0.0, 0.0, 0.5])
    Rs, tf = dsk.gyro_rotation_samples((w * 10.0).expand(64, 3).contiguous(),
                                       torch.full((64,), 0.1 / 64))
    out_g = dsk.deskew_gyro(xyz, mask, tau, Rs, tf, torch.zeros(3))
    out_c = dsk.deskew_constant_twist(xyz, mask, tau, se3.Pose(so3.exp(w), torch.zeros(3)))
    assert float(torch.linalg.norm(out_g - out_c, dim=-1).max()) < 0.12


def test_simulator_sweep_deskews_to_the_static_scan():
    """The simulator's motion-smeared sweep, deskewed by its true motion,
    lands near the static scan at the sweep end (the JAX test's bounds on
    non-ground points: p90 NN distance < 0.2 m and < a quarter of the raw
    smear)."""
    scene = lidar_sim.UrbanScene(seed=3)
    sim = lidar_sim.LidarSim(scene, n_azimuth=360, device="cpu")
    circuit = scene.circuit(step=1.0)
    T0, T1 = circuit[10], circuit[13].copy()
    T1[:3, :3] = T1[:3, :3] @ np.asarray(jso3.exp(jnp.asarray([0.0, 0.0, 0.12])), np.float64)
    skewed = sim.scan_at_skewed(T0, T1, seed=7)
    static = torch.from_numpy(sim.scan_at(T1, seed=7))
    motion = np.linalg.inv(T0) @ T1
    mpose = se3.Pose(torch.tensor(motion[:3, :3], dtype=torch.float32),
                     torch.tensor(motion[:3, 3], dtype=torch.float32))
    sk = torch.from_numpy(skewed)
    mask = torch.ones(len(sk), dtype=torch.bool)
    fixed = dsk.deskew_constant_twist(sk, mask, dsk.azimuth_sweep_times(sk, mask), mpose)

    def p90_nn(a):
        a = a[a[:, 2] > -1.2][::5]
        d = torch.cdist(a, static).min(dim=1).values
        return float(torch.quantile(d, 0.9))

    d_skew, d_fix = p90_nn(sk), p90_nn(fixed)
    assert d_fix < 0.2 and d_fix < d_skew / 4, (d_skew, d_fix)
