"""IMU preintegration (``runtime/imu.py``) and the 15-state IMU window
smoother (``graph/imu_factor.py``) of the PyTorch port against the JAX
package, at a window of 4 states with 16 samples an interval.

The JAX module takes the window's Jacobian by ``jax.jacfwd`` through the
re-preintegration; the port's is a closed form (``imu_factor._linearize``).
It is held against ``jax.jacfwd`` of the same ``r_of`` in f32 and against
``torch.func.jacfwd`` of the port's own residuals in f64 (the test's
witness only; the package never takes a forward-mode derivative).

Tolerances, with their measured sizes:
- preintegration: delta_R 1e-6, delta_v / delta_p 1e-5 (measured ~1e-7;
  the sum order of a 3 x 3 product);
- residuals 1e-3 of their largest (weights to 1e4 scale f32 roundings of
  the poses; measured ~6e-5);
- the Jacobian: 2e-3 of each column's largest entry against ``jacfwd``
  (measured 1.8e-4: the arccos rows take the tangent at cos_t rounded in
  another order), 1e-6 in f64 against ``torch.func`` (measured 4e-8);
- solve_window: states 2e-4 (v and b_a 5e-4), chi2 history 5e-2
  relative or 1e-8 of the starting chi2 (measured: states <= 5.3e-5;
  chi2 2% on the bias problem, where each step lowers it by a few percent
  only; on the noisy problem, which reaches the f32 floor in one step,
  1.9e-5 against 2.3e-5 of a start of 1.9e4);
- the smoother past its window: 5e-3 m, 5e-2 m/s (its first solve starts
  at chi2 ~1e8 from the unfilled nodes, a step whose f32 solve carries
  ~10% error in both packages; measured 5e-3 m / 2.4e-2 m/s on the
  harder odometry window, here below).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scl_slam_tpu.geometry import se3 as jse3
from scl_slam_tpu.geometry import so3 as jso3
from scl_slam_tpu.graph import imu_factor as JIF
from scl_slam_tpu.runtime import imu as jimu
from scl_slam_tpu_torch.geometry import se3
from scl_slam_tpu_torch.graph import imu_factor as IF
from scl_slam_tpu_torch.runtime import imu
from test_imu_factor import simulate
from test_torch_kernels import release_jax_programs  # noqa: F401 (autouse)

torch.set_num_threads(2)

N_STATES, SAMPLES = 4, 16
CFG = dict(prior_vel_sigma=10.0, prior_bias_sigma=1.0)


def T(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _samples(seed, batch=3, m=SAMPLES, pads=4):
    rng = np.random.default_rng(seed)
    accel = (rng.normal(size=(batch, m, 3)) + [0.0, 0.0, 9.81]).astype(np.float32)
    gyro = (rng.normal(size=(batch, m, 3)) * 0.5).astype(np.float32)
    dt = np.full((batch, m), 0.01, np.float32)
    dt[:, m - pads:] = [0.0, -1.0] * (pads // 2)
    return accel, gyro, dt


@pytest.mark.parametrize("with_bias", [False, True])
def test_preintegrate_matches_jax(with_bias):
    """Batched over 3 intervals in one loop against JAX's interval at a
    time; the pads (dt <= 0) ignored, the biases removed."""
    accel, gyro, dt = _samples(0)
    bg = np.float32([[0.01, -0.02, 0.03]] * 3) if with_bias else None
    ba = np.float32([[0.1, 0.05, -0.2]] * 3) if with_bias else None
    got = imu.preintegrate(T(accel), T(gyro), T(dt),
                           None if bg is None else T(bg), None if ba is None else T(ba))
    for i in range(3):
        want = jimu.preintegrate(
            jnp.asarray(accel[i]), jnp.asarray(gyro[i]), jnp.asarray(dt[i]),
            None if bg is None else jnp.asarray(bg[i]), None if ba is None else jnp.asarray(ba[i]))
        np.testing.assert_allclose(got.delta_R[i].numpy(), np.asarray(want.delta_R), atol=1e-6)
        np.testing.assert_allclose(got.delta_v[i].numpy(), np.asarray(want.delta_v), atol=1e-5)
        np.testing.assert_allclose(got.delta_p[i].numpy(), np.asarray(want.delta_p), atol=1e-5)
        assert float(got.dt_total[i]) == pytest.approx(float(want.dt_total), abs=1e-7)
        assert int(got.count[i]) == int(want.count) == SAMPLES - 4


def test_gyro_delta_rotation_matches_jax():
    bias = np.float32([0.01, -0.02, 0.005])
    gyro = np.tile(bias, (50, 1)) + np.float32([0.0, 0.0, 0.8])
    dt = np.full(50, 0.01, np.float32)
    want = jimu.gyro_delta_rotation(jnp.asarray(gyro), jnp.asarray(dt), jnp.asarray(bias))
    got = imu.gyro_delta_rotation(T(gyro), T(dt), T(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # pure bias integrates to the identity
    np.testing.assert_allclose(
        imu.gyro_delta_rotation(T(np.tile(bias, (50, 1))), T(dt), T(bias)).numpy(),
        np.eye(3), atol=1e-6)


def test_synthesized_samples_match_jax():
    R1 = np.asarray(jso3.exp(jnp.array([0.02, -0.05, 0.3])), np.float64)
    T0, T1 = np.eye(4), np.eye(4)
    T1[:3, :3] = R1
    T1[:3, 3] = [1.0, 0.5, 0.0]
    want = jimu.synthesize_between_frames(T0, T1, 20, 0.005)
    got = imu.synthesize_between_frames(T0, T1, 20, 0.005)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=1e-5)
    pre = imu.preintegrate(*(T(a) for a in got))
    np.testing.assert_allclose(pre.delta_R.numpy(), R1, atol=2e-3)


def _problem(seed=1):
    """simulate()'s window with biases, its states moved off the truth."""
    gt, data, rel = simulate(n_states=N_STATES, m=SAMPLES, seed=seed,
                             bg=[0.01, -0.02, 0.015], ba=[0.1, -0.05, 0.2])
    rng = np.random.RandomState(seed + 2)
    R = np.stack([np.asarray(jso3.exp(jnp.asarray(rng.normal(0, 0.02, 3), jnp.float32))) @ np.asarray(r)
                  for r in gt.R]).astype(np.float32)
    x = JIF.ImuStates(
        R=jnp.asarray(R), p=gt.p + jnp.asarray(rng.normal(0, 0.05, (N_STATES, 3)), jnp.float32),
        v=gt.v + jnp.asarray(rng.normal(0, 0.1, (N_STATES, 3)), jnp.float32),
        bg=jnp.zeros_like(gt.bg), ba=jnp.zeros_like(gt.ba),
    )
    return gt, data, rel, x


def _port(gt, data, rel, x, dtype=torch.float32):
    return (IF.ImuStates(*(T(a, dtype) for a in x)), IF.ImuWindowData(*(T(a, dtype) for a in data)),
            se3.Pose(T(rel.R, dtype), T(rel.t, dtype)), IF.ImuStates(*(T(a, dtype) for a in gt)))


def test_residuals_match_jax():
    gt, data, rel, x = _problem()
    residuals = jax.jit(JIF.residuals, static_argnames="cfg")
    want = np.asarray(residuals(x, data, rel, gt, cfg=JIF.ImuFactorConfig(**CFG)))
    got = IF.residuals(*_port(gt, data, rel, x), IF.ImuFactorConfig(**CFG)).numpy()
    assert got.shape == want.shape == (21 * (N_STATES - 1) + 15,)
    np.testing.assert_allclose(got, want, atol=1e-3 * np.abs(want).max())
    # the truth is a zero residual but for f32 integration noise
    r_gt = IF.residuals(*_port(gt, data, rel, gt), IF.ImuFactorConfig(**CFG))
    r_gt_jax = residuals(gt, data, rel, gt, cfg=JIF.ImuFactorConfig(**CFG))
    assert float(r_gt.abs().max()) < 2e-2 and float(jnp.max(jnp.abs(r_gt_jax))) < 2e-2


def test_jacobian_matches_jax_jacfwd_and_f64_forward_mode():
    gt, data, rel, x = _problem()
    n = N_STATES

    def r_of(delta):
        return JIF.residuals(JIF.retract(x, delta.reshape(n, 15)), data, rel, gt,
                             JIF.ImuFactorConfig(**CFG))

    J_jax = np.asarray(jax.jit(jax.jacfwd(r_of))(jnp.zeros(n * 15)))
    xs, dd, rr, pr = _port(gt, data, rel, x)
    r, J = IF._linearize(IF.retract(xs, torch.zeros(n, 15)), dd, rr, pr, IF.ImuFactorConfig(**CFG))
    np.testing.assert_allclose(r.numpy(), np.asarray(jax.jit(r_of)(jnp.zeros(n * 15))),
                               atol=1e-3 * float(r.abs().max()))
    scale = np.abs(J_jax).max(axis=0) + 1e-12
    assert np.max(np.abs(J.numpy() - J_jax) / scale) < 2e-3

    xs, dd, rr, pr = _port(gt, data, rel, x, torch.float64)
    cfg = IF.ImuFactorConfig(**CFG)
    _, J64 = IF._linearize(IF.retract(xs, torch.zeros(n, 15, dtype=torch.float64)), dd, rr, pr, cfg)

    def r64(delta):
        return IF.residuals(IF.retract(xs, delta.reshape(n, 15)), dd, rr, pr, cfg)

    J_fwd = torch.func.jacfwd(r64)(torch.zeros(n * 15, dtype=torch.float64)).numpy()
    scale = np.abs(J_fwd).max(axis=0) + 1e-12
    assert np.max(np.abs(J64.numpy() - J_fwd) / scale) < 1e-6


@pytest.mark.parametrize("case", ["biases", "noisy_poses"])
def test_solve_window_matches_jax(case):
    """tests/test_imu_factor.py's two solves at a window of 4: the biases
    and velocities recovered from exact relative poses, and noisy poses
    smoothed towards the inertial kinematics."""
    if case == "biases":
        gt, data, rel = simulate(n_states=N_STATES, m=SAMPLES, h=0.02, seed=3,
                                 bg=[0.01, -0.02, 0.015], ba=[0.1, -0.05, 0.2])
        x0 = gt._replace(v=jnp.zeros_like(gt.v), bg=jnp.zeros_like(gt.bg), ba=jnp.zeros_like(gt.ba))
        prior = x0._replace(v=gt.v)
        cfg = dict(CFG, prior_vel_sigma=0.01, odom_rot_sigma=1e-3, odom_trans_sigma=1e-3)
    else:
        gt, data, rel = simulate(n_states=N_STATES, m=SAMPLES, seed=5)
        rng = np.random.RandomState(11)
        x0 = gt._replace(p=jnp.asarray(np.asarray(gt.p) + rng.normal(0, 0.05, (N_STATES, 3)),
                                       jnp.float32))
        prior, cfg = gt, CFG
    xj, cj = JIF.solve_window(x0, data, rel, prior, cfg=JIF.ImuFactorConfig(**cfg), gn_iters=8)
    xt, ct = IF.solve_window(
        IF.imu_states_from_numpy(x0, "cpu"), IF.ImuWindowData(*(T(a) for a in data)),
        se3.Pose(T(rel.R), T(rel.t)), IF.imu_states_from_numpy(prior, "cpu"),
        cfg=IF.ImuFactorConfig(**cfg), gn_iters=8,
    )
    for f in IF.ImuStates._fields:
        tol = 5e-4 if f in ("v", "ba") else 2e-4
        np.testing.assert_allclose(getattr(xt, f).numpy(), np.asarray(getattr(xj, f)), atol=tol)
    cj = np.asarray(cj)
    # below 1e-8 of the start chi2 is the f32 floor, where the two packages'
    # roundings decide what is left (the noisy problem reaches it in one step)
    np.testing.assert_allclose(ct.numpy(), cj, rtol=5e-2, atol=1e-8 * float(cj[0]))
    assert float(ct[-1]) < float(ct[0]) * 1e-3


def test_smoother_past_its_window_matches_jax():
    """Six intervals pushed through a window of 4 (two slides), each with
    its relative pose, node pose and velocity seed, solved after each push
    as the fused front end does."""
    gt, data, rel = simulate(n_states=7, m=SAMPLES, seed=7)
    cfg = dict(CFG)
    js = JIF.ImuSmoother(N_STATES, SAMPLES, JIF.ImuFactorConfig(**cfg))
    ts = IF.ImuSmoother(N_STATES, SAMPLES, IF.ImuFactorConfig(**cfg), device="cpu")
    for s in (js, ts):
        s.set_node_pose(0, np.asarray(gt.R[0]), np.asarray(gt.p[0]))
    for i in range(6):
        k = min(i + 1, N_STATES - 1)
        args = (np.asarray(data.accel[i]), np.asarray(data.gyro[i]), np.asarray(data.dt[i]))
        js.push_interval(*args, jse3.Pose(rel.R[i], rel.t[i]))
        ts.push_interval(*args, se3.Pose(T(rel.R[i]), T(rel.t[i])))
        for s in (js, ts):
            s.set_node_pose(k, np.asarray(gt.R[i + 1]), np.asarray(gt.p[i + 1]))
            s.set_node_velocity(k, np.asarray(gt.v[i + 1]) * 0.9)
        xj, cj = js.solve(gn_iters=4)
        xt, ct = ts.solve(gn_iters=4)
        assert ts.node_count == js.node_count == min(i + 2, N_STATES)
        np.testing.assert_allclose(xt.p.numpy(), np.asarray(xj.p), atol=5e-3)
        np.testing.assert_allclose(xt.v.numpy(), np.asarray(xj.v), atol=5e-2)
        np.testing.assert_allclose(xt.R.numpy(), np.asarray(xj.R), atol=1e-3)
    # the window holds the last 4 states of the truth
    np.testing.assert_allclose(xt.p.numpy(), np.asarray(gt.p[3:]), atol=0.05)


def test_states_carry_across_and_back():
    gt, _, _, _ = _problem()
    xt = IF.imu_states_from_numpy(gt, "cpu")
    back = IF.imu_states_to_numpy(xt)
    for f in IF.ImuStates._fields:
        np.testing.assert_array_equal(getattr(back, f), np.asarray(getattr(gt, f)))
        assert getattr(xt, f).dtype == torch.float32
    assert IF.make_states(5, "cpu").R.shape == (5, 3, 3)


def test_smoother_defaults_to_the_card():
    if torch.cuda.is_available():
        assert IF.ImuSmoother().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            IF.ImuSmoother()
