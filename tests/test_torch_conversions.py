"""The Euler and quaternion conversions of the PyTorch port
(``so3.to_euler``, ``quat_to_matrix``, ``matrix_to_quat``;
``se3.from/to_xyzrpy``, ``from/to_quat_trans``) against the JAX package on
the same numpy inputs: random rotations, pitch at and near +-pi/2, the
180-degree rotations about each axis (where Shepperd's method switches
branch) and quaternions with w < 0 (the sign rule).

Tolerance: 2e-6 absolute on unit-scale entries and angles (other
sin/cos/atan2/sqrt implementations, a few f32 ulps apart). Where pitch sits
at +-pi/2 the roll and yaw are atan2 of two roundings and carry no
information; there the test holds the matrix the angles rebuild, not the
angles.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scl_slam_tpu.geometry import se3 as jse3
from scl_slam_tpu.geometry import so3 as jso3
from scl_slam_tpu_torch.geometry import se3, so3
from test_torch_kernels import release_jax_programs  # noqa: F401 (autouse)

ATOL = 2e-6


def _rpy(seed):
    rng = np.random.RandomState(seed)
    rpy = rng.uniform(-np.pi, np.pi, (24, 3))
    rpy[:, 1] = rng.uniform(-np.pi / 2, np.pi / 2, 24)
    edge = np.array([
        [0.3, np.pi / 2, -0.7], [0.3, -np.pi / 2, -0.7],
        [1.0, np.pi / 2 - 1e-4, 2.0], [-2.0, -np.pi / 2 + 1e-4, 0.5],
        [np.pi, 0.0, 0.0], [0.0, 0.0, np.pi], [0.0, 0.0, 0.0],
    ])
    return np.concatenate([rpy, edge]).astype(np.float32)


def _rotations():
    """Random rotations, pitch +-pi/2, and the 180-degree rotations."""
    R = np.asarray(jso3.from_euler(jnp.asarray(_rpy(0))))
    flips = np.stack([np.diag(d) for d in ([1, -1, -1], [-1, 1, -1], [-1, -1, 1])])
    # a 180-degree rotation about a skew axis: 2 a a^T - I
    a = np.array([1.0, 2.0, -2.0]) / 3.0
    skew = 2 * np.outer(a, a) - np.eye(3)
    return np.concatenate([R, flips, skew[None]]).astype(np.float32)


def _j(x):
    return np.array(x)


def test_to_euler_matches_jax():
    R = _rotations()
    got = so3.to_euler(torch.from_numpy(R)).numpy()
    ref = _j(jso3.to_euler(jnp.asarray(R)))
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_euler_round_trip_at_pitch_half_pi():
    rpy = _rpy(1)
    R = so3.from_euler(torch.from_numpy(rpy))
    back = so3.to_euler(R)
    np.testing.assert_allclose(
        so3.from_euler(back).numpy(),
        _j(jso3.from_euler(jso3.to_euler(jnp.asarray(R.numpy())))),
        atol=ATOL,
    )
    np.testing.assert_allclose(so3.from_euler(back).numpy(), R.numpy(), atol=1e-3)
    # away from the gimbal lock the angles themselves come back
    ok = np.abs(np.abs(rpy[:, 1]) - np.pi / 2) > 1e-2
    diff = np.angle(np.exp(1j * (back.numpy()[ok] - rpy[ok])))   # +-pi is one angle
    np.testing.assert_allclose(diff, 0.0, atol=1e-5)


def test_quat_to_matrix_matches_jax():
    rng = np.random.RandomState(2)
    q = rng.normal(size=(32, 4)).astype(np.float32)
    q[:8, 0] = -np.abs(q[:8, 0])   # w < 0 gives the same rotation
    q[8] = [0, 1, 0, 0]
    q[9] = [0, 0, 0, -1]
    q[10] = [3, 0, 0, 0]            # normalized first
    got = so3.quat_to_matrix(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got, _j(jso3.quat_to_matrix(jnp.asarray(q))), atol=ATOL)
    np.testing.assert_allclose(
        got[:8], so3.quat_to_matrix(torch.from_numpy(-q[:8])).numpy(), atol=ATOL)


def test_matrix_to_quat_matches_jax_with_the_sign_rule():
    R = _rotations()
    got = so3.matrix_to_quat(torch.from_numpy(R)).numpy()
    ref = _j(jso3.matrix_to_quat(jnp.asarray(R)))
    np.testing.assert_allclose(got, ref, atol=ATOL)
    assert (got[:, 0] >= 0).all()
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=ATOL)
    # the quaternion rebuilds the matrix (all four Shepperd branches)
    np.testing.assert_allclose(
        so3.quat_to_matrix(torch.from_numpy(got)).numpy(), R, atol=1e-5)
    keys = np.stack([np.trace(R, axis1=1, axis2=2), R[:, 0, 0], R[:, 1, 1], R[:, 2, 2]], -1)
    assert set(np.argmax(keys, -1).tolist()) == {0, 1, 2, 3}


@pytest.mark.parametrize("kind", ["xyzrpy", "quat_trans"])
def test_se3_conversions_match_jax(kind):
    rng = np.random.RandomState(3)
    t = rng.uniform(-50, 50, (31, 3)).astype(np.float32)
    rpy = _rpy(4)
    if kind == "xyzrpy":
        x = np.concatenate([t, rpy], -1)
        p = se3.from_xyzrpy(torch.from_numpy(x))
        jp = jse3.from_xyzrpy(jnp.asarray(x))
        np.testing.assert_allclose(p.R.numpy(), _j(jp.R), atol=ATOL)
        np.testing.assert_array_equal(p.t.numpy(), _j(jp.t))
        back = se3.to_xyzrpy(se3.Pose(torch.from_numpy(_j(jp.R)), p.t)).numpy()
        np.testing.assert_allclose(back, _j(jse3.to_xyzrpy(jp)), atol=ATOL)
    else:
        q = rng.normal(size=(31, 4)).astype(np.float32)
        p = se3.from_quat_trans(torch.from_numpy(q), torch.from_numpy(t))
        jp = jse3.from_quat_trans(jnp.asarray(q), jnp.asarray(t))
        np.testing.assert_allclose(p.R.numpy(), _j(jp.R), atol=ATOL)
        np.testing.assert_array_equal(p.t.numpy(), _j(jp.t))
        q2, t2 = se3.to_quat_trans(se3.Pose(torch.from_numpy(_j(jp.R)), p.t))
        jq2, jt2 = jse3.to_quat_trans(jp)
        np.testing.assert_allclose(q2.numpy(), _j(jq2), atol=ATOL)
        np.testing.assert_array_equal(t2.numpy(), _j(jt2))
        # the same rotation as the normalized input, up to the sign rule
        qn = q / np.linalg.norm(q, axis=-1, keepdims=True)
        qn *= np.where(qn[:, :1] < 0, -1.0, 1.0)
        np.testing.assert_allclose(q2.numpy(), qn, atol=1e-5)
