"""SO(3)/SE(3) of the PyTorch port against the JAX package, on the same
numpy inputs, including the identity and pi rotations (the branches where
f32 goes wrong first).

Tolerance: 2e-6 absolute on unit-scale rotation entries and twists, and
on translations of a few meters relative 2e-6 — the two libraries sum
the 3x3 products in other orders and use other sin/cos/arccos, a few f32
ulps apart; near pi the axis extraction is conditioned ~1/sqrt(eps), so
log is held at 2e-3 there.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scl_slam_tpu.geometry import se3 as jse3
from scl_slam_tpu.geometry import so3 as jso3
from scl_slam_tpu_torch.geometry import se3, so3
from test_torch_kernels import release_jax_programs  # noqa: F401 (autouse)

torch.set_num_threads(2)

ATOL = 2e-6


def _j(x):
    return np.array(x)  # a writable copy


def _t(x):
    return x.numpy()


def _axis_angles(seed):
    rng = np.random.RandomState(seed)
    axes = rng.normal(size=(16, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = np.concatenate([
        [0.0, 1e-7, 1e-4, 0.3, 0.49, 0.51, 1.0, 2.0, 3.0],
        [np.pi - 1e-3, np.pi - 1e-5, np.float32(np.pi)],
        rng.uniform(0, np.pi, 4),
    ])
    return (axes * angles[:, None]).astype(np.float32)


def test_hat_vee_exp_left_jacobians():
    w = _axis_angles(0)
    tw = torch.from_numpy(w)
    np.testing.assert_array_equal(_t(so3.hat(tw)), _j(jso3.hat(jnp.asarray(w))))
    np.testing.assert_array_equal(_t(so3.vee(so3.hat(tw))), w)
    for fp, fj in ((so3.exp, jso3.exp), (so3.left_jacobian, jso3.left_jacobian),
                   (so3.left_jacobian_inv, jso3.left_jacobian_inv)):
        got, ref = _t(fp(tw)), _j(fj(jnp.asarray(w)))
        np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL * max(1.0, np.abs(ref).max()))


def test_log_including_identity_and_pi():
    w = _axis_angles(1)
    R = np.array(jso3.exp(jnp.asarray(w)))
    got = _t(so3.log(torch.from_numpy(R)))
    ref = _j(jso3.log(jnp.asarray(R)))
    angle = np.linalg.norm(w, axis=1)
    near_pi = angle > np.pi - 1e-2
    np.testing.assert_allclose(got[~near_pi], ref[~near_pi], rtol=0, atol=ATOL)
    # the sign of an axis at exactly pi is a convention both share
    np.testing.assert_allclose(got[near_pi], ref[near_pi], rtol=0, atol=2e-3)
    assert np.all(np.isfinite(got))
    # exact identity and exact pi about z (both packages clamp the
    # arccos argument 1e-7 inside [-1, 1], so pi reads pi - 4.9e-4)
    Rz = np.diag([-1.0, -1.0, 1.0]).astype(np.float32)
    Rs = np.stack([np.eye(3, dtype=np.float32), Rz])
    got = _t(so3.log(torch.from_numpy(Rs)))
    np.testing.assert_allclose(got, _j(jso3.log(jnp.asarray(Rs))), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, [[0, 0, 0], [0, 0, np.pi]], atol=1e-3)


def test_orthonormalize_and_from_euler():
    rng = np.random.RandomState(2)
    R = _j(jso3.exp(jnp.asarray(_axis_angles(2))))
    R = (R + rng.normal(0, 1e-4, R.shape)).astype(np.float32)
    np.testing.assert_allclose(
        _t(so3.orthonormalize(torch.from_numpy(R))),
        _j(jso3.orthonormalize(jnp.asarray(R))), rtol=0, atol=ATOL,
    )
    rpy = rng.uniform(-np.pi, np.pi, (32, 3)).astype(np.float32)
    np.testing.assert_allclose(
        _t(so3.from_euler(torch.from_numpy(rpy))),
        _j(jso3.from_euler(jnp.asarray(rpy))), rtol=0, atol=ATOL,
    )


def _poses(seed, n=16):
    rng = np.random.RandomState(seed)
    R = _j(jso3.exp(jnp.asarray(_axis_angles(seed)[:n])))
    t = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
    return R, t


@pytest.mark.parametrize("op", ["compose", "between", "inverse", "transform_points"])
def test_se3_algebra(op):
    Ra, ta = _poses(3)
    Rb, tb = _poses(4)
    pa, pb = se3.Pose(torch.from_numpy(Ra), torch.from_numpy(ta)), se3.Pose(torch.from_numpy(Rb), torch.from_numpy(tb))
    ja, jb = jse3.Pose(jnp.asarray(Ra), jnp.asarray(ta)), jse3.Pose(jnp.asarray(Rb), jnp.asarray(tb))
    if op == "transform_points":
        pts = np.random.RandomState(5).uniform(-40, 40, (16, 64, 3)).astype(np.float32)
        got = _t(se3.transform_points(pa, torch.from_numpy(pts)))
        ref = _j(jse3.transform_points(ja, jnp.asarray(pts)))
        np.testing.assert_allclose(got, ref, rtol=2e-6, atol=2e-5)
        return
    if op == "inverse":
        got, ref = se3.inverse(pa), jse3.inverse(ja)
    else:
        got, ref = getattr(se3, op)(pa, pb), getattr(jse3, op)(ja, jb)
    np.testing.assert_allclose(_t(got.R), _j(ref.R), rtol=0, atol=ATOL)
    np.testing.assert_allclose(_t(got.t), _j(ref.t), rtol=2e-6, atol=2e-5)


def test_se3_exp_log_and_identity():
    rng = np.random.RandomState(6)
    xi = np.concatenate([_axis_angles(6)[:12], rng.uniform(-5, 5, (12, 3))], axis=1).astype(np.float32)
    got = se3.exp(torch.from_numpy(xi))
    ref = jse3.exp(jnp.asarray(xi))
    np.testing.assert_allclose(_t(got.R), _j(ref.R), rtol=0, atol=ATOL)
    np.testing.assert_allclose(_t(got.t), _j(ref.t), rtol=0, atol=2e-5)
    back = _t(se3.log(got))
    ref_back = _j(jse3.log(ref))
    np.testing.assert_allclose(back[:9], ref_back[:9], rtol=0, atol=2e-5)
    ident = se3.identity((4,))
    assert torch.equal(ident.R, torch.eye(3).expand(4, 3, 3)) and not ident.t.any()


@pytest.mark.parametrize("op", ["retract", "local", "adjoint", "matrix", "take"])
def test_se3_solver_helpers(op):
    """The SE(3) helpers the pose-graph solver and the runner use."""
    Ra, ta = _poses(7)
    Rb, tb = _poses(8)
    pa, pb = se3.Pose(torch.from_numpy(Ra), torch.from_numpy(ta)), se3.Pose(torch.from_numpy(Rb), torch.from_numpy(tb))
    ja, jb = jse3.Pose(jnp.asarray(Ra), jnp.asarray(ta)), jse3.Pose(jnp.asarray(Rb), jnp.asarray(tb))
    if op == "retract":
        xi = np.random.RandomState(9).normal(0, 0.3, (16, 6)).astype(np.float32)
        got, ref = se3.retract(pa, torch.from_numpy(xi)), jse3.retract(ja, jnp.asarray(xi))
        np.testing.assert_allclose(_t(got.R), _j(ref.R), rtol=0, atol=ATOL)
        np.testing.assert_allclose(_t(got.t), _j(ref.t), rtol=2e-6, atol=2e-5)
    elif op == "local":
        # pairs away from a pi relative rotation (log's ill-conditioned end)
        got, ref = _t(se3.local(pa, pa)), _j(jse3.local(ja, ja))
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)
        near = se3.retract(pa, torch.full((16, 6), 0.2))
        jnear = jse3.retract(ja, jnp.full((16, 6), 0.2))
        np.testing.assert_allclose(_t(se3.local(pa, near)), _j(jse3.local(ja, jnear)), rtol=0, atol=2e-5)
    elif op == "adjoint":
        np.testing.assert_allclose(_t(se3.adjoint(pb)), _j(jse3.adjoint(jb)), rtol=2e-6, atol=2e-5)
    elif op == "matrix":
        T = _t(se3.to_matrix(pa))
        np.testing.assert_array_equal(T, _j(jse3.to_matrix(ja)))
        back = se3.from_matrix(torch.from_numpy(T))
        assert torch.equal(back.R, pa.R) and torch.equal(back.t, pa.t)
    else:
        idx = np.array([3, 0, 15, 3], np.int32)
        got = se3.take(pa, torch.from_numpy(idx))
        np.testing.assert_array_equal(_t(got.R), _j(jse3.take(ja, jnp.asarray(idx)).R))
        st = se3.stack([se3.index(pa, 2), se3.index(pb, 5)])
        np.testing.assert_array_equal(_t(st.t), np.stack([ta[2], tb[5]]))
