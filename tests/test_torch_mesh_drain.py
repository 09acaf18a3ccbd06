"""The port's mesh-attached drain (``Mapper.attach_mesh``: chordal
rotation init, then the edge-sharded Gauss-Newton over the mesh), the
counterparts of the six tests of ``tests/test_mesh_drain.py``, in two gloo
ranks (``torch_rank_tasks.mesh_drain_scenarios``, spawned once for the
module), with the same odometry chains and loop factors; the mesh drain's
result is held against the JAX package's chordal init + sharded solve on
the port's drained graph, on a 2-device slice of the virtual CPU mesh.

Tolerances: the JAX function's steps within ``test_torch_sharded.py``'s
(translations 3e-4 m, rotations 3e-5); the rest as the JAX tests hold
theirs (the two drains' optimum within 5e-2 m, ATE ratios, a frozen chi2
history within 1e-5 relative, gamma = 0 within 1e-5 m).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from scl_slam_tpu.geometry import se3 as jse3
from scl_slam_tpu.graph.rotation_init import chordal_rotation_init
from scl_slam_tpu.parallel import sharded as jsharded
from scl_slam_tpu_torch.parallel import multihost
from test_torch_kernels import release_jax_programs  # noqa: F401 (autouse)
from test_torch_solver import _jax_graph
import torch_rank_tasks

N = 24  # keyframes around the loop


def _rz(a):
    return np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])


def circle(n, radius=10.0):
    """``test_graph.circle_trajectory`` as [n, 4, 4] numpy poses."""
    out = []
    for a in np.linspace(0, 2 * np.pi, n, endpoint=False):
        T = np.eye(4)
        T[:3, :3] = _rz(a + np.pi / 2)
        T[:3, 3] = [radius * np.cos(a), radius * np.sin(a), 0.0]
        out.append(T)
    return np.stack(out)


def drifting(gt, yaw_drift=0.02, trans_drift=0.05):
    """``test_mesh_drain.drifting_circle``'s odometry: per-frame drift."""
    drift = np.eye(4)
    drift[:3, :3] = _rz(yaw_drift)
    drift[0, 3] = trans_drift
    odom = [gt[0]]
    for k in range(1, len(gt)):
        odom.append(odom[-1] @ np.linalg.inv(gt[k - 1]) @ gt[k] @ drift)
    return np.stack(odom)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    gt = circle(N)
    data = {"gt": gt, "odom": drifting(gt), "odom_severe": drifting(gt, 0.12, 0.1)}
    outs = multihost.spawn(torch_rank_tasks.mesh_drain_scenarios, 2, (data,), device="cpu",
                           threads=2, workdir=str(tmp_path_factory.mktemp("ranks")))
    return gt, outs


def ate(traj, gt):
    return float(np.sqrt(np.mean(np.sum((traj[:, :3, 3] - gt[: len(traj), :3, 3]) ** 2, -1))))


def test_two_stage_matches_single_device_drain(runs):
    gt, outs = runs
    r = outs[0]["two_stage"]
    assert np.isfinite(r["chi_single"]).all() and np.isfinite(r["chi_mesh"]).all()
    assert r["queues"] == (0, 0) and r["broken"] == 0
    before = ate(r["before"], gt)
    assert ate(r["single"], gt) < 0.5 * before
    assert ate(r["mesh"], gt) < 0.5 * before
    np.testing.assert_allclose(r["single"][:, :3, 3], r["mesh"][:, :3, 3], atol=0.05)
    # both ranks hold the same trajectory
    np.testing.assert_array_equal(outs[1]["two_stage"]["mesh"], r["mesh"])
    # the JAX package's two stages on the port's drained graph
    cfg = torch_rank_tasks.drain_cfg().optimizer
    R0, t0 = r["slots_before"]
    G = _jax_graph(r["graph"])
    init = chordal_rotation_init(G, jse3.Pose(jnp.asarray(R0), jnp.asarray(t0)))
    poses, chis = jsharded.sharded_solve(
        Mesh(np.array(jax.devices()[:2]), ("shard",)), "shard", G, init,
        gn_iters=cfg.max_outer_rounds, cg_iters=cfg.cg_iters, damping=cfg.damping,
        gamma=cfg.gamma, rotation_change_threshold=cfg.rotation_change_threshold,
        pose_change_threshold=cfg.pose_change_threshold,
        coarse_stride=cfg.coarse_stride, coarse_levels=cfg.coarse_levels)
    np.testing.assert_allclose(r["slots_after"][1], np.asarray(poses.t), rtol=0, atol=3e-4)
    np.testing.assert_allclose(r["slots_after"][0], np.asarray(poses.R), rtol=0, atol=3e-5)
    np.testing.assert_allclose(r["chi_mesh"], np.asarray(chis), rtol=2e-3)


def test_large_rotation_converges_through_rotation_stage(runs):
    gt, outs = runs
    r = outs[0]["large_rotation"]
    before = ate(r["before"], gt)
    assert before > 2.0  # the drift is severe
    assert ate(r["after"], gt) < 0.25 * before
    assert len(r["chis"]) == 10


def test_change_threshold_freezes_iteration(runs):
    _, outs = runs
    r = outs[0]["freeze"]
    assert len(r["chis"]) == r["rounds"]
    # chis[k] is the chi2 at step k's linearization point; frozen steps
    # relinearize at the poses after step 1
    np.testing.assert_allclose(r["chis"][1:], r["chis"][1], rtol=1e-5)
    assert r["chis"][1] < r["chis"][0]


def test_gamma_zero_is_identity(runs):
    _, outs = runs
    r = outs[0]["gamma_zero"]
    # the rotation stage still runs (gamma gates only the GN update), so
    # compare translations, which the chordal init leaves alone
    np.testing.assert_allclose(r["after"][:, :3, 3], r["before"][:, :3, 3], atol=1e-5)


def test_detach_restores_single_device_path(runs):
    _, outs = runs
    r = outs[0]["detach"]
    # the single-device drain returns gn_iters + 1 entries (with chi2_0)
    assert len(r["chis"]) == r["gn_iters"] + 1


def test_attach_rejects_indivisible_capacity(runs):
    _, outs = runs
    assert "not divisible" in outs[0]["indivisible"]



def test_sparse_fleet_drain_stays_finite(runs):
    """Four robots of 4-14 keyframes in 64 slots each, the coarse level at
    stride 32 (each robot's trajectory in one supernode), the weak
    default prior: the mesh drain (``optimize()``) ends without a
    breakdown, as does the single-device solve of the drained graph, each
    chi2 below half its start. Before the coarse blocks were summed by
    supernode (``solver._merge_by_node``) and a coarse level that does not
    factor became exactly zero, both went non-finite at their first PCG
    (as phase 43's fleet at four_robot_cityscale.yaml's widths did on the
    card)."""
    _, outs = runs
    r = outs[0]["sparse_fleet"]
    assert r["counts"][:4] == [4, 8, 12, 14] and r["edges"] == 34 + 6
    assert r["broken"] == 0 and r["breakdowns"] == []
    assert np.isfinite(r["chi"]).all() and np.isfinite(r["t"]).all()
    assert r["chi"][-1] < 0.5 * r["chi"][0]
    assert r["single_code"] == 0 and np.isfinite(r["single_chi"]).all()
    assert r["single_chi"][-1] < 0.5 * r["single_chi"][0]
    np.testing.assert_array_equal(outs[1]["sparse_fleet"]["t"], r["t"])   # one solve
