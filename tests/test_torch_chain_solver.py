"""The port's exact chain + loop solver (``graph/chain_solver.py``) against
the JAX package's, on tests/test_solver_scale.py's circle and on a
two-robot graph with cross loops.

Stated tolerances, with their reasons: the port's algorithm run in f64
lands within 1e-5 m of JAX's f32 optimum (1.7e-6 m measured on the
circle), which holds the construction itself; the port's f32 run within
1e-3 m (4.2e-4 m measured) and its chi2 history within 5e-3 of the final
chi2 (3.9e-3 measured): the first Newton step of either f32 run is ~7e-4
m from the f64 step, and after it the port's f32 Gauss-Newton keeps
stepping ~1e-3 at the optimum where JAX's settles to ~5e-6. The port's
f32 edge residuals (``solver._linearize``, shared with ``solver.solve``,
which does the same) are the cause: with them in f64 the f32 solve lands
within 5e-7 m of the f64 one (ROADMAP queue 3).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scl_slam_tpu.geometry import se3 as jse3
from scl_slam_tpu.graph import factors as JF
from scl_slam_tpu.graph import chain_solver as JC
from scl_slam_tpu_torch.geometry import se3
from scl_slam_tpu_torch.graph import chain_solver as C
from scl_slam_tpu_torch.graph import factors as F
from test_graph import circle_trajectory, integrate_odometry, noisy_odometry_graph, pad_poses
from test_torch_kernels import release_jax_programs  # noqa: F401 (autouse)

torch.set_num_threads(2)


def _port(g, poses, dtype=torch.float32):
    """A JAX graph and poses as the port's tensors."""
    def t(x):
        x = torch.from_numpy(np.array(x))
        return x.to(dtype) if x.is_floating_point() else x

    def p(q):
        return se3.Pose(t(q.R), t(q.t))

    return F.FactorGraph(t(g.i), t(g.j), p(g.z), t(g.sqrt_info), t(g.num_edges), t(g.prior_idx),
                         p(g.prior_z), t(g.prior_sqrt_info), t(g.num_priors)), p(poses)


@pytest.fixture(scope="module")
def circle():
    """tests/test_solver_scale.py::test_matches_pcg_on_circle's graph."""
    n, cap = 24, 64
    gt = circle_trajectory(n)
    g = noisy_odometry_graph(gt, jax.random.PRNGKey(0), cap=cap)
    z = jse3.between(jse3.index(gt, n - 1), jse3.index(gt, 0))
    g = JF.add_between(g, n - 1, 0, z, [1.0 / 0.01] * 6)
    return g, pad_poses(integrate_odometry(g, n, jse3.index(gt, 0)), cap), n


def test_chain_solve_matches_jax_on_circle(circle):
    g, init, n = circle
    ref = JC.chain_solve(g, init, gn_iters=6, loop_capacity=16)
    got = C.chain_solve(*_port(g, init), gn_iters=6, loop_capacity=16)
    f64 = C.chain_solve(*_port(g, init, torch.float64), gn_iters=6, loop_capacity=16)
    assert not bool(got.loop_overflow) and not bool(ref.loop_overflow)
    rt = np.asarray(ref.poses.t)
    np.testing.assert_allclose(f64.poses.t.numpy(), rt, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.poses.t.numpy(), rt, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.poses.R.numpy(), np.asarray(ref.poses.R), rtol=0, atol=2e-4)
    chi = np.asarray(ref.chi2_history)
    assert got.chi2_history.shape == chi.shape == (7,) and got.delta_norms.shape == (6,)
    assert abs(float(got.chi2_history[0]) - chi[0]) <= 1e-5 * chi[0]
    np.testing.assert_allclose(got.chi2_history.numpy(), chi, rtol=0, atol=5e-3 * chi[-1])
    assert chi[-1] < 1e-3 * chi[0]


@pytest.mark.parametrize("loop_capacity", [0, 1])
def test_loop_overflow_agrees(circle, loop_capacity):
    """One loop row: capacity 0 overflows (the loop left out of the solve),
    1 holds it."""
    g, init, _ = circle
    ref = JC.chain_solve(g, init, gn_iters=1, loop_capacity=loop_capacity)
    got = C.chain_solve(*_port(g, init), gn_iters=1, loop_capacity=loop_capacity)
    assert bool(got.loop_overflow) == bool(ref.loop_overflow) == (loop_capacity == 0)
    np.testing.assert_allclose(got.chi2_history.numpy(), np.asarray(ref.chi2_history),
                               rtol=1e-3)


def _two_robot_graph():
    """Two robot blocks of 20 poses, a prior at each block's start, three
    cross loops and 8 factor-less slots after the blocks. (Factor-less
    slots BEFORE a block that a loop reaches break the f32 solve in both
    packages: their 1e-3 gauge floor puts ~4e3 into the prefix sums of
    D^-1 that the loop intervals difference; ROADMAP queue 3.)"""
    rng = np.random.RandomState(4)
    K, n = 20, 20
    g = JF.make_graph(96)
    gt = {}
    for r in range(2):
        for k in range(n):
            a = 0.15 * k + r
            gt[r * K + k] = jse3.Pose(
                jnp.asarray(np.float32([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])),
                jnp.asarray(np.float32([8 * np.cos(a), 8 * np.sin(a), 0.1 * r])))
        g = JF.add_prior(g, r * K, gt[r * K], [1e3] * 6)
        for k in range(n - 1):
            z = jse3.compose(jse3.between(gt[r * K + k], gt[r * K + k + 1]),
                             jse3.exp(jnp.asarray(rng.normal(0, [0.005] * 3 + [0.03] * 3), jnp.float32)))
            g = JF.add_between(g, r * K + k, r * K + k + 1, z, [100.0] * 3 + [30.0] * 3)
    for a, b in ((3, K + 2), (10, K + 12), (18, K + 17)):
        g = JF.add_between(g, a, b, jse3.between(gt[a], gt[b]), [50.0] * 6)
    R = np.tile(np.eye(3, dtype=np.float32), (48, 1, 1))
    t = np.zeros((48, 3), np.float32)
    for r in range(2):
        X = gt[r * K]
        R[r * K], t[r * K] = np.asarray(X.R), np.asarray(X.t)
        for k in range(1, n):
            i = r * K + k
            X = jse3.compose(X, jse3.index(g.z, r * (n - 1) + k - 1))
            R[i], t[i] = np.asarray(X.R), np.asarray(X.t)
    return g, jse3.Pose(jnp.asarray(R), jnp.asarray(t))


def test_segments_and_cross_loops_match_jax():
    g, init = _two_robot_graph()
    pg, pinit = _port(g, init)
    ce, ss = C._segment_structure(pg, 48)
    jce, jss = JC._segment_structure(g, 48)
    np.testing.assert_array_equal(ce.numpy(), np.asarray(jce))
    np.testing.assert_array_equal(ss.numpy(), np.asarray(jss))
    assert sorted(set(ss.numpy().tolist())) == [0, 20] + list(range(40, 48))
    ref = JC.chain_solve(g, init, gn_iters=4, loop_capacity=8)
    got = C.chain_solve(pg, pinit, gn_iters=4, loop_capacity=8)
    f64 = C.chain_solve(*_port(g, init, torch.float64), gn_iters=4, loop_capacity=8)
    assert not bool(got.loop_overflow) and not bool(ref.loop_overflow)
    # the slots with factors; JAX moves the factor-less ones by up to 0.2 m
    # (its f32 cumsum of U^T lambda leaves a residue past the intervals,
    # times their D^-1 of 1e3), the port's stay where they were
    rt = np.asarray(ref.poses.t)[:40]
    np.testing.assert_allclose(f64.poses.t.numpy()[:40], rt, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.poses.t.numpy()[:40], rt, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(got.poses.t.numpy()[40:], 0.0)
    chi = np.asarray(ref.chi2_history)
    np.testing.assert_allclose(got.chi2_history.numpy(), chi, rtol=1e-4, atol=5e-3 * chi[-1])
    assert chi[-1] < 0.1 * chi[0]
