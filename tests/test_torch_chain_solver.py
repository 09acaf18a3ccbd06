"""The port's exact chain + loop solver (``graph/chain_solver.py``) against
the JAX package's, on tests/test_solver_scale.py's circle and on a
two-robot graph with cross loops.

Both packages take the residual's angle by arccos; JAX takes the
Jacobians by forward-mode autodiff of the f32 residual, the port by a
closed form times the map that carries arccos's rounding as forward mode
does (``graph/solver.py``'s module note). Stated tolerances, with their
reasons:
- at equal poses, the relative poses z^-1 Ti^-1 Tj within two roundings
  of JAX's (R 2.4e-7, t 2 ulp of the largest position); the residuals
  within 2e-6 where the angle is below 1.4e-3 rad (the series branch), and
  elsewhere within 2e-6 plus four ulps of cos_t through arccos,
  2^-22 / sin(theta) (1 + |t|): the two packages round the 3x3 products
  in another order, and arccos turns one ulp of cos_t (6e-8) into
  6e-8 / sin(theta) (3.7e-5 at 1.6e-3 rad; 3.1e-5 measured). The
  gradient J^T W r, in which the Jacobian's arccos tangent cancels that
  rounding, within 5e-3 plus 1e-6 of its scale of JAX's (1.3e-2 measured
  at the start, where the scale is 1.2e4; 1.3e-3 at the optimum, where
  the port's gradient is 3.9e-3 off the f64 one, JAX's 4.0e-3 and the
  exact Jacobian's 0.23). In f64, on rotations made orthonormal in f64,
  the two linearizations are one function (7e-15 measured; 1e-10 held);
- one Gauss-Newton step of the port fed JAX's linearization lands within
  2e-6 m of JAX's step (9.5e-7 measured), the first step from the
  dead-reckoned start within 1e-4 of its 2.7 m length (2.6e-4 m
  measured: the capacitance solve's f32 rounding);
- the port's algorithm run in f64 lands within 1e-5 m of JAX's f32
  optimum (1.7e-6 m measured), which holds the construction itself; the
  port's f32 run within 1e-5 m (3.8e-6 m measured on the circle, 1.4e-6 m
  on the two-robot graph) and 1e-6 in R, its late Gauss-Newton steps
  below 1e-4 m (~1e-5 measured; JAX's 4e-6 to 7e-6), and the chi2 of its
  poses evaluated in f64 within 2e-6 relative of JAX's (3.0e-7 and
  5.8e-7 measured);
- the f32 chi2 history within 5e-3 of the final value of JAX's (1.6e-3
  and 2.1e-3 measured): each package's f32 chi2 carries its arccos
  rounding, up to 3.9e-3 of the value at settled poses.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scl_slam_tpu.geometry import se3 as jse3
from scl_slam_tpu.graph import factors as JF
from scl_slam_tpu.graph import chain_solver as JC
from scl_slam_tpu.graph import solver as JS
from scl_slam_tpu_torch.geometry import se3
from scl_slam_tpu_torch.graph import chain_solver as C
from scl_slam_tpu_torch.graph import factors as F
from scl_slam_tpu_torch.graph import solver as S
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


def _f64(tree):
    """A JAX pytree with its f32 leaves in f64 (call under ``jax.enable_x64``)."""
    def cast(x):
        x = np.asarray(x)
        return jnp.asarray(x, jnp.float64) if x.dtype == np.float32 else jnp.asarray(x)
    return jax.tree_util.tree_map(cast, tree)


def _jax_chi2_f64(g, poses):
    """JAX's chi2 of ``poses`` (f32 values) evaluated in f64."""
    with jax.enable_x64(True):
        return float(JF.chi2(_f64(g), _f64(poses)))


def _port_chi2_f64(g, poses):
    """The port's chi2 of its ``poses`` (f32 values) evaluated in f64."""
    pg, _ = _port(g, jse3.Pose(np.asarray(poses.R), np.asarray(poses.t)), torch.float64)
    return float(F.chi2(pg, se3.Pose(poses.R.double(), poses.t.double())))


def _gradient(g, lin, n):
    """b = -J^T W r summed per pose, in f64, from a linearization's parts
    as [E, 6, 6] Jacobian blocks."""
    r_e, Ji, Jj, w_e, r_p, Jp, w_p = (np.asarray(x, np.float64) for x in lin)
    b = np.zeros((n, 6))
    np.add.at(b, np.asarray(g.i), -np.einsum("eab,ea->eb", Ji, w_e * r_e))
    np.add.at(b, np.asarray(g.j), -np.einsum("eab,ea->eb", Jj, w_e * r_e))
    np.add.at(b, np.asarray(g.prior_idx), -np.einsum("pab,pa->pb", Jp, w_p * r_p))
    return b


def _jax_lin(g, poses):
    """JAX's ``_linearize`` with its Jacobians as [E, 6, 6]."""
    out = list(jax.jit(JS._linearize, static_argnums=2)(g, poses, 1e9))
    for k in (1, 2, 5):
        out[k] = jnp.transpose(out[k], (2, 0, 1))
    return out


@pytest.fixture(scope="module")
def circle():
    """tests/test_solver_scale.py::test_matches_pcg_on_circle's graph."""
    n, cap = 24, 64
    gt = circle_trajectory(n)
    g = noisy_odometry_graph(gt, jax.random.PRNGKey(0), cap=cap)
    z = jse3.between(jse3.index(gt, n - 1), jse3.index(gt, 0))
    g = JF.add_between(g, n - 1, 0, z, [1.0 / 0.01] * 6)
    return g, pad_poses(integrate_odometry(g, n, jse3.index(gt, 0)), cap), n


@pytest.mark.parametrize("at", ["start", "optimum"])
def test_linearize_residuals_match_jax(circle, at):
    """``_linearize`` op by op at the dead-reckoned start (edge rotations
    ~1e-2 rad) and at JAX's optimum (~3e-3 rad), where arccos is worst
    conditioned: the relative poses, the residuals against the bound that
    arccos sets, the gradient, and the whole linearization in f64."""
    g, init, n = circle
    poses = init if at == "start" else JC.chain_solve(g, init, gn_iters=6, loop_capacity=16).poses
    m, cap = int(g.num_edges), poses.t.shape[0]
    pg, pp = _port(g, poses)

    T = jax.jit(lambda z, a, b: jse3.compose(jse3.inverse(z), jse3.between(a, b)))(
        g.z, jse3.take(poses, g.i), jse3.take(poses, g.j))
    Tp = se3.compose(se3.inverse(pg.z), se3.between(se3.take(pp, pg.i), se3.take(pp, pg.j)))
    ulp_t = 2.0 ** -23 * 2.0 ** np.ceil(np.log2(np.abs(np.asarray(poses.t)).max()))
    np.testing.assert_allclose(Tp.R.numpy()[:m], np.asarray(T.R)[:m], rtol=0, atol=2.4e-7)
    np.testing.assert_allclose(Tp.t.numpy()[:m], np.asarray(T.t)[:m], rtol=0, atol=2 * ulp_t)

    ref, got = _jax_lin(g, poses), S._linearize(pg, pp, 1e9)
    with jax.enable_x64(True):
        ref64 = _jax_lin(_f64(g), _f64(poses))
    theta = np.linalg.norm(np.asarray(ref64[0])[:m, :3], axis=1)
    arccos = theta > 1.4e-3
    bound = 2e-6 + np.where(arccos, 2.0 ** -22 / np.sin(theta), 0.0) * (
        1 + np.linalg.norm(np.asarray(T.t)[:m], axis=1))
    gap = np.abs(got[0].numpy()[:m] - np.asarray(ref[0])[:m]).max(axis=1)
    assert np.all(gap <= bound), (gap / bound).max()
    np.testing.assert_allclose(got[4].numpy()[:int(g.num_priors)], np.asarray(ref[4])[:int(g.num_priors)],
                               rtol=0, atol=2e-6)
    b64 = _gradient(g, ref64, cap)
    np.testing.assert_allclose(_gradient(g, [x.numpy() for x in got], cap), _gradient(g, ref, cap),
                               rtol=0, atol=5e-3 + 1e-6 * np.abs(b64).max())

    # in f64, on rotations made orthonormal in f64 (JAX differentiates
    # through the orthonormalization of the f32 ones, 6.7e-7 of the
    # largest entry), the two linearizations are one function
    def ortho(R):
        U, _, Vt = np.linalg.svd(np.asarray(R, np.float64))
        return U @ Vt

    with jax.enable_x64(True):
        g64 = _f64(g)
        g64 = g64._replace(z=jse3.Pose(jnp.asarray(ortho(g64.z.R)), g64.z.t))
        p64 = jse3.Pose(jnp.asarray(ortho(poses.R)), jnp.asarray(np.asarray(poses.t, np.float64)))
        ref64 = _jax_lin(g64, p64)
    got64 = S._linearize(*_port(g64, p64, torch.float64), 1e9)
    for k, rows in ((0, m), (1, m), (2, m), (4, int(g.num_priors)), (5, int(g.num_priors))):
        np.testing.assert_allclose(got64[k].numpy()[:rows], np.asarray(ref64[k])[:rows], rtol=0, atol=1e-10)


def test_step_from_jax_linearization_matches_jax(circle, monkeypatch):
    """Past ``_linearize`` the two solves are one: from each of JAX's
    iterates, the port's step fed JAX's linearization lands on JAX's
    step."""
    g, init, _ = circle
    lin = {}
    monkeypatch.setattr(C, "_linearize",
                        lambda *a: tuple(torch.from_numpy(np.array(x)) for x in lin["jax"]))
    poses = init
    for k in range(6):
        ref = JC.chain_solve(g, poses, gn_iters=1, loop_capacity=16)
        lin["jax"] = _jax_lin(g, poses)
        got = C.chain_solve(*_port(g, poses), gn_iters=1, loop_capacity=16)
        step = float(ref.delta_norms[0])
        np.testing.assert_allclose(got.poses.t.numpy(), np.asarray(ref.poses.t), rtol=0,
                                   atol=1e-4 * step if k == 0 else 2e-6)
        poses = ref.poses


def test_chain_solve_matches_jax_on_circle(circle):
    g, init, n = circle
    ref = JC.chain_solve(g, init, gn_iters=6, loop_capacity=16)
    got = C.chain_solve(*_port(g, init), gn_iters=6, loop_capacity=16)
    f64 = C.chain_solve(*_port(g, init, torch.float64), gn_iters=6, loop_capacity=16)
    assert not bool(got.loop_overflow) and not bool(ref.loop_overflow)
    rt = np.asarray(ref.poses.t)
    np.testing.assert_allclose(f64.poses.t.numpy(), rt, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.poses.t.numpy(), rt, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.poses.R.numpy(), np.asarray(ref.poses.R), rtol=0, atol=1e-6)
    assert float(got.delta_norms[3:].max()) < 1e-4
    chi = np.asarray(ref.chi2_history)
    assert got.chi2_history.shape == chi.shape == (7,) and got.delta_norms.shape == (6,)
    assert abs(float(got.chi2_history[0]) - chi[0]) <= 1e-5 * chi[0]
    np.testing.assert_allclose(got.chi2_history.numpy(), chi, rtol=0, atol=5e-3 * chi[-1])
    exact = _jax_chi2_f64(g, ref.poses)
    assert abs(_port_chi2_f64(g, got.poses) - exact) <= 2e-6 * exact
    assert chi[-1] < 1e-3 * chi[0]


@pytest.mark.parametrize("loop_capacity", [0, 1])
def test_loop_overflow_agrees(circle, loop_capacity):
    """One loop row: capacity 0 overflows (the loop left out of the solve),
    1 holds it. The chi2 after the step is that of each package's poses
    evaluated in f64 (1.3e-4 relative apart measured): the f32 value
    carries each package's arccos rounding, 1.8e-3 of it in JAX's at these
    poses."""
    g, init, _ = circle
    ref = JC.chain_solve(g, init, gn_iters=1, loop_capacity=loop_capacity)
    got = C.chain_solve(*_port(g, init), gn_iters=1, loop_capacity=loop_capacity)
    assert bool(got.loop_overflow) == bool(ref.loop_overflow) == (loop_capacity == 0)
    np.testing.assert_allclose(float(got.chi2_history[0]), float(ref.chi2_history[0]), rtol=1e-3)
    np.testing.assert_allclose(_port_chi2_f64(g, got.poses), _jax_chi2_f64(g, ref.poses), rtol=1e-3)


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
    np.testing.assert_allclose(got.poses.t.numpy()[:40], rt, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.poses.R.numpy()[:40], np.asarray(ref.poses.R)[:40], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.poses.t.numpy()[40:], 0.0)
    assert float(got.delta_norms[2:].max()) < 1e-4
    chi = np.asarray(ref.chi2_history)
    np.testing.assert_allclose(got.chi2_history.numpy(), chi, rtol=1e-4, atol=5e-3 * chi[-1])
    exact = _jax_chi2_f64(g, ref.poses)
    assert abs(_port_chi2_f64(g, got.poses) - exact) <= 2e-6 * exact
    assert chi[-1] < 0.1 * chi[0]
