"""Factor graph, pose-graph solver and chordal rotation init of the PyTorch
port against the JAX package, on a 56-pose graph (a 1.3-lap circle with
noisy odometry and 12 loop factors) in 64 pose slots (the empty ones are
held by damping), made from a numpy seed.

Tolerances, with their reasons:
- residuals 1e-5 and chi2 relative 1e-5: f32 log/exp of the two libraries
  a few ulps apart;
- Jacobian blocks 2e-5 relative to the largest entry: the port writes the
  SE(3) right Jacobian inverse and an adjoint in closed form where JAX
  differentiates the residual with ``jacfwd``;
- solved poses 2e-3 m / 2e-4, chi2 history relative 2e-3: CG stops after a
  fixed 48 iterations short of convergence and amplifies those ulps (and
  on the card ``index_add_`` sums in a varying order, the same size).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scl_slam_tpu.geometry import se3 as jse3
from scl_slam_tpu.graph import factors as JF
from scl_slam_tpu.graph import rotation_init as JRI
from scl_slam_tpu.graph import solver as JS
from scl_slam_tpu_torch.geometry import se3
from scl_slam_tpu_torch.graph import factors as F
from scl_slam_tpu_torch.graph import rotation_init as RI
from scl_slam_tpu_torch.graph import solver as S
from test_torch_kernels import release_jax_programs  # noqa: F401 (autouse)

torch.set_num_threads(2)

N_POSES, N_SLOTS, EDGE_CAP, PRIOR_CAP = 56, 64, 128, 8


def _rot(w):
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        return np.eye(3)
    return np.eye(3) + np.sin(th) / th * K + (1 - np.cos(th)) / th**2 * K @ K


def _graph_arrays(seed=0):
    """Factor arrays, dead-reckoned initial poses and ground truth."""
    rng = np.random.RandomState(seed)
    gt = []
    for k in range(N_POSES):
        a = 2 * np.pi * 1.3 * k / N_POSES
        T = np.eye(4)
        T[:3, :3] = _rot([0, 0, a + np.pi / 2])
        T[:3, 3] = [12 * np.cos(a), 12 * np.sin(a), 0.3 * np.sin(a)]
        gt.append(T)
    ii, jj, zz, si = [], [], [], []
    for k in range(N_POSES - 1):
        noise = np.eye(4)
        noise[:3, :3] = _rot(rng.normal(0, 0.01, 3))
        noise[:3, 3] = rng.normal(0, 0.05, 3)
        ii.append(k), jj.append(k + 1), zz.append(np.linalg.inv(gt[k]) @ gt[k + 1] @ noise)
        si.append([100.0] * 3 + [20.0] * 3)
    for k in range(N_POSES - 44):  # pose 44 + k revisits pose k
        ii.append(k), jj.append(44 + k), zz.append(np.linalg.inv(gt[k]) @ gt[44 + k])
        si.append([30.0] * 6)
    m = len(ii)
    a = {
        "i": np.zeros(EDGE_CAP, np.int32), "j": np.zeros(EDGE_CAP, np.int32),
        "z.R": np.tile(np.eye(3, dtype=np.float32), (EDGE_CAP, 1, 1)),
        "z.t": np.zeros((EDGE_CAP, 3), np.float32),
        "sqrt_info": np.zeros((EDGE_CAP, 6), np.float32), "num_edges": np.int32(m),
        "prior_idx": np.zeros(PRIOR_CAP, np.int32),
        "prior_z.R": np.tile(np.eye(3, dtype=np.float32), (PRIOR_CAP, 1, 1)),
        "prior_z.t": np.zeros((PRIOR_CAP, 3), np.float32),
        "prior_sqrt_info": np.zeros((PRIOR_CAP, 6), np.float32), "num_priors": np.int32(1),
    }
    a["i"][:m], a["j"][:m] = ii, jj
    a["z.R"][:m] = np.array(zz)[:, :3, :3]
    a["z.t"][:m] = np.array(zz)[:, :3, 3]
    a["sqrt_info"][:m] = si
    a["prior_z.R"][0], a["prior_z.t"][0] = gt[0][:3, :3], gt[0][:3, 3]
    a["prior_sqrt_info"][0] = 1000.0
    X = [gt[0]]
    for k in range(N_POSES - 1):
        X.append(X[-1] @ zz[k])
    R0 = np.tile(np.eye(3, dtype=np.float32), (N_SLOTS, 1, 1))
    t0 = np.zeros((N_SLOTS, 3), np.float32)
    R0[:N_POSES], t0[:N_POSES] = np.array(X)[:, :3, :3], np.array(X)[:, :3, 3]
    return a, R0, t0


def _jax_graph(a):
    j = {k: jnp.asarray(v) for k, v in a.items()}
    return JF.FactorGraph(
        j["i"], j["j"], jse3.Pose(j["z.R"], j["z.t"]), j["sqrt_info"], j["num_edges"],
        j["prior_idx"], jse3.Pose(j["prior_z.R"], j["prior_z.t"]), j["prior_sqrt_info"],
        j["num_priors"],
    )


def _port_graph(a):
    t = {k: torch.from_numpy(np.array(v)) for k, v in a.items()}
    return F.FactorGraph(
        t["i"], t["j"], se3.Pose(t["z.R"], t["z.t"]), t["sqrt_info"], t["num_edges"],
        t["prior_idx"], se3.Pose(t["prior_z.R"], t["prior_z.t"]), t["prior_sqrt_info"],
        t["num_priors"],
    )


@pytest.fixture(scope="module")
def problem():
    a, R0, t0 = _graph_arrays()
    return (_jax_graph(a), jse3.Pose(jnp.asarray(R0), jnp.asarray(t0)),
            _port_graph(a), se3.Pose(torch.from_numpy(R0), torch.from_numpy(t0)))


def test_factors_match_jax(problem):
    G, jp, g, tp = problem
    m = int(g.num_edges)
    np.testing.assert_allclose(
        F.between_residuals(g, tp).numpy()[:m],
        np.asarray(jax.jit(JF.between_residuals)(G, jp))[:m], rtol=0, atol=1e-5,
    )
    np.testing.assert_allclose(
        F.prior_residuals(g, tp).numpy()[:1],
        np.asarray(jax.jit(JF.prior_residuals)(G, jp))[:1], rtol=0, atol=1e-5,
    )
    np.testing.assert_allclose(float(F.chi2(g, tp)), float(jax.jit(JF.chi2)(G, jp)), rtol=1e-5)
    np.testing.assert_array_equal(g.edge_mask().numpy(), np.asarray(G.edge_mask()))
    np.testing.assert_array_equal(g.prior_mask().numpy(), np.asarray(G.prior_mask()))


def test_add_between_block_equals_sequential_masked_appends():
    """The vectorized append (the drain's) gives the rows of JAX's
    sequential masked ``add_between``s, overflow past the capacity
    dropped; ``add_between`` alone appends one row."""
    rng = np.random.RandomState(4)
    cap, B = 12, 10
    i = rng.randint(0, 30, B).astype(np.int32)
    j = rng.randint(0, 30, B).astype(np.int32)
    R = np.stack([_rot(w) for w in rng.normal(0, 0.3, (B, 3))]).astype(np.float32)
    t = rng.normal(0, 3, (B, 3)).astype(np.float32)
    si = rng.uniform(1, 9, (B, 6)).astype(np.float32)
    valid = rng.rand(B) > 0.3
    G = JF.add_between(JF.make_graph(cap), 1, 2, jse3.identity(), [1.0] * 6)
    g = F.add_between(F.make_graph(cap), 1, 2, se3.identity(), [1.0] * 6)
    for rep in range(2):  # the second round overflows the capacity
        for k in range(B):
            if valid[k]:
                G = JF.add_between(G, i[k], j[k], jse3.Pose(jnp.asarray(R[k]), jnp.asarray(t[k])), si[k])
        g = F.add_between_block(
            g, torch.from_numpy(i), torch.from_numpy(j),
            se3.Pose(torch.from_numpy(R), torch.from_numpy(t)), torch.from_numpy(si),
            valid=torch.from_numpy(valid),
        )
    assert int(g.num_edges) == int(G.num_edges) == cap
    for got, ref in ((g.i, G.i), (g.j, G.j), (g.z.R, G.z.R), (g.z.t, G.z.t), (g.sqrt_info, G.sqrt_info)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("start", ["dead_reckoning", "far"])
def test_linearize_matches_jax(problem, start):
    """Residuals, the closed-form Jacobian blocks and the weights against
    JAX's ``jacfwd`` at the dead-reckoned start and at random poses whose
    residual rotations pass 1.5 rad (the closed-form branch of the
    coefficients begins at 1 rad)."""
    G, jp, g, tp = problem
    if start == "far":
        rng = np.random.RandomState(11)
        w = rng.normal(0, 1, (N_SLOTS, 3))
        w *= (rng.uniform(0, 1.25, N_SLOTS) / np.linalg.norm(w, axis=1))[:, None]
        R = np.stack([_rot(x) for x in w]).astype(np.float32)
        t = rng.uniform(-20, 20, (N_SLOTS, 3)).astype(np.float32)
        jp = jse3.Pose(jnp.asarray(R), jnp.asarray(t))
        tp = se3.Pose(torch.from_numpy(R), torch.from_numpy(t))
    got = S._linearize(g, tp, 1e9)
    ref = jax.jit(JS._linearize, static_argnums=2)(G, jp, 1e9)
    m = int(g.num_edges)
    r_e = got[0].numpy()[:m]
    np.testing.assert_allclose(r_e, np.asarray(ref[0])[:m], rtol=0, atol=1e-4)
    if start == "far":
        assert np.linalg.norm(r_e[:, :3], axis=1).max() > 1.5
    for k in (1, 2, 5):  # Ji, Jj, Jp; JAX keeps them as [6, 6, E]
        J = got[k].numpy()
        J_ref = np.transpose(np.asarray(ref[k]), (2, 0, 1))
        n = m if k < 5 else 1
        np.testing.assert_allclose(J[:n], J_ref[:n], rtol=0, atol=2e-5 * np.abs(J_ref[:n]).max())
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), rtol=1e-6)
    np.testing.assert_allclose(got[6].numpy(), np.asarray(ref[6]), rtol=1e-6)


@pytest.mark.parametrize("coarse_stride", [0, 8])
def test_solve_matches_jax(problem, coarse_stride):
    """GN/PCG without and with the dense coarse level (8 poses a
    supernode); both end near the ground-truth chi2 floor."""
    G, jp, g, tp = problem
    kw = dict(gn_iters=6, cg_iters=48, coarse_stride=coarse_stride)
    got = S.solve(g, tp, **kw)
    ref = JS.solve(G, jp, **kw)
    np.testing.assert_allclose(got.chi2_history.numpy(), np.asarray(ref.chi2_history), rtol=2e-3)
    np.testing.assert_allclose(got.poses.t.numpy(), np.asarray(ref.poses.t), rtol=0, atol=2e-3)
    np.testing.assert_allclose(got.poses.R.numpy(), np.asarray(ref.poses.R), rtol=0, atol=2e-4)
    assert float(got.chi2_history[-1]) < 1e-2 * float(got.chi2_history[0])
    assert got.cg_residuals.shape == got.delta_norms.shape == (6,)
    if coarse_stride == 0:  # the empty slots stay where they were
        np.testing.assert_array_equal(got.poses.t.numpy()[N_POSES:], tp.t.numpy()[N_POSES:])


def test_chordal_rotation_init_and_two_stage_match_jax(problem):
    G, jp, g, tp = problem
    got = RI.chordal_rotation_init(g, tp)
    ref = JRI.chordal_rotation_init(G, jp)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), rtol=0, atol=2e-5)
    assert torch.equal(got.t, tp.t)
    two = RI.solve_two_stage(g, tp, gn_iters=3, cg_iters=32)
    assert np.isfinite(two.chi2_history.numpy()).all()
    assert float(two.chi2_history[-1]) < float(S.solve(g, tp, gn_iters=0).chi2_history[0])


def test_auto_coarse_matches_jax():
    for n in (64, 2048, 2049, 4096, 4097, 70000, 1 << 20):
        assert S.auto_coarse(n) == JS.auto_coarse(n)
    assert S.huber_weight(torch.tensor([0.25, 16.0]), 2.0).tolist() == [1.0, 0.5]
