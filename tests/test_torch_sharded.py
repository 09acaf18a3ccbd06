"""The port's distributed retrieval and solve (``parallel/sharded.py``)
against the JAX package's on the CPU: ``sharded_topk`` and
``sharded_solve`` run in 2 and 4 gloo ranks (spawned, FileStore
rendezvous; ``torch_rank_tasks.solve_jobs``) and in JAX on 2- and
4-device slices of the virtual CPU mesh; the port's world sizes 1, 2 and 4
are held against each other, and world 1 against the single-device solve
that shares its steps.

Tolerances: ``sharded_topk`` equal to JAX's in positions, its d2 within
2 ulp (XLA and torch sum a row's 20 squares in other orders: measured 1
ulp); the port's world sizes give the same positions and d2 bit for bit. ``sharded_solve`` as
``test_torch_solver.py::test_solve_matches_jax`` holds the single-device
solve: chi2 history 2e-3 relative, translations 3e-4 m, rotations 3e-5.
Between the port's world sizes (the sums split over ranks, so f32
rounding apart): translations 1e-4 m, rotations 3e-5, chi2 1e-3 relative
(measured at most 4.0e-5 m, 9.0e-6 and 3.8e-4, the chi2 at its floor).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from scl_slam_tpu.geometry import se3 as jse3
from scl_slam_tpu.parallel import sharded as jsharded
from scl_slam_tpu_torch.parallel import multihost
from test_torch_kernels import release_jax_programs  # noqa: F401 (autouse)
from test_torch_solver import _graph_arrays, _jax_graph
import torch_rank_tasks

SOLVES = [dict(gn_iters=6, cg_iters=48, coarse_stride=0),
          dict(gn_iters=6, cg_iters=48, coarse_stride=8),
          dict(gn_iters=6, cg_iters=48, coarse_stride=8, gamma=0.7,
               rotation_change_threshold=1e-3, pose_change_threshold=1e-2)]


def _topk_inputs():
    rng = np.random.RandomState(0)
    n, d = 512, 20
    db = rng.normal(size=(n, d)).astype(np.float32)
    db[300] = db[17]          # exact ties across shards go to the lower row
    db[450] = db[17]
    q = db[17] + rng.normal(scale=1e-3, size=d).astype(np.float32)
    mask = np.arange(n) < 480
    qb = np.stack([q, rng.normal(size=d).astype(np.float32)])   # a batch of two
    return db, qb, np.stack([mask, np.arange(n) % 3 != 0]), 8


@pytest.fixture(scope="module")
def port_results(tmp_path_factory):
    db, q, mask, k = _topk_inputs()
    a, R0, t0 = _graph_arrays()
    jobs = [("topk", db, q, mask, k)] + [("solve", a, R0, t0, kw) for kw in SOLVES]
    return {w: multihost.spawn(torch_rank_tasks.solve_jobs, w, (jobs,), device="cpu",
                               threads=1, workdir=str(tmp_path_factory.mktemp("ranks")))
            for w in (1, 2, 4)}


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("shard",))


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_topk_matches_jax(port_results, world):
    db, q, mask, k = _topk_inputs()
    for b in range(2):
        d2, pos = jsharded.sharded_topk(_mesh(world), "shard", jnp.asarray(db),
                                        jnp.asarray(q[b]), jnp.asarray(mask[b]), k)
        for rank_out in port_results[world]:
            got_d2, got_pos = rank_out[0]
            np.testing.assert_array_equal(got_pos[b], np.asarray(pos))
            np.testing.assert_allclose(got_d2[b], np.asarray(d2), rtol=4e-7, atol=0)
    # the tie: rows 17, 300 and 450 hold one key, and the lowest comes first
    got_d2, got_pos = port_results[world][0][0]
    assert list(got_pos[0, :3]) == [17, 300, 450]
    # every world size gives the one-rank answer, bit for bit
    np.testing.assert_array_equal(got_pos, port_results[1][0][0][1])
    np.testing.assert_array_equal(got_d2, port_results[1][0][0][0])


@pytest.mark.parametrize("world, case", [(2, 0), (2, 2), (4, 1)])
def test_sharded_solve_matches_jax(port_results, world, case):
    a, R0, t0 = _graph_arrays()
    kw = SOLVES[case]
    poses, chis = jsharded.sharded_solve(
        _mesh(world), "shard", _jax_graph(a), jse3.Pose(jnp.asarray(R0), jnp.asarray(t0)), **kw)
    R, t, c, n_reduce = port_results[world][0][1 + case]
    np.testing.assert_allclose(c, np.asarray(chis), rtol=2e-3)
    np.testing.assert_allclose(t, np.asarray(poses.t), rtol=0, atol=3e-4)
    np.testing.assert_allclose(R, np.asarray(poses.R), rtol=0, atol=3e-5)
    assert c[-1] < 1e-2 * c[0]
    # one all-reduce each for H_diag, b, chi2 and every J^T W J x (the
    # start's, cg_iters, and the coarse correction's), and the coarse matrix
    coarse = 1 if kw["coarse_stride"] else 0
    per_step = 3 + kw["cg_iters"] + 3 * coarse
    assert n_reduce == kw["gn_iters"] * per_step
    for rank_out in port_results[world][1:]:   # every rank holds the same
        for x, y in zip(rank_out[1 + case][:3], (R, t, c)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("case", range(len(SOLVES)))
def test_sharded_solve_world_sizes_agree(port_results, case):
    R1, t1, c1, _ = port_results[1][0][1 + case]
    for w in (2, 4):
        R, t, c, _ = port_results[w][0][1 + case]
        np.testing.assert_allclose(t, t1, rtol=0, atol=1e-4)
        np.testing.assert_allclose(R, R1, rtol=0, atol=3e-5)
        np.testing.assert_allclose(c, c1, rtol=1e-3)


def test_sharded_solve_world_one_is_the_single_device_solve(port_results):
    """Without a coarse level, over-relaxation or freeze, one rank takes
    the steps of ``graph/solver.solve`` (whose history also holds the final
    chi2): the same poses to 1e-6."""
    import torch

    from scl_slam_tpu_torch.geometry import se3
    from scl_slam_tpu_torch.graph import solver

    a, R0, t0 = _graph_arrays()
    ref = solver.solve(torch_rank_tasks.port_graph(a),
                       se3.Pose(torch.from_numpy(R0), torch.from_numpy(t0)), **SOLVES[0])
    R, t, c, _ = port_results[1][0][1]
    np.testing.assert_allclose(t, ref.poses.t.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(R, ref.poses.R.numpy(), rtol=0, atol=1e-6)
    # chi2 from the linearization's residuals against factors.chi2's own
    # evaluation (measured 1.1e-4 relative at 55.75)
    np.testing.assert_allclose(c, ref.chi2_history.numpy()[:-1], rtol=5e-4)
