"""Keyframe eviction and block compaction of the PyTorch port
(``scl_slam_tpu_torch/runtime/eviction.py`` and the ``Mapper`` hooks)
against the JAX package.

``plan_keep`` and ``compact_robot`` run on a state handed over from JAX
(``state_from_numpy``) and must give the JAX package's keep mask, evicted
records and compacted arrays: integer and bool arrays equal, float arrays
equal too (eviction only moves rows and recomposes the odometry chain in
float64 numpy on both sides). A session driven past capacity must match
the JAX session keyframe for keyframe (poses within 1e-5 m: the two
packages compose poses in another order) and keep the invariants of
``tests/test_eviction.py``. The checkpoint round trip with the archive is
held in ``tests/test_torch_checkpoint.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import scl_slam_tpu.config as jconfig
from scl_slam_tpu.geometry import se3 as jse3
from scl_slam_tpu.runtime import eviction as jev
from scl_slam_tpu.runtime import mapper as JM
from scl_slam_tpu_torch import config as tconfig
from scl_slam_tpu_torch.geometry import se3
from scl_slam_tpu_torch.runtime import eviction as ev
from scl_slam_tpu_torch.runtime import mapper as M
from scl_slam_tpu_torch.runtime.state import state_from_numpy, state_to_numpy
from test_torch_kernels import release_jax_programs  # noqa: F401 (autouse)

torch.set_num_threads(2)


def small_cfg(mod, n_robots=1):
    """tests/test_eviction.py's configuration."""
    return mod.SlamConfig(
        number_of_robots=n_robots,
        keyframe=mod.KeyframeConfig(
            max_keyframes=24, points_per_keyframe=256, raw_points_capacity=512,
            evict_keep_recent=4, evict_stride=2, distance_threshold=0.5,
        ),
        loop=mod.LoopConfig(
            near_keyframes=2, submap_capacity=512, queue_capacity=8,
            intra_enabled=False, inter_enabled=False,
        ),
        optimizer=mod.OptimizerConfig(edge_capacity=96, gn_iters=2, cg_iters=8),
        scan_context=mod.ScanContextParams(exclude_recent=2),
    )


def _pose(mod, k):
    if mod is JM:
        return jse3.Pose(jnp.eye(3), jnp.array([2.0 * k, 0.0, 0.0]))
    return se3.Pose(torch.eye(3), torch.tensor([2.0 * k, 0.0, 0.0]))


def drive(mod, mapper, n, start=0):
    rng = np.random.RandomState(7)
    for k in range(start, start + n):
        xyz = rng.uniform(-20, 20, (256, 3)).astype(np.float32)
        assert mapper.add_frame(_pose(mod, k), xyz, stamp=float(k)) is not None
    return mapper


@pytest.fixture(scope="module")
def built():
    """A 20-keyframe JAX session with a drained loop 2 -> 10 (the state
    ``tests/test_eviction.py::TestCompaction.build`` makes)."""
    cfg = small_cfg(jconfig)
    m = drive(JM, JM.Mapper(cfg), 20)
    z = jse3.between(
        jse3.Pose(m.state.opt_R[2], m.state.opt_t[2]),
        jse3.Pose(m.state.opt_R[10], m.state.opt_t[10]),
    )
    m.state = JM._queue_loop(
        m.state, jnp.array(JM.encode_kf(0, 2)), jnp.array(JM.encode_kf(0, 10)),
        z, jnp.array(0.05, jnp.float32), cfg,
    )
    m.state, _ = JM._drain_queue_and_optimize(m.state, cfg)
    return m.state


@pytest.fixture(scope="module")
def sessions():
    """60 keyframes through both packages' Mappers (two compactions)."""
    jm = drive(JM, JM.Mapper(small_cfg(jconfig)), 60)
    tm = drive(M, M.Mapper(small_cfg(tconfig), "cpu"), 60)
    return jm, tm


def test_plan_keep_matches_jax(built):
    cfg = small_cfg(tconfig)
    tst = state_from_numpy(state_to_numpy(built), "cpu")
    keep = ev.plan_keep(tst, cfg, 0)
    np.testing.assert_array_equal(keep, jev.plan_keep(built, small_cfg(jconfig), 0))
    n = int(tst.counts[0])
    assert keep[0] and keep[2] and keep[10]
    assert keep[n - cfg.keyframe.evict_keep_recent :].all()
    assert not keep.all(), "middle non-anchor frames must be decimated"


def test_compact_robot_matches_jax_array_for_array(built):
    tst = state_from_numpy(state_to_numpy(built), "cpu")
    new, evicted = ev.compact_robot(tst, small_cfg(tconfig), 0)
    jnew, jevicted = jev.compact_robot(built, small_cfg(jconfig), 0)
    assert [(r["index"], r["stamp"]) for r in evicted] == [(r["index"], r["stamp"]) for r in jevicted]
    np.testing.assert_array_equal(
        np.stack([r["pose"] for r in evicted]), np.stack([r["pose"] for r in jevicted])
    )
    got, ref = state_to_numpy(new), state_to_numpy(jnew)
    assert got.keys() == ref.keys()
    for k in got:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert all(x.device.type == "cpu" for x in (new.kf_xyz, new.graph.i, new.desc_db.count))


def test_loop_anchors_survive_and_chain_recomposed_exactly(built):
    cfg = small_cfg(tconfig)
    tst = state_from_numpy(state_to_numpy(built), "cpu")
    state, evicted = ev.compact_robot(tst, cfg, 0)
    assert len(evicted) > 0
    g = state.graph
    ne = int(g.num_edges)
    idx = state.desc_db.index.numpy()
    loops = [e for e in range(ne) if int(g.j[e]) != int(g.i[e]) + 1]
    assert len(loops) == 1
    e = loops[0]
    assert (idx[int(g.i[e])], idx[int(g.j[e])]) == (2, 10)
    np.testing.assert_allclose(g.z.t[e].numpy(), [16.0, 0.0, 0.0], atol=1e-4)
    # the odometry chain across each gap: z spans it, sqrt_info / sqrt(gap)
    for e in range(ne):
        if e == loops[0]:
            continue
        i, j = int(g.i[e]), int(g.j[e])
        gap = idx[j] - idx[i]
        np.testing.assert_allclose(g.z.t[e].numpy(), [2.0 * gap, 0.0, 0.0], atol=1e-4)
        np.testing.assert_allclose(
            float(g.sqrt_info[e, 3]),
            (1.0 / cfg.optimizer.odometry_sigmas[3]) / np.sqrt(gap), rtol=1e-5,
        )


def test_session_continues_past_capacity_as_in_jax(sessions):
    jm, m = sessions
    K = m.cfg.keyframe.max_keyframes
    n = int(m.state.counts[0])
    assert n <= K and len(m._evicted.get(0, [])) == 60 - n
    assert m._keyframes == 60 and m.next_index(0) == 60
    idx = m.state.desc_db.index[:n].numpy()
    assert idx[-1] == 59 and (np.diff(idx) > 0).all()
    assert (m.state.desc_db.index[n:K].numpy() == -1).all()
    # the JAX session evicted the same keyframes at the same points
    np.testing.assert_array_equal(m.state.counts.numpy(), np.asarray(jm.state.counts))
    np.testing.assert_array_equal(idx, np.asarray(jm.state.desc_db.index[:n]))
    np.testing.assert_array_equal(m.state.graph.i.numpy(), np.asarray(jm.state.graph.i))
    np.testing.assert_array_equal(m.state.graph.j.numpy(), np.asarray(jm.state.graph.j))
    np.testing.assert_allclose(m.state.opt_t.numpy(), np.asarray(jm.state.opt_t), atol=1e-5)
    # full_trajectory: every keyframe ever, in index order, as in JAX
    poses, stamps = m.full_trajectory(0)
    jposes, jstamps = jm.full_trajectory(0)
    assert len(poses) == 60
    np.testing.assert_allclose(stamps, np.arange(60.0))
    np.testing.assert_array_equal(stamps, jstamps)
    np.testing.assert_allclose(poses, jposes, atol=1e-5)
    np.testing.assert_allclose(poses[:, 0, 3], 2.0 * np.arange(60.0), atol=1e-3)
    # noise-free odometry: the recomposed chain is satisfied by the current
    # estimates, so the solve is a no-op
    chi = m.optimize()
    assert float(chi[-1]) < 1e-3


def test_neighbor_block_untouched():
    cfg = small_cfg(tconfig, n_robots=2)
    m = M.Mapper(cfg, "cpu")
    rng = np.random.RandomState(3)
    for i in range(3):
        p = se3.Pose(torch.eye(3), torch.tensor([0.0, 5.0 + i, 0.0]))
        pre = se3.Pose(torch.eye(3), torch.tensor([0.0, 5.0 + max(i - 1, 0), 0.0]))
        assert m.ingest_peer_descriptor(1, i, pre, p, rng.rand(1200).astype(np.float32), stamp=float(i))
    before = m.state.odom_t[cfg.keyframe.max_keyframes :].clone()
    drive(M, m, 60)  # overflows robot 0's block twice
    assert torch.equal(before, m.state.odom_t[cfg.keyframe.max_keyframes :])
    assert m.next_index(1) == 3 and len(m._evicted[0]) > 0 and 1 not in m._evicted


def test_peer_block_and_impossible_batch():
    """A full peer block compacts before the next peer descriptor; a batch
    larger than a block raises."""
    cfg = small_cfg(tconfig, n_robots=2)
    m = M.Mapper(cfg, "cpu")
    rng = np.random.RandomState(4)
    K = cfg.keyframe.max_keyframes
    for i in range(K + 3):
        p = se3.Pose(torch.eye(3), torch.tensor([0.0, 1.0 * i, 0.0]))
        pre = se3.Pose(torch.eye(3), torch.tensor([0.0, 1.0 * max(i - 1, 0), 0.0]))
        assert m.ingest_peer_descriptor(1, i, pre, p, rng.rand(1200).astype(np.float32), stamp=float(i))
    assert int(m.state.counts[1]) <= K and m.next_index(1) == K + 3
    poses, stamps = m.full_trajectory(1)
    np.testing.assert_array_equal(stamps, np.arange(K + 3.0))
    with pytest.raises(ValueError):
        m._ensure_capacity(K + 1)
