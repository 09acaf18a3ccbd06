"""The whole replay slice: ``Mapper.replay`` of the PyTorch port against
the JAX ``Mapper.replay`` on a revisiting synthetic trajectory, so that
descriptor hits, batched ICP and the loop queue all fire.

Held equal: the keyframe gate, every loop decision and matched index, the
loop-queue endpoints, the DB bookkeeping and the factor-graph rows.
Tolerances, with their reasons: loop factors' z_t 5e-3 m (as
tests/test_batch_step.py holds the batch path to the sequential one: ICP
stops at tol=1e-4 per update, and on the CPU the JAX NN ranks by the
expanded-form distance, the port by the exact one — see
test_torch_registration.py); ICP fitness 2e-2 relative (the same, summed
over a few hundred correspondences); chained poses 1e-4 m and descriptor
keys 1e-5 (f32 sums in another order; a sector-boundary atan2 ulp).
The replay's two input modes (``transfer="int16"``, ``host_descriptors``)
are held to the same bounds, each package's host binning its own C++
library (JAX's built by its Makefile into a private directory).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import scl_slam_tpu.config as jconfig
from scl_slam_tpu.geometry import se3 as jse3
from scl_slam_tpu.io import kitti
from scl_slam_tpu.runtime.mapper import Mapper as JMapper
from scl_slam_tpu_torch import config as tconfig
from scl_slam_tpu_torch.descriptors import scan_context as tsc
from scl_slam_tpu_torch.geometry import se3
from scl_slam_tpu_torch.io import trajectory as tio
from scl_slam_tpu_torch.ops import pointcloud as pc
from scl_slam_tpu_torch.runtime import mapper as M
from scl_slam_tpu_torch.runtime.state import state_from_numpy, state_to_numpy
from test_torch_kernels import release_jax_programs  # noqa: F401 (autouse)
from test_torch_native_loader import jax_native  # noqa: F401 (fixture)

torch.set_num_threads(2)

N_FRAMES = 52   # 3 chunks of 2 x 8 frames + a remainder of 4 (add_frames)
SPLIT = 16      # the mid-session hand-over point (one chunk)
BATCH, CHUNK = 8, 2


def _cfg(mod):
    return mod.SlamConfig(
        keyframe=mod.KeyframeConfig(
            max_keyframes=64, points_per_keyframe=1024, raw_points_capacity=4096,
        ),
        loop=mod.LoopConfig(
            near_keyframes=4, submap_capacity=2048, icp_iterations=20,
            queue_capacity=64,
            # sparse surface samples: tests/test_pipeline.py's fitness gate
            history_fitness_score=8.0,
        ),
        optimizer=mod.OptimizerConfig(edge_capacity=128),
        # surface-sampled synthetic scans: tests/test_pipeline.py's gates
        scan_context=mod.ScanContextParams(
            exclude_recent=10, num_candidates=6, distance_threshold=0.25,
        ),
    )


@pytest.fixture(scope="module")
def workload():
    world = kitti.SyntheticWorld(seed=3, extent=120.0, n_clusters=80, pts_per_cluster=800)
    gt = kitti.loop_trajectory(n_frames=N_FRAMES, radius=30.0, revisit=True, laps=1.6)
    scans = [np.asarray(world.scan_at(gt[k], max_points=4096, seed=k)) for k in range(N_FRAMES)]
    R = gt[:, :3, :3].astype(np.float32)
    t = gt[:, :3, 3].astype(np.float32)
    stamps = [0.1 * k for k in range(N_FRAMES)]
    return R, t, scans, stamps


@pytest.fixture(scope="module")
def jax_run(workload):
    """The JAX reference, replayed in two calls with a state snapshot at
    the hand-over point."""
    R, t, scans, stamps = workload
    poses = [jse3.Pose(jnp.asarray(R[k]), jnp.asarray(t[k])) for k in range(N_FRAMES)]
    m = JMapper(_cfg(jconfig))
    kw = dict(apply_gate=False, batch=BATCH, chunk_batches=CHUNK)
    out1 = m.replay(poses[:SPLIT], scans[:SPLIT], stamps[:SPLIT], **kw)
    snap = state_to_numpy(m.state)
    out2 = m.replay(poses[SPLIT:], scans[SPLIT:], stamps[SPLIT:], **kw)
    return {"first": out1, "second": out2, "snap": snap, "final": state_to_numpy(m.state),
            "traj": m.trajectory()}


def _port_poses(R, t):
    return [se3.Pose(torch.from_numpy(R[k]), torch.from_numpy(t[k])) for k in range(len(R))]


def _same_loops(a, b):
    assert [x is None for x in a] == [x is None for x in b]
    for x, y in zip(a, b):
        if x is not None:
            assert x["matched_index"] == y["matched_index"]
            np.testing.assert_allclose(x["fitness"], y["fitness"], rtol=2e-2)


def _same_state(got: dict, ref: dict):
    n = int(ref["counts"][0])
    assert int(got["counts"][0]) == n
    for k in ("desc_db.index", "desc_db.robot", "desc_db.count", "graph.i", "graph.j",
              "graph.num_edges", "graph.prior_idx", "graph.num_priors", "loop_target",
              "loop_queue.count", "kf_mask", "counts"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        assert got[k].dtype == ref[k].dtype, k
    nq = int(ref["loop_queue.count"])
    for k in ("loop_queue.i", "loop_queue.j"):
        np.testing.assert_array_equal(got[k][:nq], ref[k][:nq], err_msg=k)
    np.testing.assert_allclose(got["loop_queue.z_t"][:nq], ref["loop_queue.z_t"][:nq], atol=5e-3)
    np.testing.assert_allclose(got["loop_queue.noise"][:nq], ref["loop_queue.noise"][:nq], rtol=2e-2)
    np.testing.assert_array_equal(got["kf_xyz"], ref["kf_xyz"])  # one gather: exact
    np.testing.assert_allclose(got["opt_t"][:n], ref["opt_t"][:n], atol=1e-4)
    np.testing.assert_allclose(got["opt_R"][:n], ref["opt_R"][:n], atol=1e-5)
    np.testing.assert_allclose(got["graph.z.t"], ref["graph.z.t"], atol=1e-4)
    np.testing.assert_allclose(got["desc_db.keys"], ref["desc_db.keys"], rtol=1e-5, atol=1e-5)


def test_replay_matches_jax(workload, jax_run):
    R, t, scans, stamps = workload
    poses = _port_poses(R, t)
    m = M.Mapper(_cfg(tconfig), "cpu")
    kw = dict(apply_gate=False, batch=BATCH, chunk_batches=CHUNK)
    out1 = m.replay(poses[:SPLIT], scans[:SPLIT], stamps[:SPLIT], **kw)
    out2 = m.replay(poses[SPLIT:], scans[SPLIT:], stamps[SPLIT:], **kw)
    loops = out1["loops"] + out2["loops"]
    ref_loops = jax_run["first"]["loops"] + jax_run["second"]["loops"]
    assert sum(1 for x in ref_loops if x) >= 5, "the workload closed too few loops"
    _same_loops(loops, ref_loops)
    assert out2["keyframes"] == jax_run["second"]["keyframes"] == N_FRAMES
    _same_state(state_to_numpy(m.state), jax_run["final"])
    np.testing.assert_allclose(m.trajectory(), jax_run["traj"], atol=1e-4)


def test_state_round_trip_and_mid_session_start(workload, jax_run):
    """A JAX mid-session state crosses into the port exactly
    (state_from_numpy / state_to_numpy), and the port continues the session
    from it with the JAX package's decisions."""
    snap = jax_run["snap"]
    st = state_from_numpy(snap, "cpu")
    back = state_to_numpy(st)
    assert back.keys() == snap.keys()
    for k in snap:
        assert back[k].dtype == snap[k].dtype and back[k].shape == snap[k].shape, k
        np.testing.assert_array_equal(back[k], snap[k], err_msg=k)

    R, t, scans, stamps = workload
    poses = _port_poses(R, t)
    m = M.Mapper(_cfg(tconfig), "cpu")
    m.state = st
    out = m.replay(poses[SPLIT:], scans[SPLIT:], stamps[SPLIT:],
                   apply_gate=False, batch=BATCH, chunk_batches=CHUNK)
    _same_loops(out["loops"], jax_run["second"]["loops"])
    _same_state(state_to_numpy(m.state), jax_run["final"])


@pytest.mark.parametrize("mode", ["int16", "host"])
def test_replay_input_modes_match_jax(workload, jax_native, monkeypatch, mode):
    """``replay(transfer="int16")`` and ``replay(host_descriptors=True)``
    against the JAX package's, over three chunks and a remainder of 4: the
    same loop decisions, matched indices, queue endpoints and state, under
    ``_same_state``'s bounds (``kf_xyz`` bit-equal: the port dequantizes by
    the JAX package's f32 multiply). Under ``host_descriptors`` only the
    remainder builds its images in the port (one call for its 4 frames);
    under ``int16`` every batch does."""
    R, t, scans, stamps = workload
    kw = dict(apply_gate=False, batch=BATCH, chunk_batches=CHUNK,
              **({"transfer": "int16"} if mode == "int16" else {"host_descriptors": True}))
    jm = JMapper(_cfg(jconfig))
    jout = jm.replay([jse3.Pose(jnp.asarray(R[k]), jnp.asarray(t[k])) for k in range(N_FRAMES)],
                     scans, stamps, **kw)
    make, made = tsc.scatter_max_image, []

    def counting(*a, **k):
        made.append(a[0].shape[0])
        return make(*a, **k)

    monkeypatch.setattr(tsc, "scatter_max_image", counting)
    m = M.Mapper(_cfg(tconfig), "cpu")
    out = m.replay(_port_poses(R, t), scans, stamps, **kw)
    assert sum(1 for x in jout["loops"] if x) >= 5, "the workload closed too few loops"
    _same_loops(out["loops"], jout["loops"])
    assert out["keyframes"] == jout["keyframes"] == N_FRAMES
    _same_state(state_to_numpy(m.state), state_to_numpy(jm.state))
    np.testing.assert_allclose(m.trajectory(), jm.trajectory(), atol=1e-4)
    chunks = m.last_replay["chunks"]
    cap = _cfg(tconfig).keyframe.raw_points_capacity
    frame_bytes = {"int16": cap * (6 + 1), "host": cap * (12 + 1) + 20 * 60 * 4}[mode]
    assert [c["h2d_bytes"] for c in chunks] == [BATCH * CHUNK * (frame_bytes + 52)] * 3
    assert made == ([4] if mode == "host" else [BATCH] * (3 * CHUNK) + [4])
    assert all(c["bin_ms"] > 0 for c in chunks) == (mode == "host")


def test_gate_and_unported_paths_raise():
    cfg = _cfg(tconfig)
    m = M.Mapper(cfg, "cpu")
    eye = np.eye(3, dtype=np.float32)
    poses = [se3.Pose(eye, np.float32([0.1 * k, 0, 0])) for k in range(30)]
    scans = [np.random.RandomState(k).uniform(-20, 20, (600, 3)).astype(np.float32) for k in range(30)]
    out = m.add_frames(poses, scans)  # 1 m gate: every 10th frame
    assert out["accepted"] == [k % 10 == 0 for k in range(30)]
    # the JAX package's argument checks: an unknown mode, and int16 with
    # host descriptors
    with pytest.raises(ValueError, match="unknown transfer"):
        m.replay(poses, scans, transfer="f16")
    with pytest.raises(ValueError, match="not supported"):
        m.replay(poses, scans, transfer="int16", host_descriptors=True)
    with pytest.raises(ValueError):  # more than a block: eviction cannot help
        m._ensure_capacity(cfg.keyframe.max_keyframes + 1)
    # a batch that could overflow the loop queue drains it (and solves)
    # first; it used to raise
    m._ensure_queue_headroom(cfg.loop.queue_capacity + 1)
    assert int(m.state.loop_queue.count) == 0
    # every descriptor family is ported: an M2DP Mapper is built and
    # ingests a frame
    m2dp = M.Mapper(dataclasses.replace(cfg, descriptor_type=tconfig.DescriptorType.M2DP), "cpu")
    assert m2dp.add_frame(poses[0], scans[0]) is not None
    assert int(m2dp.state.desc_db.count) == 1 and m2dp.state.desc_db.keys.shape[1] == 192
    # host descriptors are Scan Context images: another family raises
    with pytest.raises(RuntimeError, match="scan_context"):
        m2dp.replay(poses, scans, host_descriptors=True)
    assert int(m2dp.state.desc_db.count) == 1
    # the voxel storage modes are ported: they downsample to the storage width
    vox_cfg = tconfig.SlamConfig(keyframe=tconfig.KeyframeConfig(
        storage_downsample="voxel", points_per_keyframe=256, descript_leaf_size=0.5))
    small = M._prepare_cloud(pc.from_points(torch.from_numpy(scans[0]), 1024), vox_cfg)
    assert small.xyz.shape == (256, 3) and 0 < int(small.mask.sum()) <= 256


def test_replay_that_overflows_the_queue_drains(workload):
    """With a loop queue smaller than a chunk, every chunk first drains the
    queue into the graph and solves (``_ensure_queue_headroom``), in the
    port as in the JAX package: the same loops, loop-factor rows and (after
    a rigid alignment, for the near-gauge freedom of the weak prior) the
    same trajectory within 5e-3 m."""
    R, t, scans, stamps = workload
    kw = dict(apply_gate=False, batch=4, chunk_batches=2)

    def small_queue(mod):
        c = _cfg(mod)
        return mod.SlamConfig(
            keyframe=c.keyframe, scan_context=c.scan_context,
            loop=dataclasses.replace(c.loop, queue_capacity=8),
            optimizer=mod.OptimizerConfig(edge_capacity=128, gn_iters=4, cg_iters=24),
        )

    n_frames = 48  # six whole chunks of 8
    jm = JMapper(small_queue(jconfig))
    jout = jm.replay([jse3.Pose(jnp.asarray(R[k]), jnp.asarray(t[k])) for k in range(n_frames)],
                     scans[:n_frames], stamps[:n_frames], **kw)
    m = M.Mapper(small_queue(tconfig), "cpu")
    out = m.replay(_port_poses(R, t)[:n_frames], scans[:n_frames], stamps[:n_frames], **kw)
    _same_loops(out["loops"], jout["loops"])
    n = int(jm.state.graph.num_edges)
    n_loops = sum(1 for x in out["loops"] if x)
    assert int(m.state.graph.num_edges) == n > n_frames - 1, "no loop factor was drained"
    assert n_loops > 8 and int(m.state.loop_queue.count) == int(jm.state.loop_queue.count)
    np.testing.assert_array_equal(m.state.graph.i.numpy()[:n], np.asarray(jm.state.graph.i)[:n])
    np.testing.assert_array_equal(m.state.graph.j.numpy()[:n], np.asarray(jm.state.graph.j)[:n])
    got, ref = m.trajectory()[:, :3, 3], jm.trajectory()[:, :3, 3]
    _, Ra, ta = tio.umeyama_align(got, ref)
    np.testing.assert_allclose((Ra @ got.T).T + ta, ref, rtol=0, atol=5e-3)
