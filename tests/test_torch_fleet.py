"""The centralized fleet path of the PyTorch port against the JAX package:
``ransac_align_batched`` (kernels K1 and K6), the mixed-robot block ingest
and ``FleetMapper`` on ``tests/test_fleet.py``'s two-robot scenario.

Stated tolerances, with their reasons:

- RANSAC with JAX's own uniforms injected, both sides on an exact
  per-coordinate 1-NN (JAX's CPU 1-NN is patched to it, as the K1 contract
  computes it): the same correspondences and the same minimal samples
  (cumsum + searchsorted are exact), hence the same triangles. The two
  packages build the hypotheses from them with their own cross products
  and norms (1e-6 apart), so a count may differ by the points whose res2
  lies within 1e-4 of thr2, which the test counts; the winner, the success
  flag and the inlier count are equal, the pose agrees to 1e-4 (SVD
  libraries).
- The block ingest is equal on integer and bool arrays and within 1e-5 on
  the chained poses of a 20 m scene (compose and orthonormalization
  order: a few ulp).
- The fleet scenario, with JAX's uniforms injected into the port's RANSAC:
  the same keyframes per robot block, the same intra and inter decisions
  with inlier ratios within 5e-3 (JAX's CPU 1-NN ranks by the expanded-form
  distance, the port by the exact one: a near-tie may pick another
  neighbour), the joint trajectories within 2e-2 m after a rigid alignment
  (the weak prior leaves a near-gauge freedom; BLAS and SVD orders).
  ``replay`` equals the stepwise run: the same keyframes, events and
  state.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import scl_slam_tpu.config as jconfig
from scl_slam_tpu.geometry import se3 as jse3
from scl_slam_tpu.io import kitti as jkitti
from scl_slam_tpu.ops import pointcloud as jpc
from scl_slam_tpu.ops import registration as jreg
from scl_slam_tpu.runtime import FleetMapper as JFleetMapper
from scl_slam_tpu.runtime import fleet as JF
from scl_slam_tpu.runtime import mapper as JM
from scl_slam_tpu.runtime.state import make_state as jmake_state
from scl_slam_tpu_torch import config as tconfig
from scl_slam_tpu_torch import run_multi
from scl_slam_tpu_torch.descriptors import scan_context as sc
from scl_slam_tpu_torch.geometry import se3
from scl_slam_tpu_torch.io import trajectory as tio
from scl_slam_tpu_torch.ops import kernels
from scl_slam_tpu_torch.ops import pointcloud as pc
from scl_slam_tpu_torch.ops import registration as reg
from scl_slam_tpu_torch.runtime import FleetMapper
from scl_slam_tpu_torch.runtime import fleet as F
from scl_slam_tpu_torch.runtime.state import state_from_numpy, state_to_numpy
from test_torch_kernels import _jax_slab_counts, _ransac_res2_numpy
from test_torch_kernels import release_jax_programs  # noqa: F401 (autouse)

torch.set_num_threads(2)


def fleet_cfg(mod, max_keyframes=64):
    """tests/test_fleet.py's configuration."""
    return mod.SlamConfig(
        number_of_robots=2, robot_id=0,
        keyframe=mod.KeyframeConfig(
            max_keyframes=max_keyframes, points_per_keyframe=2048,
            raw_points_capacity=4096, distance_threshold=2.0, descript_leaf_size=0.3,
        ),
        loop=mod.LoopConfig(
            near_keyframes=4, submap_capacity=8192, icp_iterations=20,
            history_fitness_score=8.0, ransac_inlier_ratio=0.3,
            ransac_outlier_threshold=1.0,
        ),
        optimizer=mod.OptimizerConfig(
            edge_capacity=512, gn_iters=6, cg_iters=48,
            odometry_sigmas=(0.005,) * 3 + (0.05,) * 3, loop_noise_scale=0.05,
        ),
        scan_context=mod.ScanContextParams(
            exclude_recent=10, num_candidates=6, distance_threshold=0.25
        ),
    )


def _exact_select(q, payload):
    """JAX 1-NN by the exact per-coordinate distance (the K1 contract's
    order), the first minimum on ties."""
    t = payload[:3]
    dx = q[:, 0, None] - t[0][None]
    dy = q[:, 1, None] - t[1][None]
    dz = q[:, 2, None] - t[2][None]
    d2 = (dx * dx + dy * dy) + dz * dz
    idx = jnp.argmin(d2, axis=-1)
    return jnp.take_along_axis(d2, idx[:, None], axis=1)[:, 0], payload[:, idx]


def _rot(w):
    return np.asarray(jse3.exp(jnp.asarray(list(w) + [0.0, 0.0, 0.0], jnp.float32)).R)


def _ransac_lanes(seed=3, B=4, N=256, M=1024):
    """B verification lanes: the source is the first N target points moved
    by a lane pose (rotation up to 0.05 rad, 0.5 m), with 5 cm noise and a
    quarter replaced by outliers; ~5% of the points masked on each side.
    Lane 2 is inactive, lane 3's target is fully masked."""
    rng = np.random.RandomState(seed)
    tgt = rng.uniform(-15, 15, (B, M, 3)).astype(np.float32)
    tmask = rng.rand(B, M) > 0.05
    tmask[3] = False
    src = np.empty((B, N, 3), np.float32)
    for b in range(B):
        R = _rot(rng.normal(0, 0.03, 3))
        t = rng.normal(0, 0.3, 3)
        src[b] = (tgt[b, :N] - t) @ R + rng.normal(0, 0.05, (N, 3))
    src[:, -N // 4 :] = rng.uniform(-15, 15, (B, N // 4, 3))
    smask = rng.rand(B, N) > 0.05
    active = np.array([True, True, False, True])
    return src, smask, tgt, tmask, active


def test_ransac_align_batched_matches_jax_with_injected_uniforms(monkeypatch):
    src, smask, tgt, tmask, active = _ransac_lanes()
    B, H, thr = src.shape[0], 64, 0.5
    key = jax.random.PRNGKey(11)
    uniforms = np.asarray(jax.random.uniform(key, (B, H, 3), dtype=jnp.float32))
    rec = {"jax": {}, "port": {}}

    def recording(side, name, fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            rec[side][name] = (a, out)
            return out
        return wrapped

    monkeypatch.setattr(jreg, "nearest_select", _exact_select)
    monkeypatch.setattr(jreg, "_matches_batched",
                        recording("jax", "matches", jreg._matches_batched))
    monkeypatch.setattr(jreg, "rigid_from_triangles",
                        recording("jax", "triangles", jreg.rigid_from_triangles))
    monkeypatch.setattr(reg, "_matches_batched",
                        recording("port", "matches", reg._matches_batched))
    monkeypatch.setattr(reg, "rigid_from_triangles",
                        recording("port", "triangles", reg.rigid_from_triangles))
    monkeypatch.setattr(kernels, "ransac_counts_batched",
                        recording("port", "counts", kernels.ransac_counts_batched))
    kw = dict(num_hypotheses=H, inlier_thresh=thr, min_inlier_ratio=0.3)
    ref = jreg.ransac_align_batched(
        jpc.Cloud(jnp.asarray(src), jnp.asarray(smask)),
        jpc.Cloud(jnp.asarray(tgt), jnp.asarray(tmask)), key, jnp.asarray(active), **kw,
    )
    res = reg.ransac_align_batched(
        pc.Cloud(torch.from_numpy(src), torch.from_numpy(smask)),
        pc.Cloud(torch.from_numpy(tgt), torch.from_numpy(tmask)), 0, 0,
        torch.from_numpy(active), uniforms=torch.from_numpy(uniforms.copy()), **kw,
    )
    # the same correspondences and the same samples on the active lanes
    # (JAX's CPU 1-NN is not predicated: it matches the inactive lane too)
    _, (_, _, jmatched, jgood) = rec["jax"]["matches"]
    _, (_, _, matched, good) = rec["port"]["matches"]
    jgood = np.asarray(jgood) & active[:, None]
    assert not good[2].any()
    np.testing.assert_array_equal(good.numpy(), jgood)
    np.testing.assert_array_equal(matched.numpy()[good.numpy()], np.asarray(jmatched)[jgood])
    (jsrc_s, jdst_s), jhyp = rec["jax"]["triangles"]
    (src_s, dst_s), hyp = rec["port"]["triangles"]
    on = [0, 1, 3]
    np.testing.assert_array_equal(src_s.numpy()[on], np.asarray(jsrc_s)[on])
    np.testing.assert_array_equal(dst_s[:2].numpy(), np.asarray(jdst_s)[:2])
    # the same counts, up to the points on the threshold
    _, counts = rec["port"]["counts"]
    counts = counts.numpy()
    jR, jt = np.asarray(jhyp.R), np.asarray(jhyp.t)
    np.testing.assert_allclose(hyp.R.numpy()[:2], jR[:2], atol=1e-5)
    jcounts = _jax_slab_counts(src, np.asarray(jmatched), jgood, jR, jt, thr * thr)
    res2 = _ransac_res2_numpy(src, np.asarray(jmatched), jR, jt)
    near = ((np.abs(res2 - thr * thr) <= 1e-4) & jgood[:, None, :]).sum(-1)
    assert (np.abs(counts - jcounts)[:2] <= near[:2]).all()
    assert counts[:2].max() > 100 and (counts[3] == 0).all()
    # the same winner, decision and inliers; the pose to 1e-4
    np.testing.assert_array_equal(res.success.numpy(), np.asarray(ref.success))
    assert res.success.tolist() == [True, True, False, False]
    np.testing.assert_array_equal(res.num_inliers.numpy()[on], np.asarray(ref.num_inliers)[on])
    assert int(res.num_inliers[2]) == 0  # no correspondence on an inactive lane
    np.testing.assert_allclose(res.inlier_ratio.numpy(), np.asarray(ref.inlier_ratio), rtol=1e-6)
    np.testing.assert_allclose(res.pose.R.numpy(), np.asarray(ref.pose.R), atol=1e-4)
    np.testing.assert_allclose(res.pose.t.numpy(), np.asarray(ref.pose.t), atol=1e-4)
    for b in (2, 3):  # inactive, and no correspondence: the identity
        np.testing.assert_array_equal(res.pose.R[b].numpy(), np.eye(3, dtype=np.float32))
        assert float(res.inlier_ratio[b]) == 0.0

    # the port's own draws: the counter hash, the same on every call
    own = reg.ransac_align_batched(
        pc.Cloud(torch.from_numpy(src), torch.from_numpy(smask)),
        pc.Cloud(torch.from_numpy(tgt), torch.from_numpy(tmask)), 5, 2,
        torch.from_numpy(active), **kw,
    )
    assert own.success.tolist() == [True, True, False, False]
    np.testing.assert_allclose(own.inlier_ratio.numpy(), res.inlier_ratio.numpy(), atol=2e-2)
    u1 = reg.ransac_uniforms(B, H, 3, 5, 2, "cpu")
    assert torch.equal(u1, reg.ransac_uniforms(B, H, 3, 5, 2, "cpu"))
    assert not torch.equal(u1, reg.ransac_uniforms(B, H, 3, 5, 3, "cpu"))
    assert float(u1.min()) >= 0.0 and float(u1.max()) < 1.0 and abs(float(u1.mean()) - 0.5) < 0.02


def test_fleet_block_ingest_matches_jax():
    """A mixed batch (robot 1's first frames among robot 0's next ones)
    after a robot-0-only batch: the same slots, protocol indices, counts,
    graph rows, priors and stored keyframes as the JAX function."""
    mods = (jconfig, tconfig)
    jcfg, tcfg = (m.SlamConfig(
        number_of_robots=2,
        keyframe=m.KeyframeConfig(max_keyframes=16, points_per_keyframe=256,
                                  raw_points_capacity=512),
        optimizer=m.OptimizerConfig(edge_capacity=16, prior_capacity=4),
    ) for m in mods)
    rng = np.random.RandomState(8)
    prepare = jax.jit(jax.vmap(lambda x, m: JM._prepare_frame(x, m, jcfg)))
    ingest = jax.jit(lambda *a: JF._ingest_prepared_fleet_block(*a, jcfg))
    jst = jmake_state(jcfg)
    tst = state_from_numpy(state_to_numpy(jst), "cpu")
    for robots in ([0, 0, 0], [1, 0, 1, 1, 0]):
        B = len(robots)
        xyz = rng.uniform(-20, 20, (B, 512, 3)).astype(np.float32)
        mask = rng.rand(B, 512) > 0.1
        R = np.stack([_rot(rng.normal(0, 0.3, 3)) for _ in range(B)]).astype(np.float32)
        t = rng.normal(0, 5, (B, 3)).astype(np.float32)
        stamps = np.arange(B, dtype=np.float32)
        smalls, descs = prepare(jnp.asarray(xyz), jnp.asarray(mask))
        jst, jslots, jidx, jhist = ingest(
            jst, jnp.asarray(robots, jnp.int32), jse3.Pose(jnp.asarray(R), jnp.asarray(t)),
            smalls, descs, jnp.asarray(stamps),
        )
        tst, slots, idx, hist = F._ingest_prepared_fleet_block(
            tst, torch.tensor(robots, dtype=torch.int32),
            se3.Pose(torch.from_numpy(R), torch.from_numpy(t)),
            pc.Cloud(torch.tensor(np.asarray(smalls.xyz)), torch.tensor(np.asarray(smalls.mask))),
            sc.ScanContext(*(torch.tensor(np.asarray(d)) for d in descs)),
            torch.from_numpy(stamps), tcfg,
        )
        for a, b in ((slots, jslots), (idx, jidx), (hist, jhist)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert slots.tolist() == [16, 3, 17, 18, 4] and idx.tolist() == [0, 3, 1, 2, 4]
    got, ref = state_to_numpy(tst), state_to_numpy(jst)
    for k in got:
        assert got[k].dtype == ref[k].dtype, k
        if got[k].dtype.kind == "f":
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert int(tst.graph.num_priors) == 2 and int(tst.graph.num_edges) == 6


# ---------------------------------------------------------------------------
# the fleet scenario of tests/test_fleet.py, both packages
# ---------------------------------------------------------------------------

SPLIT = [list(range(0, 40)), list(range(28, 64))]


@pytest.fixture(scope="module")
def scenario():
    """Two robots on overlapping arcs; robot b's odometry drifts forward 5 cm
    and 1 mrad a frame (tests/test_fleet.py::fleet_run). Returns the
    arrival-ordered stream of (robot, pose [4, 4], scan, stamp) and gt."""
    world = jkitti.SyntheticWorld(seed=9, extent=100.0, n_clusters=70, pts_per_cluster=800)
    gt = jkitti.loop_trajectory(n_frames=64, radius=32.0, revisit=False)
    drift = np.asarray(jse3.to_matrix(jse3.exp(jnp.array([0, 0, 0.001, 0.05, 0.0, 0.0]))))
    odom = {SPLIT[1][0]: gt[SPLIT[1][0]]}
    for k in SPLIT[1][1:]:
        odom[k] = odom[k - 1] @ np.linalg.inv(gt[k - 1]) @ gt[k] @ drift
    stream = []
    for step in range(max(len(s) for s in SPLIT)):
        for rid, frames in enumerate(SPLIT):
            if step < len(frames):
                k = frames[step]
                T = (gt[k] if rid == 0 else odom[k]).astype(np.float32)
                stream.append((step, rid, T, world.scan_at(gt[k], max_points=4096, seed=k), 0.1 * k))
    return stream, gt


def _jax_uniforms(seed, steps, B, H):
    """JAX FleetMapper's RANSAC uniforms per fleet step: its key splits
    once per step."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        out.append(sub)
    return lambda step, b: np.asarray(jax.random.uniform(out[step], (b, H, 3), dtype=jnp.float32))


def _drive(fm, stream, pose_fn):
    events = []
    for step in range(stream[-1][0] + 1):
        for _, rid, T, scan, stamp in (x for x in stream if x[0] == step):
            fm.add_robot_frame(rid, pose_fn(T), scan, stamp=stamp)
        events.extend(fm.step())
    fm.optimize()
    return events


@pytest.fixture(scope="module")
def fleet_runs(scenario):
    stream, _ = scenario
    jfm = JFleetMapper(fleet_cfg(jconfig))
    jevents = _drive(jfm, stream, lambda T: jse3.Pose(jnp.asarray(T[:3, :3]), jnp.asarray(T[:3, 3])))
    jtraj = [jfm.trajectory(robot=r) for r in range(2)]
    jcounts = np.asarray(jfm.state.counts)
    jkinds = [c["kind"] for c in jfm.loop_constraints()]
    del jfm
    draws = _jax_uniforms(101, 64, 2, 256)
    mp = pytest.MonkeyPatch()
    mp.setattr(reg, "ransac_uniforms", lambda B, H, s, seed, step, device: torch.tensor(draws(step, B)))
    try:
        fm = FleetMapper(fleet_cfg(tconfig), "cpu")
        events = _drive(fm, stream, lambda T: se3.Pose(T[:3, :3], T[:3, 3]))
        rp = FleetMapper(fleet_cfg(tconfig), "cpu")
        replayed = rp.replay([(r, se3.Pose(T[:3, :3], T[:3, 3]), s, st) for _, r, T, s, st in stream],
                             batch=4, chunk_batches=4)
    finally:
        mp.undo()
    return dict(jevents=jevents, jtraj=jtraj, jcounts=jcounts, jkinds=jkinds,
                fm=fm, events=events, rp=rp, replayed=replayed)


def test_fleet_keyframes_and_decisions_match_jax(fleet_runs):
    r = fleet_runs
    fm, events, jevents = r["fm"], r["events"], r["jevents"]
    np.testing.assert_array_equal(fm.state.counts.numpy(), r["jcounts"])
    assert fm.state.counts.tolist() == [len(s) for s in SPLIT]
    K = fm.cfg.keyframe.max_keyframes
    for rob in range(2):  # each robot's keyframes in its own block, in order
        block = fm.state.desc_db.robot[rob * K : rob * K + len(SPLIT[rob])]
        assert (block == rob).all()
        idx = fm.state.desc_db.index[rob * K : rob * K + len(SPLIT[rob])]
        assert idx.tolist() == list(range(len(SPLIT[rob])))
    assert len(events) == len(jevents)
    assert [e["robot"] for e in events] == [e["robot"] for e in jevents]
    assert [("loop" in e) for e in events] == [("loop" in e) for e in jevents]
    inter = [(b, e["robot"], e["inter_loop"]) for b, e in enumerate(events) if "inter_loop" in e]
    jinter = [(b, e["robot"], e["inter_loop"]) for b, e in enumerate(jevents) if "inter_loop" in e]
    assert len(inter) >= 10 and {x[1] for x in inter} == {0, 1}
    assert [(b, rob, x["robot"], x["matched_index"]) for b, rob, x in inter] == [
        (b, rob, x["robot"], x["matched_index"]) for b, rob, x in jinter]
    np.testing.assert_allclose([x["inlier_ratio"] for *_, x in inter],
                               [x["inlier_ratio"] for *_, x in jinter], atol=5e-3)
    kinds = [c["kind"] for c in fm.loop_constraints()]
    assert kinds == r["jkinds"] and kinds.count("inter") == len(inter)


def test_fleet_joint_trajectories_match_jax(fleet_runs, scenario):
    r = fleet_runs
    gaps = []
    for rob in range(2):
        est, ref = r["fm"].trajectory(robot=rob), r["jtraj"][rob]
        _, R, t = tio.umeyama_align(est[:, :3, 3], ref[:, :3, 3])
        gaps.append(float(np.abs((R @ est[:, :3, 3].T).T + t - ref[:, :3, 3]).max()))
    assert max(gaps) < 2e-2, gaps
    # the joint solve pulls robot b toward the truth (tests/test_fleet.py's
    # unaligned criterion against dead reckoning)
    stream, gt = scenario
    fm = r["fm"]
    frames = [int(round(float(s) / 0.1)) for s in fm.keyframe_stamps(robot=1)]
    dead = {int(round(st / 0.1)): T for _, rid, T, _, st in stream if rid == 1}
    ate_opt = tio.ate_rmse(fm.trajectory(robot=1), gt[frames], align=False)
    ate_dead = tio.ate_rmse(np.stack([dead[k] for k in frames]), gt[frames], align=False)
    assert ate_opt < 0.95 * ate_dead, (ate_opt, ate_dead)


def test_fleet_replay_equals_stepwise(fleet_runs):
    """Chunks of 4 x 4 keyframes through ``_fleet_replay`` and the
    remainder through ``step``: the same keyframes, events and state as the
    stepwise run (the same batches: every step stages one frame a robot)."""
    r = fleet_runs
    out, fm, rp = r["replayed"], r["fm"], r["rp"]
    assert all(out["accepted"]) and out["keyframes"] == {0: len(SPLIT[0]), 1: len(SPLIT[1])}
    assert len(out["events"]) == len(r["events"])
    rp.optimize()
    got, ref = state_to_numpy(rp.state), state_to_numpy(fm.state)
    for k in ("counts", "desc_db.index", "desc_db.robot", "graph.i", "graph.j", "graph.num_edges",
              "loop_target", "loop_queue.count"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # the batches differ from the stepwise run's (16-frame chunks mix
    # steps), so the decisions are held, not the event order
    assert sum("inter_loop" in e for e in out["events"]) >= 10


def test_variable_batch_sizes_and_gate():
    """step() takes any staged batch (1..N robots, nothing staged); the
    keyframe gate is per robot, and equal to the JAX FleetMapper's."""
    world = jkitti.SyntheticWorld(seed=3)
    gt = jkitti.loop_trajectory(n_frames=12, radius=20.0, revisit=False).astype(np.float32)
    fm = FleetMapper(fleet_cfg(tconfig), "cpu")

    def pose(T):
        return se3.Pose(T[:3, :3], T[:3, 3])

    fm.add_robot_frame(0, pose(gt[0]), world.scan_at(gt[0], 4096, seed=0))
    assert len(fm.step()) == 1
    fm.add_robot_frame(0, pose(gt[3]), world.scan_at(gt[3], 4096, seed=3))
    fm.add_robot_frame(1, pose(gt[8]), world.scan_at(gt[8], 4096, seed=8))
    assert len(fm.step()) == 2
    assert fm.step() == []
    assert fm.state.counts.tolist() == [2, 1]
    with pytest.raises(ValueError):
        fm.add_robot_frame(2, pose(gt[0]), world.scan_at(gt[0], 4096, seed=0))

    jfm = JFleetMapper(fleet_cfg(jconfig))
    tfm = FleetMapper(fleet_cfg(tconfig), "cpu")
    scan = world.scan_at(np.eye(4), 4096, seed=0)
    rng = np.random.RandomState(2)
    for k in range(12):
        rob = k % 2
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = _rot(rng.normal(0, 0.1, 3))
        T[:3, 3] = rng.normal(0, 1.0, 3)
        jpose = jse3.Pose(jnp.asarray(T[:3, :3]), jnp.asarray(T[:3, 3]))
        assert tfm._gate(rob, pose(T)) == jfm._gate(rob, jpose)
        assert tfm.add_robot_frame(rob, pose(T), scan) == jfm.add_robot_frame(rob, jpose, scan)
    assert [x[0] for x in tfm._fleet_staged] == [x[0] for x in jfm._fleet_staged]


def test_fleet_eviction_keeps_running():
    """At a capacity of 8 the per-robot compaction fires before a batch
    lands; protocol indices stay monotone and full_trajectory returns
    every keyframe (tests/test_fleet.py::test_eviction_keeps_fleet_running)."""
    world = jkitti.SyntheticWorld(seed=4)
    gt = jkitti.loop_trajectory(n_frames=40, radius=25.0, revisit=False).astype(np.float32)
    cfg = fleet_cfg(tconfig, max_keyframes=8)
    cfg = dataclasses.replace(cfg, loop=dataclasses.replace(
        cfg.loop, intra_enabled=False, inter_enabled=False))
    fm = FleetMapper(cfg, "cpu")
    for k in range(0, 40, 2):
        fm.add_robot_frame(0, se3.Pose(gt[k][:3, :3], gt[k][:3, 3]),
                           world.scan_at(gt[k], 4096, seed=k), stamp=0.1 * k)
        fm.step()
    assert int(fm.state.counts[0]) <= 8 and len(fm._evicted[0]) == 20 - int(fm.state.counts[0])
    idx = fm.state.desc_db.index[: int(fm.state.counts[0])]
    assert (torch.diff(idx) > 0).all() and int(idx[-1]) == 19
    poses, stamps = fm.full_trajectory(robot=0)
    assert len(poses) == 20 and np.all(np.diff(stamps) > 0)


SMALL = """\
keyframe:
  max_keyframes: 64
  points_per_keyframe: 1024
  raw_points_capacity: 4096
loop:
  near_keyframes: 4
  submap_capacity: 2048
  icp_iterations: 10
  queue_capacity: 32
optimizer:
  edge_capacity: 256
  gn_iters: 4
  cg_iters: 24
"""


def test_run_multi_fleet_on_cpu(tmp_path, capsys):
    """``run_multi --fleet --device cpu`` on a YAML of small widths: the
    report's keys (the JAX runner's, its joint figure included) with mode
    "fleet", inter-robot loops, both trajectories written."""
    path = tmp_path / "small.yaml"
    path.write_text(SMALL)
    argv = ["--robots", "2", "--frames", "40", "--device", "cpu", "--config", str(path),
            "--output", str(tmp_path / "out"), "--fleet"]
    assert run_multi.main(argv) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["mode"] == "fleet" and rep["device"] == "cpu" and rep["frames"] == 40
    assert rep["inter_loops"] >= 1, rep
    assert set(rep) == {"robots", "mode", "frames", "intra_loops", "inter_loops", "wall_s",
                        "frames_per_s", "device", "output", "ate_rmse_m", "figure"}
    assert set(rep["ate_rmse_m"]) == {"a", "b"} and max(rep["ate_rmse_m"].values()) < 0.1
    assert run_multi.main(argv + ["--transport", "tcp"]) == 2
