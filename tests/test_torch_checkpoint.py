"""Checkpoint / resume of the PyTorch port (``runtime/checkpoint.py``)
against the JAX package's module, at tests/test_checkpoint.py's widths.

Held: the port's round trip bit for bit (every state array, the cursors,
the eviction archive, the queued serve factors, the draw counters); a
shape mismatch rejected; the fleet's gates and staged frames, with the
staged frames in the JAX module's layout (equal to the file JAX writes);
a two-robot session saved and resumed mid-way equal to the uninterrupted
one bit for bit on the CPU (the RANSAC draw counters are saved); a
checkpoint written by the JAX package loaded into the port, both packages
then taking the same keyframe and loop decisions over 10 more frames with
equal counts and descriptor keys within 1e-5 (f32 sums of two libraries);
and a save racing a bus-thread peer ingest (with eviction) always writing
arrays and cursors of one moment, with no lock held across the write.
"""
import dataclasses
import json
import sys
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import scl_slam_tpu.config as jconfig
from scl_slam_tpu.geometry import se3 as jse3
from scl_slam_tpu.runtime import checkpoint as jck
from scl_slam_tpu.runtime import fleet as JF
from scl_slam_tpu.runtime import mapper as JM
from scl_slam_tpu_torch import config as tconfig
from scl_slam_tpu_torch import run_multi
from scl_slam_tpu_torch.geometry import se3
from scl_slam_tpu_torch.io import kitti
from scl_slam_tpu_torch.runtime import FleetMapper, Mapper
from scl_slam_tpu_torch.runtime import checkpoint as ck
from scl_slam_tpu_torch.runtime.state import state_to_numpy
from scl_slam_tpu_torch.runtime.transport import LocalBus
from test_torch_kernels import release_jax_programs  # noqa: F401 (autouse)
from test_torch_live import _cfg as live_cfg

torch.set_num_threads(2)


def tiny(mod, **kw):
    """tests/test_checkpoint.py::tiny_cfg in either package."""
    return mod.SlamConfig(
        keyframe=mod.KeyframeConfig(max_keyframes=16, points_per_keyframe=256,
                                    raw_points_capacity=512),
        loop=mod.LoopConfig(near_keyframes=2, submap_capacity=512, queue_capacity=8),
        optimizer=mod.OptimizerConfig(edge_capacity=64, gn_iters=2, cg_iters=8),
        scan_context=mod.ScanContextParams(exclude_recent=2),
        **kw,
    )


def _scans(n, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.uniform(-20, 20, (400, 3)).astype(np.float32) for _ in range(n)]


def _tpose(x):
    return se3.Pose(np.eye(3, dtype=np.float32), np.float32([x, 0.0, 0.0]))


def _jpose(x):
    return jse3.Pose(jnp.eye(3), jnp.array([x, 0.0, 0.0]))


def _assert_states_equal(a, b):
    sa, sb = state_to_numpy(a), state_to_numpy(b)
    assert list(sa) == list(sb)
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


def test_round_trip_is_bit_equal(tmp_path):
    m = Mapper(tiny(tconfig, number_of_robots=2), "cpu")
    for k, xyz in enumerate(_scans(5)):
        m.add_frame(_tpose(2.0 * k), xyz, stamp=0.1 * k)
        m.spin_once(now=0.1 * k)
    m._evicted = {0: [{"index": 0, "stamp": 0.0, "pose": np.eye(4)}]}
    m._pending_server_loops = [(1 << 16, 3, np.eye(4), 0.25)]
    m._verify_attempts = 7
    path = str(tmp_path / "ckpt.npz")
    info = ck.save(m, path)
    assert info["bytes"] > 0 and 0 <= info["lock_s"] <= info["save_s"]
    with np.load(path, allow_pickle=False) as d:  # pickle-free
        meta = json.loads(str(d["__meta__"]))
        assert meta["version"] == 1 and meta["frames_seen"] == 5
        assert sum(name.startswith("leaf_") for name in d.files) == 32
    m2 = ck.load(Mapper(tiny(tconfig, number_of_robots=2), "cpu"), path)
    _assert_states_equal(m.state, m2.state)
    for name in ("_frames_seen", "_keyframes", "_verify_attempts", "_last_opt_time", "icp_attempts"):
        assert getattr(m2, name) == getattr(m, name), name
    for p, q in ((m._last_kf_pose, m2._last_kf_pose),):
        np.testing.assert_array_equal(np.asarray(p.R), q.R)
        np.testing.assert_array_equal(np.asarray(p.t), q.t)
    assert m2._evicted[0][0]["index"] == 0 and m2._inter_dirty
    a, b, T, nz = m2._pending_server_loops[0]
    assert (a, b, nz) == (1 << 16, 3, 0.25) and np.array_equal(T, np.eye(4))
    np.testing.assert_array_equal(m2.trajectory(), m.trajectory())


def test_shape_mismatch_rejected(tmp_path):
    m = Mapper(tiny(tconfig), "cpu")
    m.add_frame(_tpose(0.0), _scans(1)[0])
    path = str(tmp_path / "ckpt.npz")
    ck.save(m, path)
    other = dataclasses.replace(
        tiny(tconfig), keyframe=dataclasses.replace(tiny(tconfig).keyframe, max_keyframes=32))
    with pytest.raises(ValueError, match="mismatch"):
        ck.load(Mapper(other, "cpu"), path)


def test_frames_seen_matches_jax():
    """The resume cursor after ``add_frame``, ``add_frames`` and ``replay``
    (a chunk of 4 and a remainder of 3, which ``replay`` hands to
    ``add_frames``), gated frames included."""
    jm, tm = JM.Mapper(tiny(jconfig)), Mapper(tiny(tconfig), "cpu")
    scans = _scans(12)
    xs = [0.0, 0.1, 2.0, 4.0, 4.2, 6.0, 8.0, 10.0, 12.0, 14.0, 16.0, 18.0]
    for x, s in zip(xs[:3], scans[:3]):
        assert (jm.add_frame(_jpose(x), s) is None) == (tm.add_frame(_tpose(x), s) is None)
    got = tm.add_frames([_tpose(x) for x in xs[3:5]], scans[3:5])
    ref = jm.add_frames([_jpose(x) for x in xs[3:5]], scans[3:5])
    assert got["accepted"] == ref["accepted"] == [True, False]
    got = tm.replay([_tpose(x) for x in xs[5:]], scans[5:], batch=2, chunk_batches=2)
    ref = jm.replay([_jpose(x) for x in xs[5:]], scans[5:], batch=2, chunk_batches=2)
    assert got["accepted"] == ref["accepted"]
    assert tm._frames_seen == jm._frames_seen == 12
    assert tm._keyframes == jm._keyframes == 10


def _fleet_feed(fleet, pose):
    rng = np.random.RandomState(3)
    big = rng.uniform(-20, 20, (700, 3)).astype(np.float32)  # above capacity: strided
    for r, x, xyz in ((0, 0.0, _scans(1)[0]), (1, 5.0, big), (0, 0.1, big), (1, 9.0, big)):
        fleet.add_robot_frame(r, pose(x), xyz, stamp=x)


def test_fleet_gates_and_staged_frames_survive(tmp_path):
    """Staged (not yet stepped) fleet frames and the per-robot gates
    survive a round trip; the staged arrays are the JAX module's, and each
    package loads the other's file."""
    cfg = tiny(tconfig, number_of_robots=2)
    f = FleetMapper(cfg, "cpu")
    _fleet_feed(f, _tpose)
    assert f._staged_per_robot == {0: 1, 1: 2}
    path, jpath = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    ck.save(f, path)
    jf = JF.FleetMapper(tiny(jconfig, number_of_robots=2))
    _fleet_feed(jf, _jpose)
    jck.save(jf, jpath)
    with np.load(path) as a, np.load(jpath) as b:
        for k in ("staged_robot", "staged_R", "staged_t", "staged_xyz", "staged_mask", "staged_stamp"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for src in (path, jpath):
        g = ck.load(FleetMapper(cfg, "cpu"), src)
        assert g._staged_per_robot == f._staged_per_robot
        assert sorted(g._fleet_last_pose) == [0, 1]
        np.testing.assert_array_equal(g._fleet_last_pose[1].t, [9.0, 0.0, 0.0])
        assert not g.add_robot_frame(1, _tpose(9.1), _scans(1)[0])  # the gate holds
    # the port's file loads into the JAX package too (its keys restart
    # from the seeds the port writes)
    jg = jck.load(JF.FleetMapper(tiny(jconfig, number_of_robots=2)), path)
    assert jg._staged_per_robot == f._staged_per_robot and jg._keyframes == f._keyframes
    np.testing.assert_array_equal(np.asarray(jg._fleet_key), np.asarray(jf._fleet_key))
    g = ck.load(FleetMapper(cfg, "cpu"), path)
    f.step()
    g.step()
    _assert_states_equal(f.state, g.state)
    assert g._fleet_steps == f._fleet_steps == 1


def _session_args(tmp_path):
    path = tmp_path / "small.yaml"
    path.write_text(
        "keyframe: {max_keyframes: 64, points_per_keyframe: 1024, raw_points_capacity: 4096}\n"
        "loop: {near_keyframes: 4, submap_capacity: 2048, icp_iterations: 10, queue_capacity: 32}\n"
        "optimizer: {edge_capacity: 256, gn_iters: 4, cg_iters: 24}\n")
    p = run_multi.argparse.ArgumentParser()
    run_multi.add_dataset_args(p)
    return p.parse_args(["--robots", "2", "--frames", "40", "--device", "cpu",
                         "--config", str(path)])


def _session(args, save_at=None, resume_from=None):
    """run_multi's in-process two-robot session: (mappers, per-frame
    results, checkpoint paths). ``save_at`` saves both robots after that
    many steps and goes on; ``resume_from`` loads them into fresh mappers
    and starts at their cursor."""
    get_scan, get_pose, n = run_multi.build_dataset(args)
    splits = run_multi.make_splits(n, 2, args.overlap)
    bus, ms = LocalBus(), []
    for r in range(2):
        m = Mapper(run_multi.make_cfg(args, r), "cpu")
        if resume_from:
            ck.load(m, resume_from[r])
        m.attach_bus(bus)
        ms.append(m)
    loops, paths = [], []
    for step in range(ms[0]._frames_seen, max(len(s) for s in splits)):
        if step == save_at:
            paths = [str(args.workdir / f"ckpt_{r}.npz") for r in range(2)]
            for m, path in zip(ms, paths):
                ck.save(m, path)
            loops.clear()  # what follows the checkpoint
        for r in range(2):
            if step < len(splits[r]):
                info = run_multi.feed(ms[r], splits[r][step], get_scan, get_pose)
                loops.append(None if info is None else (info["loop"], info.get("inter_loop")))
    for m in ms:
        m.optimize()
    return ms, loops, paths


def test_resume_equals_uninterrupted_run(tmp_path):
    args = _session_args(tmp_path)
    args.workdir = tmp_path
    whole, after, paths = _session(args, save_at=14)
    resumed, rest, _ = _session(args, resume_from=paths)
    assert sum(x is not None and x[1] is not None for x in rest) >= 3  # inter loops after it
    assert rest == after
    for a, b in zip(whole, resumed):
        _assert_states_equal(a.state, b.state)
        assert (a._verify_attempts, a._frames_seen) == (b._verify_attempts, b._frames_seen)
        assert a._verify_attempts > 0


def test_jax_checkpoint_loads_and_continues(tmp_path):
    """A JAX session of 20 frames saved by the JAX package, loaded into the
    port; both go on 10 frames past the revisit (tests/test_torch_live.py's
    world and widths)."""
    n, split = 30, 20
    world = kitti.SyntheticWorld(seed=3, extent=120.0, n_clusters=80, pts_per_cluster=800)
    gt = kitti.loop_trajectory(n_frames=n, radius=25.0, laps=1.6)
    scans = [world.scan_at(gt[k], max_points=4096, seed=k) for k in range(n)]
    jm = JM.Mapper(live_cfg(jconfig))

    def jp(T):
        return jse3.Pose(jnp.asarray(T[:3, :3], jnp.float32), jnp.asarray(T[:3, 3], jnp.float32))

    def tp(T):
        return se3.Pose(np.float32(T[:3, :3]), np.float32(T[:3, 3]))

    for k in range(split):
        if jm.add_frame(jp(gt[k]), scans[k], stamp=0.1 * k) is not None:
            jm.spin_once(now=0.1 * k)
    path = str(tmp_path / "jax.npz")
    jck.save(jm, path)
    tm = ck.load(Mapper(live_cfg(tconfig), "cpu"), path)
    assert (tm._frames_seen, tm._keyframes) == (jm._frames_seen, jm._keyframes) == (split, split)
    _assert_states_equal(tm.state, jm.state)
    got, ref = [], []
    for k in range(split, n):
        for m, pose, out in ((jm, jp, ref), (tm, tp, got)):
            wire = m.add_frame(pose(gt[k]), scans[k], stamp=0.1 * k)
            loop = None if wire is None else m.spin_once(now=0.1 * k)["loop"]
            out.append((wire is not None, loop and loop["matched_index"]))
    assert got == ref and sum(bool(x[1]) for x in ref) >= 5
    jm.optimize()
    tm.optimize()
    assert (tm._frames_seen, tm._keyframes) == (jm._frames_seen, jm._keyframes) == (n, n)
    for name in ("counts", "loop_target"):
        np.testing.assert_array_equal(getattr(tm.state, name).numpy(), np.asarray(getattr(jm.state, name)))
    assert int(tm.state.graph.num_edges) == int(jm.state.graph.num_edges)
    np.testing.assert_allclose(tm.state.desc_db.keys.numpy(), np.asarray(jm.state.desc_db.keys),
                               rtol=0, atol=1e-5)


def test_save_races_peer_ingest(tmp_path, monkeypatch):
    """A bus thread ingests a peer's chain (compacting its block as it
    fills) while the main thread saves: each file's arrays and eviction
    archive describe one moment (resident + evicted = the peer's next
    index), and neither lock is held while the file is written."""
    cfg = tiny(tconfig, number_of_robots=2)
    cfg = dataclasses.replace(cfg, keyframe=dataclasses.replace(
        cfg.keyframe, evict_keep_recent=4, evict_stride=2))
    m = Mapper(cfg, "cpu")
    wire = np.random.RandomState(1).rand(1200).astype(np.float32)
    held = []
    real = np.savez_compressed

    def savez(*a, **k):
        def probe():  # the ingest holds them only briefly
            for lock in (m._state_lock, m._write_lock):
                ok = lock.acquire(timeout=5)
                held.append(not ok)
                if ok:
                    lock.release()
        t = threading.Thread(target=probe)
        t.start()
        t.join()
        return real(*a, **k)

    monkeypatch.setattr(ck.np, "savez_compressed", savez)

    def ingest():
        for i in range(60):
            assert m.ingest_peer_descriptor(1, i, _tpose(1.0 * max(i - 1, 0)), _tpose(1.0 * i), wire, float(i))

    t = threading.Thread(target=ingest)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the two threads finely
    try:
        t.start()
        paths = []
        while (t.is_alive() and len(paths) < 50) or not paths:
            paths.append(str(tmp_path / f"c{len(paths)}.npz"))
            ck.save(m, paths[-1])
        t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not t.is_alive()
    K = cfg.keyframe.max_keyframes
    for p in paths:
        g = ck.load(Mapper(cfg, "cpu"), p)
        n = int(g.state.counts[1])
        evicted = len(g._evicted.get(1, []))
        nxt = int(g.state.desc_db.index[K + n - 1]) + 1 if n else 0
        assert n + evicted == nxt == g.next_index(1), p
    assert len(paths) >= 2 and not any(held)
