"""The multi-rank dry run of the distributed path (the port's analog of
the JAX package's ``__graft_entry__.dryrun_multichip``).

``dryrun_multichip(n, device, backend)`` spawns ``n`` ranks
(``multihost.spawn``: a FileStore rendezvous) and runs, in each, every
pipeline path that sharding could break, sharded, against a mapper in the
same rank that is not:

A. the live keyframe path with the descriptor DB row-sharded
   (``Mapper.shard_database``) and the drain's solve on the mesh
   (``Mapper.attach_mesh``), a loop forced into the queue so that the solve
   runs; held against a mapper with the same mesh drain and a whole DB;
B. peer-descriptor ingest and one ``Mapper.replay`` chunk against the
   sharded DB, held against a whole-DB mapper;
C. eviction and compaction with the DB sharded (the compacted DB is
   sharded again), held against a whole-DB mapper;
D. a 2-robot ``FleetMapper`` step with the shared DB sharded, held against
   the whole-DB fleet.

The frames revisit places, so the paths close loops and launch their
kernels: K2 (every descriptor), K4 (live ICP in A and C), K1 (replay and
fleet ICP) and K6 (the fleet's RANSAC). Each rank returns its checks'
numbers and kernel launches; the caller holds the ranks against each other.
A rank that fails fails the call: nothing catches it.

    python -m scl_slam_tpu_torch.parallel.dryrun --ranks 2 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np


def small_config(n_robots: int = 1, ranks: int = 1):
    """The dry run's tiny configuration (the JAX dry run's, at 16
    keyframes a robot where it has 32, so that eviction comes sooner), with
    the synthetic world's fitness gate, a tight prior and 48 PCG steps,
    its capacities scaled where they do not divide by ``ranks``."""
    from ..config import (
        KeyframeConfig, LoopConfig, OptimizerConfig, ScanContextParams, SlamConfig,
    )

    cfg = SlamConfig(
        number_of_robots=n_robots,
        keyframe=KeyframeConfig(
            max_keyframes=16, points_per_keyframe=512, raw_points_capacity=1024,
        ),
        # the synthetic world's fitness gate (its sampling spacing is its
        # fitness floor, as in run.demo_config)
        loop=LoopConfig(near_keyframes=3, submap_capacity=1024, icp_iterations=5,
                        history_fitness_score=8.0),
        # a tight prior fixes the gauge (the default leaves yaw and
        # translation nearly free) and 48 PCG steps converge the solve, so
        # that two solves on the card (whose sums are not bit-reproducible)
        # compare raw
        optimizer=OptimizerConfig(edge_capacity=128, gn_iters=2, cg_iters=48,
                                  prior_sigmas=(1e-3,) * 6),
        scan_context=ScanContextParams(exclude_recent=2, num_candidates=4),
    )
    if cfg.keyframe.max_keyframes % ranks or cfg.optimizer.edge_capacity % ranks:
        cfg = dataclasses.replace(
            cfg,
            keyframe=dataclasses.replace(cfg.keyframe, max_keyframes=4 * ranks),
            optimizer=dataclasses.replace(cfg.optimizer, edge_capacity=16 * ranks),
        )
    return cfg


def _frames(n: int, seed: int = 0):
    """(poses, scans): a 6-place circuit driven around and around, so that
    frame k revisits frame k - 6 (rendered by the synthetic world)."""
    from ..io import kitti as kio

    world = kio.SyntheticWorld(seed=seed, extent=40.0, n_clusters=30,
                               pts_per_cluster=120, max_range=30.0)
    poses, scans = [], []
    for k in range(n):
        a = 2 * np.pi * (k % 6) / 6
        T = np.eye(4)
        T[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]]
        T[:3, 3] = [8 * np.cos(a), 8 * np.sin(a), 0.0]
        poses.append(T)
        scans.append(world.scan_at(T, max_points=1024, seed=k % 6))
    return poses, scans


def _pose(T, device):
    import torch

    from ..geometry import se3

    T = torch.as_tensor(np.asarray(T, np.float32), device=device)
    return se3.Pose(T[:3, :3], T[:3, 3])


# A sharded run against a whole-DB one, per device. On the CPU they are
# bit-equal. On the card the sums run on atomics in another order each
# run, the 5-iteration ICP of this configuration does not converge, and
# its loop factors, so the solves, part by 0.6-1.4 mm (measured, H100).
TRAJ_ATOL = {"cpu": 0.0, "cuda": 5e-3}


def _close(a, b, atol, what):
    from ..runtime.state import to_numpy

    a, b = to_numpy(a), to_numpy(b)
    if a.shape != b.shape or not np.allclose(a, b, atol=atol, rtol=0):
        raise AssertionError(f"{what}: sharded {a} vs whole {b}")


def rank_dryrun(rank: int, world: int, device: str) -> dict:
    """Parts A-D in this rank (see the module docstring). Returns the
    numbers each part held, for the caller to hold across ranks."""
    import torch

    from ..descriptors import base
    from ..geometry import se3
    from ..ops import kernels
    from ..runtime import FleetMapper, Mapper
    from ..runtime.mapper import _queue_loop, encode_kf
    from . import multihost

    mesh = multihost.make_mesh(("shard",))
    cfg = small_config(1, world)
    kernels.reset_launch_counts()
    out: dict = {"rank": rank, "world": world}
    poses, scans = _frames(8)

    # --- A: live keyframes on a sharded DB, the drain on the mesh ---
    def drive_a(shard: bool):
        m = Mapper(cfg, device=device)
        if shard:
            m.shard_database(mesh)
        m.attach_mesh(mesh)
        loops = 0
        for k, (T, s) in enumerate(zip(poses, scans)):
            if m.add_frame(_pose(T, device), s, stamp=0.1 * k) is not None:
                loops += bool(m.spin_once(now=0.1 * k).get("loop"))
        # force a factor through the drain, so that the solve runs: the
        # first keyframe against the last, at their true relative pose
        n = m._keyframes
        z = np.linalg.inv(poses[0]) @ poses[n - 1]
        _queue_loop(m.state, encode_kf(0, 0), encode_kf(0, n - 1), _pose(z, device), 1e-3, cfg)
        chis = m.optimize()
        return m, loops, chis

    m_a, loops_a, chis_a = drive_a(True)
    ref_a, loops_ref, chis_ref = drive_a(False)
    traj = m_a.trajectory()
    if not (np.isfinite(chis_a).all() and np.isfinite(traj).all()):
        raise AssertionError("part A: the mesh drain ended non-finite")
    if int(m_a.state.loop_queue.count) != 0 or m_a.broken_drains:
        raise AssertionError("part A: the drain left the queue or broke down")
    if loops_a != loops_ref or loops_a < 1:
        raise AssertionError(f"part A: {loops_a} loops sharded, {loops_ref} whole")
    _close(traj, ref_a.trajectory(), TRAJ_ATOL[device], "part A trajectory")
    if device == "cpu":
        _close(chis_a, chis_ref, 0.0, "part A chi2")
    elif not chis_a[-1] < chis_a[0]:
        raise AssertionError(f"part A: the mesh drain's chi2 did not fall: {chis_a}")
    out["A"] = {"keyframes": m_a._keyframes, "loops": loops_a,
                "chi2": [float(c) for c in chis_a], "traj": traj}

    # --- B: peer ingest + one replay chunk on a sharded DB ---
    cfg2 = dataclasses.replace(cfg, number_of_robots=2)
    rng = np.random.RandomState(0)
    wires = rng.uniform(0, 4, (3, cfg.scan_context.num_rings * cfg.scan_context.num_sectors))
    wires = wires.astype(np.float32)

    def drive_b(shard: bool):
        m = Mapper(cfg2, device=device)
        if shard:
            m.shard_database(mesh)
        eye = se3.Pose(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        for i in range(3):
            if not m.ingest_peer_descriptor(1, i, eye, eye, wires[i], stamp=0.1 * i):
                raise AssertionError("part B: a peer descriptor was dropped")
        res = m.replay([_pose(T, "cpu") for T in poses[:8]], scans[:8],
                       stamps=[0.1 * k for k in range(8)], apply_gate=False,
                       batch=4, chunk_batches=2)
        if res["keyframes"] != 8:
            raise AssertionError("part B: the replay lost frames")
        return m, sum(1 for x in res["loops"] if x)

    m_b, loops_b = drive_b(True)
    ref_b, loops_b_ref = drive_b(False)
    if loops_b != loops_b_ref:
        raise AssertionError(f"part B: {loops_b} loops sharded, {loops_b_ref} whole")
    for r in (0, 1):
        _close(m_b.trajectory(robot=r), ref_b.trajectory(robot=r), TRAJ_ATOL[device],
               f"part B robot {r}")
    _close(m_b.state.counts, ref_b.state.counts, 0, "part B counts")
    db, db_ref = m_b.unsharded_state().desc_db, ref_b.state.desc_db
    for name in ("descriptors", "keys", "robot", "index", "count"):
        _close(getattr(db, name), getattr(db_ref, name), 0, f"part B DB {name}")
    out["B"] = {"counts": [int(c) for c in m_b.state.counts], "loops": loops_b}

    # --- C: eviction and compaction with the DB sharded ---
    cap = cfg.keyframe.max_keyframes
    ev_poses, ev_scans = _frames(cap + 4, seed=1)

    def drive_c(shard: bool):
        m = Mapper(cfg, device=device)
        if shard:
            m.shard_database(mesh)
        for k in range(cap + 4):   # 4 frames past the capacity: a compaction
            T = ev_poses[k].copy()
            T[0, 3] += 2.0 * k      # a new place every frame
            m.add_frame(_pose(T, device), ev_scans[k], stamp=0.1 * k)
            m.spin_once(now=0.1 * k)
        return m

    m_c, ref_c = drive_c(True), drive_c(False)
    if m_c._keyframes != cap + 4 or int(m_c.state.counts[0]) > cap or not m_c._evicted.get(0):
        raise AssertionError("part C: no compaction")
    if base.shard_of(m_c.state.desc_db) is None:
        raise AssertionError("part C: the DB was not sharded again after the compaction")
    full, stamps = m_c.full_trajectory()
    full_ref, stamps_ref = ref_c.full_trajectory()
    _close(stamps, stamps_ref, 0, "part C stamps")
    _close(full, full_ref, TRAJ_ATOL[device], "part C full trajectory")
    out["C"] = {"keyframes": m_c._keyframes, "resident": int(m_c.state.counts[0]),
                "evicted": len(m_c._evicted[0])}

    # --- D: a 2-robot fleet step with the shared DB sharded ---
    def drive_d(shard: bool):
        f = FleetMapper(cfg2, device=device)
        if shard:
            f.shard_database(mesh)
        inter = 0
        for k in range(8):
            for r in range(2):
                T = poses[k].copy()
                T[1, 3] += 0.5 * r
                f.add_robot_frame(r, _pose(T, "cpu"), scans[k], stamp=0.1 * k)
            inter += sum("inter_loop" in ev for ev in f.step())
        f.optimize()
        return f, inter

    f_d, inter_d = drive_d(True)
    ref_d, inter_ref = drive_d(False)
    counts = [int(c) for c in f_d.state.counts[:2]]
    if counts != [int(c) for c in ref_d.state.counts[:2]] or counts != [8, 8]:
        raise AssertionError(f"part D: counts {counts}")
    if int(f_d.state.loop_queue.count) != int(ref_d.state.loop_queue.count):
        raise AssertionError("part D: the loop queues differ")
    if inter_d != inter_ref:
        raise AssertionError(f"part D: {inter_d} inter loops sharded, {inter_ref} whole")
    for r in (0, 1):
        _close(f_d.trajectory(robot=r), ref_d.trajectory(robot=r), TRAJ_ATOL[device],
               f"part D robot {r}")
    out["D"] = {"counts": counts, "inter_loops": inter_d,
                "queue": int(f_d.state.loop_queue.count)}
    if device == "cuda":
        torch.cuda.synchronize()
    out["launches"] = dict(kernels.LAUNCHES)
    return out


def dryrun_multichip(n: int, device: str = "cuda", backend: str | None = None,
                     threads: int | None = None, workdir: str | None = None) -> list[dict]:
    """Parts A-D in ``n`` spawned ranks on ``device`` (NCCL for "cuda",
    gloo for "cpu", unless ``backend`` names one; two ranks share a card
    over gloo only). Every rank holds its sharded runs against whole-DB
    runs; the ranks' trajectories and counts are then held equal here.
    ``threads`` and ``workdir`` (where the ranks meet) go to
    ``multihost.spawn``. Returns the ranks' results."""
    from . import multihost

    outs = multihost.spawn(rank_dryrun, n, (device,), device=device, backend=backend,
                           threads=threads, workdir=workdir)
    hold_ranks(outs)
    return outs


def hold_ranks(outs: list[dict]) -> None:
    """Raise unless every rank's :func:`rank_dryrun` result is rank 0's:
    part A's trajectory bit for bit (the mesh solve's poses are the same
    on every rank), parts B-D's numbers."""
    for o in outs[1:]:
        np.testing.assert_array_equal(o["A"]["traj"], outs[0]["A"]["traj"])
        for part in ("B", "C", "D"):
            if o[part] != outs[0][part]:
                raise AssertionError(f"part {part}: rank {o['rank']} {o[part]} vs {outs[0][part]}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="multi-rank dry run of the distributed path")
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--backend", choices=["nccl", "gloo"], default=None)
    args = p.parse_args(argv)
    outs = dryrun_multichip(args.ranks, args.device, args.backend)
    print(json.dumps([{k: v for k, v in o.items() if k != "A"} | {"A_loops": o["A"]["loops"]}
                      for o in outs]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
