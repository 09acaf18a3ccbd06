"""Rank functions of the port's distributed tests (``test_torch_sharded.py``,
``test_torch_mesh_drain.py``, ``test_torch_sharded_db.py``), run in
processes spawned by ``scl_slam_tpu_torch.parallel.multihost.spawn`` on a
FileStore: this module imports only the port (the test files hold the
results against the JAX package). Inputs and results are numpy arrays.
"""
import numpy as np
import torch

from scl_slam_tpu_torch.config import (
    KeyframeConfig, LoopConfig, OptimizerConfig, ScanContextParams, SlamConfig,
)
from scl_slam_tpu_torch.descriptors import base
from scl_slam_tpu_torch.descriptors import geometric
from scl_slam_tpu_torch.descriptors import scan_context as sc
from scl_slam_tpu_torch.geometry import se3
from scl_slam_tpu_torch.graph import factors as F
from scl_slam_tpu_torch.parallel import multihost, sharded
from scl_slam_tpu_torch.runtime import Mapper
from scl_slam_tpu_torch.runtime.mapper import _queue_loop, encode_kf


def port_graph(a: dict) -> F.FactorGraph:
    """A FactorGraph from the numpy arrays of ``test_torch_solver._graph_arrays``."""
    t = {k: torch.from_numpy(np.array(v)) for k, v in a.items()}
    return F.FactorGraph(
        t["i"], t["j"], se3.Pose(t["z.R"], t["z.t"]), t["sqrt_info"], t["num_edges"],
        t["prior_idx"], se3.Pose(t["prior_z.R"], t["prior_z.t"]), t["prior_sqrt_info"],
        t["num_priors"],
    )


def graph_arrays(g: F.FactorGraph) -> dict:
    """The inverse of :func:`port_graph`."""
    return {"i": g.i.numpy(), "j": g.j.numpy(), "z.R": g.z.R.numpy(), "z.t": g.z.t.numpy(),
            "sqrt_info": g.sqrt_info.numpy(), "num_edges": g.num_edges.numpy(),
            "prior_idx": g.prior_idx.numpy(), "prior_z.R": g.prior_z.R.numpy(),
            "prior_z.t": g.prior_z.t.numpy(), "prior_sqrt_info": g.prior_sqrt_info.numpy(),
            "num_priors": g.num_priors.numpy()}


def solve_jobs(rank, world, jobs):
    """``("topk", db, q, mask, k)``: this rank's rows of ``db`` through
    ``sharded_topk``; ``("solve", graph arrays, R0, t0, kwargs)``:
    ``sharded_solve``. Returns one result per job, and the all-reduces
    each solve issued."""
    out = []
    for job in jobs:
        if job[0] == "topk":
            _, db, q, mask, k = job
            n = db.shape[0] // world
            rows = slice(rank * n, (rank + 1) * n)
            d2, pos = sharded.sharded_topk(
                None, torch.from_numpy(db[rows]), torch.from_numpy(q),
                torch.from_numpy(mask[..., rows]), k)
            out.append((d2.numpy(), pos.numpy()))
        else:
            _, a, R0, t0, kw = job
            sharded.reset_counts()
            poses, chis, code = sharded.sharded_solve(
                None, port_graph(a), se3.Pose(torch.from_numpy(R0), torch.from_numpy(t0)), **kw)
            assert int(code) == 0, code   # no step broke down
            out.append((poses.R.numpy(), poses.t.numpy(), chis.numpy(),
                        sharded.COUNTS["all_reduce"]))
    return out


def drain_cfg(**opt_kw) -> SlamConfig:
    """``tests/test_mesh_drain.py``'s configuration, in the port's classes."""
    opt = dict(edge_capacity=128, gn_iters=8, cg_iters=48, max_outer_rounds=8,
               prior_sigmas=(1e-3,) * 6)
    opt.update(opt_kw)
    return SlamConfig(
        keyframe=KeyframeConfig(max_keyframes=32, points_per_keyframe=512,
                                raw_points_capacity=1024, distance_threshold=0.5),
        loop=LoopConfig(intra_enabled=False, inter_enabled=False),
        optimizer=OptimizerConfig(**opt),
        scan_context=ScanContextParams(exclude_recent=2, num_candidates=4),
    )


def _pose(T):
    T = np.asarray(T, np.float32)
    return se3.Pose(torch.from_numpy(T[:3, :3].copy()), torch.from_numpy(T[:3, 3].copy()))


def build_mapper(cfg, odom, seed=0):
    """Ingest the odometry chain [N, 4, 4] with small random scans."""
    rng = np.random.RandomState(seed)
    m = Mapper(cfg, device="cpu")
    for k, T in enumerate(odom):
        m.add_frame(_pose(T), rng.uniform(-20, 20, (1024, 3)).astype(np.float32), stamp=0.1 * k)
    assert m._keyframes == len(odom)
    return m


def inject_loops(m, gt, pairs, noise=1e-3):
    """Queue ground-truth loop factors (what verification produces)."""
    for i, j in pairs:
        z = np.linalg.inv(gt[i]) @ gt[j]
        _queue_loop(m.state, encode_kf(0, i), encode_kf(0, j), _pose(z), noise, m.cfg)


def mesh_drain_scenarios(rank, world, data):
    """The six scenarios of ``tests/test_mesh_drain.py`` with a mesh over
    the ranks. ``data``: ground truth and odometry chains (numpy)."""
    mesh = multihost.make_mesh(("shard",))
    gt, N = data["gt"], len(data["gt"])
    out = {}

    m1 = build_mapper(drain_cfg(), data["odom"])
    m2 = build_mapper(drain_cfg(), data["odom"])
    for m in (m1, m2):
        inject_loops(m, gt, [(0, N - 1), (0, N // 2)])
    m2.attach_mesh(mesh)
    before = m1.trajectory()
    slots_before = (m2.state.opt_R.numpy().copy(), m2.state.opt_t.numpy().copy())
    out["two_stage"] = dict(
        before=before, chi_single=m1.optimize(), chi_mesh=m2.optimize(),
        single=m1.trajectory(), mesh=m2.trajectory(),
        queues=(int(m1.state.loop_queue.count), int(m2.state.loop_queue.count)),
        broken=m2.broken_drains, slots_before=slots_before,
        slots_after=(m2.state.opt_R.numpy(), m2.state.opt_t.numpy()),
        graph=graph_arrays(m2.state.graph),
    )

    cfg = drain_cfg(max_outer_rounds=10, odometry_sigmas=(0.1, 0.1, 0.1, 0.2, 0.2, 0.2))
    m = build_mapper(cfg, data["odom_severe"])
    inject_loops(m, gt, [(0, N - 1), (0, N // 2), (N // 4, 3 * N // 4)])
    m.attach_mesh(mesh)
    before = m.trajectory()
    chis = m.optimize()
    out["large_rotation"] = dict(before=before, after=m.trajectory(), chis=chis)

    m = build_mapper(drain_cfg(rotation_change_threshold=1e6, pose_change_threshold=1e6),
                     data["odom"])
    inject_loops(m, gt, [(0, N - 1)])
    m.attach_mesh(mesh)
    out["freeze"] = dict(chis=m.optimize(), rounds=m.cfg.optimizer.max_outer_rounds)

    m = build_mapper(drain_cfg(gamma=0.0), data["odom"])
    before = m.trajectory()
    inject_loops(m, gt, [(0, N - 1)])
    m.attach_mesh(mesh)
    m.optimize()
    out["gamma_zero"] = dict(before=before, after=m.trajectory())

    m = build_mapper(drain_cfg(), data["odom"])
    m.attach_mesh(mesh)
    m.detach_mesh()
    inject_loops(m, gt, [(0, N - 1)])
    out["detach"] = dict(chis=m.optimize(), gn_iters=m.cfg.optimizer.gn_iters)

    out["sparse_fleet"] = sparse_fleet(mesh)

    # an edge capacity the ranks do not divide
    m = Mapper(drain_cfg(edge_capacity=128 * world + 1), device="cpu")
    try:
        m.attach_mesh(mesh)
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def _rz(a):
    return np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])


def sparse_fleet(mesh):
    """Phase 43's fleet in miniature: four robots on the frames of a 70 m
    circle, 0.49 rad apart, that run_multi's split of 16 frames gives them
    (4, 8, 12 and 14 keyframes), in 64 slots a robot with the coarse level
    at stride 32 (so each robot's trajectory lies in one supernode), the
    configuration's weak prior on each first pose, and six loop factors
    between robots at shared frames off by ~0.3 m; drained once on the
    mesh through ``optimize()``, and the drained graph solved from the
    chordal start by the single-device ``solver.solve``."""
    from scl_slam_tpu_torch.graph import solver
    from scl_slam_tpu_torch.graph.rotation_init import chordal_rotation_init
    from scl_slam_tpu_torch.runtime import FleetMapper

    cfg = SlamConfig(
        number_of_robots=4,
        keyframe=KeyframeConfig(max_keyframes=64, points_per_keyframe=512,
                                raw_points_capacity=1024, distance_threshold=0.5),
        loop=LoopConfig(intra_enabled=False, inter_enabled=False),
        optimizer=OptimizerConfig(edge_capacity=512, cg_iters=96, coarse_stride=32),
        scan_context=ScanContextParams(exclude_recent=2, num_candidates=4),
    )
    frames = [range(0, 4), range(0, 8), range(0, 12), range(2, 16)]

    def gt(f):
        T = np.eye(4)
        T[:3, :3] = _rz(0.49 * f + np.pi / 2)
        T[:3, 3] = [70 * np.cos(0.49 * f), 70 * np.sin(0.49 * f), 1.8]
        return T

    rng = np.random.RandomState(5)
    fleet = FleetMapper(cfg, device="cpu")
    fleet.attach_mesh(mesh)
    for step in range(14):
        for r, fr in enumerate(frames):
            if step < len(fr):
                fleet.add_robot_frame(r, _pose(gt(fr[step])),
                                      rng.uniform(-20, 20, (512, 3)).astype(np.float32))
        fleet.step()
    for (ra, ka), (rb, kb) in [((1, 7), (2, 7)), ((1, 6), (2, 6)), ((2, 8), (3, 6)),
                               ((2, 9), (3, 7)), ((2, 10), (3, 8)), ((2, 11), (3, 9))]:
        noise = np.eye(4)
        noise[:3, :3], noise[:3, 3] = _rz(rng.normal(0, 0.02)), rng.normal(0, 0.3, 3)
        z = np.linalg.inv(gt(frames[ra][ka])) @ gt(frames[rb][kb]) @ noise
        _queue_loop(fleet.state, encode_kf(ra, ka), encode_kf(rb, kb), _pose(z), 0.5, fleet.cfg)
    poses = se3.Pose(fleet.state.opt_R.clone(), fleet.state.opt_t.clone())
    chi = fleet.optimize()
    g = fleet.state.graph
    single = solver.solve(g, chordal_rotation_init(g, poses), gn_iters=4, cg_iters=96,
                          coarse_stride=32)
    return dict(chi=chi, broken=fleet.broken_drains, breakdowns=list(fleet.solve_breakdowns),
                t=fleet.state.opt_t.numpy().copy(), edges=int(g.num_edges),
                counts=[int(c) for c in fleet.state.counts],
                single_chi=single.chi2_history.numpy(), single_code=int(single.breakdown))


def sharded_cfg() -> SlamConfig:
    """``tests/test_sharded_db.py::TestShardedMapper``'s configuration."""
    return SlamConfig(
        keyframe=KeyframeConfig(max_keyframes=32, points_per_keyframe=256,
                                raw_points_capacity=512, distance_threshold=0.5,
                                evict_keep_recent=4),
        loop=LoopConfig(near_keyframes=2, submap_capacity=512, queue_capacity=8,
                        icp_iterations=5),
        optimizer=OptimizerConfig(edge_capacity=128, gn_iters=2, cg_iters=8),
        scan_context=ScanContextParams(exclude_recent=2),
    )


def _db(arrays, desc_key="descriptors") -> base.DescriptorDB:
    return base.DescriptorDB(*(torch.from_numpy(np.array(arrays[k])) for k in
                               (desc_key, "keys", "robot", "index", "count")))


def _match(m):
    return {k: np.asarray(v) for k, v in m._asdict().items()}


def sharded_db_scenarios(rank, world, data):
    """``tests/test_sharded_db.py``'s scenarios on a DB sharded over the
    ranks, each beside the same on the whole DB (in this rank)."""
    mesh = multihost.make_mesh(("shard",))
    group = mesh.get_group("shard")
    out = {}
    cfg = sc.ScanContextConfig(exclude_recent=5, num_candidates=8)
    whole = _db(data["sc_db"])
    part = base.shard_db(whole, group)
    q = sc.from_db(whole, torch.tensor([37]))
    args = (torch.tensor(0), torch.tensor([200]), cfg)
    out["sc_query"] = (_match(sc.query(part, q, *args, mode="intra")),
                       _match(sc.query(whole, q, *args, mode="intra")))
    out["sc_inter"] = (_match(sc.query(part, q, torch.tensor(1), torch.tensor([0]), cfg, "inter")),
                       _match(sc.query(whole, q, torch.tensor(1), torch.tensor([0]), cfg, "inter")))
    out["rows_local"] = tuple(part.index.shape)

    vec = _db(data["vec_db"])
    vpart = base.shard_db(vec, group)
    desc = torch.from_numpy(data["vec_query"])
    kw = dict(num_candidates=5, exclude_recent=3, threshold=data["vec_threshold"], mode="intra")
    qi = torch.from_numpy(data["vec_query_index"])
    out["vec_query"] = (_match(geometric.vector_query(vpart, desc, 0, qi, **kw)),
                        _match(geometric.vector_query(vec, desc, 0, qi, **kw)))

    small = _db(data["sc_db_128"])
    spart = base.shard_db(small, group)
    d = sc.ScanContext(small.descriptors[3] + 1.0, small.keys[3] + 1.0,
                       small.descriptors[3].mean(0))
    for db in (spart, small):
        sc.insert(db, d, robot=1, index=0, pos=64)
    got = base.unshard_db(spart)
    out["insert"] = {k: (getattr(got, k).numpy(), getattr(small, k).numpy())
                     for k in ("descriptors", "keys", "robot", "index", "count")}

    scfg = sharded_cfg()
    plain, shard = Mapper(scfg, device="cpu"), Mapper(scfg, device="cpu")
    shard.shard_database(mesh)
    rng = np.random.RandomState(5)
    for k in range(40):   # 40 keyframes on a 32-slot block: eviction
        xyz = rng.uniform(-20, 20, (256, 3)).astype(np.float32)
        pose = se3.Pose(torch.eye(3), torch.tensor([2.0 * k, 0.0, 0.0]))
        for m in (plain, shard):
            m.add_frame(pose, xyz, stamp=float(k))
            m.spin_once(now=float(k))
    dbs = (shard.unsharded_state().desc_db, plain.state.desc_db)
    out["pipeline"] = dict(
        counts=(int(shard.state.counts[0]), int(plain.state.counts[0])),
        db={k: tuple(getattr(db, k).numpy() for db in dbs)
            for k in ("descriptors", "keys", "robot", "index", "count")},
        queue=tuple(int(m.state.loop_queue.count) for m in (shard, plain)),
        full=(shard.full_trajectory(0), plain.full_trajectory(0)),
        evicted=(len(shard._evicted.get(0, [])), len(plain._evicted.get(0, []))),
        still_sharded=base.shard_of(shard.state.desc_db) is not None,
        local_rows=tuple(shard.state.desc_db.index.shape),
    )

    # a checkpoint of the sharded mapper is the whole-DB file; it loads
    # into a whole-DB mapper and into a sharded one
    from scl_slam_tpu_torch.runtime import checkpoint

    path = data["ckpt_dir"] + f"/rank{rank}.npz"
    checkpoint.save(shard, path)
    back_plain, back_shard = Mapper(scfg, device="cpu"), Mapper(scfg, device="cpu")
    back_shard.shard_database(mesh)
    for m in (back_plain, back_shard):
        checkpoint.load(m, path)
    out["checkpoint"] = dict(
        plain=back_plain.state.desc_db.keys.numpy(),
        shard=back_shard.unsharded_state().desc_db.keys.numpy(),
        ref=plain.state.desc_db.keys.numpy(),
        still_sharded=base.shard_of(back_shard.state.desc_db) is not None,
    )
    return out


def sparse_fleet_drain(rank, world, root, frames, orders, device, slots):
    """A four-robot fleet at four_robot_cityscale.yaml's settings with
    ``slots`` keyframe slots a robot (4,096 in the file: each robot's 4-14
    poses in one supernode of the coarse level) on ``device``, driven
    ``frames`` frames of the synthetic sequence with the drain on the mesh,
    then drained from the same state with the graph's edges in ``orders``
    orders (0: as built; s: a permutation seeded by s), through
    ``optimize()`` and through the single-device ``solver.solve`` from the
    chordal start (``tests/test_torch_cuda.py``). Returns per order the
    mesh drain's chi2 history, broken drains, breakdowns and trajectory
    slots, and the single-device solve's chi2 history and breakdown code."""
    import dataclasses
    import os
    import types

    from scl_slam_tpu_torch import run_multi
    from scl_slam_tpu_torch.config import load_config
    from scl_slam_tpu_torch.graph import solver
    from scl_slam_tpu_torch.graph.rotation_init import chordal_rotation_init
    from scl_slam_tpu_torch.runtime import FleetMapper

    cfg = load_config(os.path.join(root, "configs", "four_robot_cityscale.yaml"))
    cfg = dataclasses.replace(cfg, keyframe=dataclasses.replace(cfg.keyframe, max_keyframes=slots))
    args = types.SimpleNamespace(dataset="synthetic", frames=frames, root=None)
    get_scan, get_pose, n = run_multi.build_dataset(args)
    splits = run_multi.make_splits(n, 4, 10)
    fleet = FleetMapper(cfg, device=device)
    fleet.attach_mesh(multihost.make_mesh(("shard",)))
    for step in range(max(len(s) for s in splits)):
        for r in range(4):
            if step < len(splits[r]):
                k = splits[r][step]
                fleet.add_robot_frame(r, run_multi.pose_of(get_pose(k)), get_scan(k),
                                      stamp=0.1 * k)
        fleet.step()
    snap = fleet.state
    ne = int(snap.graph.num_edges)
    out = []
    for s in range(orders):
        perm = np.arange(ne) if s == 0 else np.random.RandomState(s).permutation(ne)
        p = torch.from_numpy(perm).to(device)

        def permuted(a):
            a = a.clone()
            a[:ne] = a[:ne][p]
            return a

        g = snap.graph
        g = g._replace(i=permuted(g.i), j=permuted(g.j),
                       z=se3.Pose(permuted(g.z.R), permuted(g.z.t)),
                       sqrt_info=permuted(g.sqrt_info))
        fleet.state = snap._replace(graph=g)
        fleet.broken_drains, fleet.solve_breakdowns = 0, []
        chi = fleet.optimize()
        drained = fleet.state.graph
        poses = se3.Pose(snap.opt_R, snap.opt_t)
        single = solver.solve(drained, chordal_rotation_init(drained, poses), gn_iters=4,
                              cg_iters=cfg.optimizer.cg_iters, coarse_stride=32)
        out.append(dict(chi=chi, broken=fleet.broken_drains,
                        breakdowns=list(fleet.solve_breakdowns),
                        t=fleet.state.opt_t.cpu().numpy(), edges=int(drained.num_edges),
                        single_chi=single.chi2_history.cpu().numpy(),
                        single_code=int(single.breakdown)))
    return out
