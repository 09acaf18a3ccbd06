"""The SLAM orchestrator (port of ``scl_slam_tpu/runtime/mapper.py``):
the live single-robot path, the keyframe replay path, and the loop-queue
drain with the pose-graph solve.

Live, per keyframe (``Mapper.add_frame`` + ``Mapper.spin_once``):

0. storage downsample + Scan Context build (kernel K2 on CUDA) of the raw
   scan, and single-frame ingest into the fixed-capacity state;
1. intra retrieval for the new keyframe (``_retrieve_intra``);
2. on a descriptor hit (a host branch, where JAX has ``lax.cond``): submap
   gather and solo coarse-to-fine ICP (kernel K4 in every iteration);
3. fitness gate + loop-queue append (``_enqueue_intra``);
4. throttled by ``mapping_process_interval``: the queue drain into the
   factor graph and the pose-graph solve (``_drain_queue_and_optimize``:
   GN/PCG from the warm start and from a chordal rotation init, keeping
   the lower final chi2).

Replay, per macro-batch of B keyframes (``_batch_body``): the same steps
batched over frames, with batched ICP (kernel K1 in every iteration) and an
exclusive-cumsum queue append. ``Mapper.replay`` runs whole chunks of
batches through ``_replay_batches`` (a Python loop where JAX scans) and
hands the remainder to ``Mapper.add_frames``.

The state is updated in place (the JAX steps donate their state). What is
not ported yet raises ``NotImplementedError`` naming the ROADMAP item it
waits for: eviction, peers and the inter-robot path, PCM, the mesh solve,
the voxel storage modes, the C++ host-descriptor path and int16 transfer.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..config import SlamConfig
from ..descriptors import base, registry
from ..geometry import se3, so3
from ..graph import factors as F
from ..graph import solver
from ..graph.rotation_init import chordal_rotation_init
from ..ops import pointcloud as pc
from ..ops import registration as reg
from .state import LoopQueue, MapperState, to_numpy, make_state

# Loop-queue endpoints are encoded as robot * IDX_BASE + keyframe_index:
# protocol-stable per-robot indices, not slots (see the JAX module).
IDX_BASE = 1 << 22


def encode_kf(robot, index):
    return robot * IDX_BASE + index


def _resolve_indices(state: MapperState, enc: torch.Tensor):
    """Vectorized (robot, index) -> slot lookup over the descriptor DB.

    Returns (slot [Q] int32, -1 where absent; pending [Q] bool: absent but
    not ingested yet, i.e. the index is ahead of the robot's chain, so the
    entry stays queued rather than being dropped as evicted)."""
    db = state.desc_db
    robot = (enc // IDX_BASE).long()
    index = enc % IDX_BASE
    hits = (db.robot[None, :] == robot[:, None]) & (db.index[None, :] == index[:, None])
    found = hits.any(dim=1)
    first = hits.to(torch.int8).argmax(dim=1)   # first hit, as jnp.argmax
    slot = torch.where(found, first, -1).to(torch.int32)
    K = state.kf_xyz.shape[0] // state.counts.shape[0]
    count = state.counts[robot]
    last_slot = torch.clamp(robot * K + count - 1, min=0)
    last_index = torch.where(count > 0, db.index[last_slot], -1)
    pending = ~found & (index > last_index)
    return slot, pending


def _prepare_frame(xyz: torch.Tensor, mask: torch.Tensor, cfg: SlamConfig):
    """DB-independent per-frame work for frames [..., N, 3]: storage
    downsample + descriptor build. The descriptor is built from the RAW
    scan; only storage is downsampled."""
    cloud = pc.Cloud(xyz, mask)
    small = _prepare_cloud(cloud, cfg)
    descriptor = registry.get_family(cfg).make(cloud)
    return small, descriptor


def _prepare_cloud(cloud: pc.Cloud, cfg: SlamConfig) -> pc.Cloud:
    """Storage downsample (the ``"stride"`` mode, the default)."""
    mode = cfg.keyframe.storage_downsample
    if not cfg.keyframe.fast_voxel:
        mode = "voxel"  # back-compat alias
    if mode == "stride":
        return pc.stride_permute_downsample(
            cloud, cfg.keyframe.points_per_keyframe
        )
    raise NotImplementedError(
        f"storage_downsample={mode!r} is not ported yet "
        "(ROADMAP queue 1 item 12: voxel storage downsamplers)"
    )


def _scatter_rows_capped(arr, rows, pos_w, cap):
    """Batched row scatter with a scratch overflow row: rows whose
    ``pos_w == cap`` land on a throwaway pad row that the final slice
    drops (the capacity-safe append of the queue and graph)."""
    out = torch.cat([arr, arr.new_zeros((1,) + arr.shape[1:])])
    out[pos_w.long()] = rows.to(arr.dtype)
    return out[:cap]


def _ingest_prepared_block(
    state: MapperState,
    robot: int,
    poses: se3.Pose,        # [B] odometry-frame keyframe poses
    smalls: pc.Cloud,       # [B, P, 3] prepared storage clouds
    descriptors,            # [B]-batched descriptor
    stamps: torch.Tensor,   # [B]
    cfg: SlamConfig,
):
    """B-frame block ingestion, one slice write per state array, in place.

    Batch frames of one robot land in consecutive slots (the caller has
    checked capacity). The optimized pose of each new frame chains its
    odometry increment onto the previous frame's, with per-step
    orthonormalization — a host loop over B tiny composes.
    Returns (state, slots [B] int32, indices [B] int32).
    """
    K = cfg.keyframe.max_keyframes
    B = stamps.shape[0]
    dev = stamps.device
    pos0 = int(state.counts[robot])
    slot0 = robot * K + pos0
    ar = torch.arange(B, dtype=torch.int32, device=dev)
    slots = slot0 + ar
    prev_slot = max(slot0 - 1, robot * K)
    first = pos0 == 0
    # protocol keyframe indices continue from the last resident frame's
    idx0 = 0 if first else state.desc_db.index[prev_slot] + 1
    idxs = (idx0 + ar).to(torch.int32)

    # odometry increments: frame 0 chains off the last stored odometry pose
    prev_R = torch.cat([state.odom_R[prev_slot][None], poses.R[:-1]])
    prev_t = torch.cat([state.odom_t[prev_slot][None], poses.t[:-1]])
    incs = se3.between(se3.Pose(prev_R, prev_t), poses)

    cR, ct = state.opt_R[prev_slot], state.opt_t[prev_slot]
    opt_R, opt_t = [], []
    for k in range(B):
        if first and k == 0:
            cR, ct = so3.orthonormalize(poses.R[0]), poses.t[0]
        else:
            comp = se3.compose(se3.Pose(cR, ct), se3.Pose(incs.R[k], incs.t[k]))
            cR, ct = so3.orthonormalize(comp.R), comp.t
        opt_R.append(cR)
        opt_t.append(ct)

    # factor graph: a prior on the robot's very first frame, else a
    # between factor slot_{k-1} -> slot_k per frame; overflow rows go to
    # the scratch row (no-op-when-full)
    g = state.graph
    if first:
        prior_si = [1.0 / s for s in cfg.optimizer.prior_sigmas]
        F.add_prior(g, slot0, se3.Pose(poses.R[0], poses.t[0]), prior_si)
    odom_si = torch.tensor(
        [1.0 / s for s in cfg.optimizer.odometry_sigmas],
        dtype=torch.float32, device=dev,
    )
    E = g.edge_capacity
    shift = int(first)
    edge_pos = g.num_edges + ar - shift
    row_ok = (ar >= shift) & (edge_pos < E)
    pos_w = torch.where(row_ok, edge_pos, E)

    def scatter_rows(arr, rows):
        return _scatter_rows_capped(arr, rows, pos_w, E)

    g = g._replace(
        i=scatter_rows(g.i, slots - 1),
        j=scatter_rows(g.j, slots),
        z=se3.Pose(scatter_rows(g.z.R, incs.R), scatter_rows(g.z.t, incs.t)),
        sqrt_info=scatter_rows(g.sqrt_info, odom_si.expand(B, 6)),
        num_edges=g.num_edges + row_ok.sum().to(torch.int32),
    )

    full, key = registry.get_family(cfg).parts(descriptors)
    base.db_insert_block(state.desc_db, full, key, robot, idxs, slot0)

    rows = slice(slot0, slot0 + B)
    state.kf_xyz[rows] = smalls.xyz.reshape(B, -1)
    state.kf_mask[rows] = smalls.mask
    state.odom_R[rows] = poses.R
    state.odom_t[rows] = poses.t
    state.opt_R[rows] = torch.stack(opt_R)
    state.opt_t[rows] = torch.stack(opt_t)
    state.stamps[rows] = stamps
    state.counts[robot] += B
    return state._replace(graph=g), slots, idxs


def _gather_submap(
    state: MapperState, center_slots, robot: int, cfg: SlamConfig, count
):
    """±near_keyframes submap around each of B slots, in the map frame.

    Gathers 2*near+1 clouds per lane (clipped to the robot's chain as it
    stood at ``count`` keyframes), transforms each by its optimized pose,
    and keeps a per-cloud prefix sized to fill ``submap_capacity`` (stored
    clouds are scramble-ordered, so a prefix is a uniform subsample). A
    plain index gather: the JAX one-hot matmul was a TPU workaround. The
    pad to ``submap_capacity`` is kept so shapes match the JAX outputs.
    """
    K = cfg.keyframe.max_keyframes
    near = cfg.loop.near_keyframes
    dev = state.kf_xyz.device
    lo = robot * K
    offs = torch.arange(-near, near + 1, device=dev)
    hi = lo + torch.clamp(count - 1, min=0)
    slots = torch.minimum(
        torch.clamp(center_slots.long()[:, None] + offs[None], min=lo),
        hi.long()[:, None],
    )                                                        # [B, W]
    B, W = slots.shape
    per = max(1, cfg.loop.submap_capacity // W)
    pts = state.kf_xyz[:, : per * 3][slots].reshape(B, W, per, 3)
    xs, ys, zs = pts[..., 0], pts[..., 1], pts[..., 2]
    mask = state.kf_mask[:, :per][slots]                     # [B, W, per]
    R9 = state.opt_R[slots]                                  # [B, W, 3, 3]
    t3 = state.opt_t[slots]                                  # [B, W, 3]

    # per-coordinate transform, the same arithmetic order as the JAX one
    def row(i):
        return (
            R9[..., i, 0, None] * xs
            + R9[..., i, 1, None] * ys
            + R9[..., i, 2, None] * zs
            + t3[..., i, None]
        )

    flat = torch.stack([row(0), row(1), row(2)], dim=-1).reshape(B, W * per, 3)
    flat_mask = mask.reshape(B, W * per)
    pad = cfg.loop.submap_capacity - W * per
    if pad > 0:
        flat = torch.cat([flat, flat.new_full((B, pad, 3), pc.PAD_VALUE)], dim=1)
        flat_mask = torch.cat([flat_mask, flat_mask.new_zeros((B, pad))], dim=1)
    return pc.Cloud(torch.where(flat_mask[..., None], flat, pc.PAD_VALUE), flat_mask)


def _yaw_seed_pose(pose: se3.Pose, yaw: torch.Tensor) -> se3.Pose:
    """Yaw-initialized ICP start: the current orientation rotated by the
    Scan Context shift estimate, R Rz(yaw)."""
    zero = torch.zeros_like(yaw)
    Ryaw = so3.from_euler(torch.stack([zero, zero, yaw], dim=-1))
    return se3.Pose(pose.R @ Ryaw, pose.t)


def _intra_verify_inputs(
    state: MapperState, slots, match_slots, yaws, robot: int, cfg: SlamConfig,
    count,
):
    """ICP inputs for B intra-loop verifications: (current keyframe cloud
    prefix, ±near submap target, yaw-seeded start pose). ``count`` [B] is
    each frame's keyframe count at its sequential detection time."""
    n_src = min(cfg.loop.icp_source_points, cfg.keyframe.points_per_keyframe)
    sl = slots.long()
    cur_cloud = pc.Cloud(
        state.kf_xyz[sl, : n_src * 3].reshape(-1, n_src, 3),
        state.kf_mask[sl, :n_src],
    )
    target = _gather_submap(state, match_slots, robot, cfg, count)
    cur_pose = se3.Pose(state.opt_R[sl], state.opt_t[sl])
    return cur_cloud, target, _yaw_seed_pose(cur_pose, yaws)


def _enqueue_intra_block(
    state: MapperState, robot: int, slots, match_slots, q_idxs, match_indices,
    fits, attempts, corr_R, corr_t, cfg: SlamConfig,
):
    """Fitness gate + loop-factor append for B frames. Frame k's queue
    position is count0 plus the accepted batch-mates before it (an
    exclusive cumsum, capacity-checked per row). Returns (state, oks)."""
    oks = attempts & (fits < cfg.loop.history_fitness_score)
    ms = match_slots.long()
    pre = se3.Pose(state.opt_R[ms], state.opt_t[ms])
    z = se3.between(pre, se3.Pose(corr_R, corr_t))

    q = state.loop_queue
    Q = q.i.shape[0]
    ok_i = oks.to(torch.int32)
    qpos = q.count + torch.cumsum(ok_i, 0, dtype=torch.int32) - ok_i
    qoks = oks & (qpos < Q)
    pos_w = torch.where(qoks, qpos, Q)

    def scatter_rows(arr, rows):
        return _scatter_rows_capped(arr, rows, pos_w, Q)

    new_q = LoopQueue(
        i=scatter_rows(q.i, encode_kf(robot, match_indices)),
        j=scatter_rows(q.j, encode_kf(robot, q_idxs)),
        z_R=scatter_rows(q.z_R, z.R),
        z_t=scatter_rows(q.z_t, z.t),
        noise=scatter_rows(q.noise, torch.clamp(fits, min=1e-3)),
        count=q.count + qoks.sum().to(torch.int32),
    )
    sl = slots.long()
    state.loop_target[sl] = torch.where(qoks, match_slots, state.loop_target[sl])
    state = state._replace(
        loop_queue=new_q, loop_closed=state.loop_closed | qoks.any()
    )
    return state, oks


def _ingest_prepared(
    state: MapperState, robot: int, pose: se3.Pose, small: pc.Cloud,
    descriptor, stamp: torch.Tensor, cfg: SlamConfig,
):
    """Single-frame, DB-dependent half of ingestion: store the keyframe,
    chain its optimized pose, add the prior (first frame) or the odometry
    between factor, insert the prepared descriptor. The one-frame case of
    :func:`_ingest_prepared_block`. Returns (state, wire descriptor)."""
    one = lambda x: x[None]  # noqa: E731
    state, _, _ = _ingest_prepared_block(
        state, robot, se3.Pose(one(pose.R), one(pose.t)),
        pc.Cloud(one(small.xyz), one(small.mask)),
        type(descriptor)(*map(one, descriptor)), stamp.reshape(1), cfg,
    )
    return state, registry.get_family(cfg).to_wire(descriptor)


def _ingest(
    state: MapperState, robot: int, pose: se3.Pose, xyz: torch.Tensor,
    mask: torch.Tensor, stamp: torch.Tensor, cfg: SlamConfig,
):
    """Full single-frame ingestion of a raw scan xyz [N, 3] / mask [N]:
    :func:`_prepare_frame` + :func:`_ingest_prepared`."""
    smalls, descriptors = _prepare_frame(xyz[None], mask[None], cfg)
    small = pc.Cloud(smalls.xyz[0], smalls.mask[0])
    descriptor = type(descriptors)(*(d[0] for d in descriptors))
    return _ingest_prepared(state, robot, pose, small, descriptor, stamp, cfg)


def _retrieve_intra(state: MapperState, robot: int, cfg: SlamConfig):
    """Descriptor retrieval and attempt decision for the latest keyframe.
    Returns (slot, q_idx, match, attempt, match_slot): ``match`` is a
    one-row batched :class:`base.Match`, the others 0-d tensors."""
    K = cfg.keyframe.max_keyframes
    fam = registry.get_family(cfg)
    pos = int(state.counts[robot]) - 1
    slot = robot * K + max(pos, 0)
    slots = torch.tensor([slot], device=state.kf_xyz.device)
    q_idx = state.desc_db.index[slots]            # protocol index [1]
    match = fam.query(state.desc_db, fam.from_db(state.desc_db, slots), robot, q_idx, "intra")
    already = state.loop_target[slot] >= 0
    attempt = match.found[0] & ~already & (pos >= 0)
    match_slot = torch.where(attempt, match.db_pos[0], slot).to(torch.int32)
    return slots[0], q_idx[0], match, attempt, match_slot


def _enqueue_intra(
    state: MapperState, robot: int, slot, match_slot, q_idx, match_index,
    fitness, attempt, corr_R, corr_t, cfg: SlamConfig,
):
    """Fitness gate + loop-factor enqueue + dedup bookkeeping for one
    keyframe: the one-frame case of :func:`_enqueue_intra_block` (its queue
    position is the count; a full queue drops the factor). Returns
    (state, ok)."""
    one = lambda x: torch.as_tensor(x)[None]  # noqa: E731
    state, oks = _enqueue_intra_block(
        state, robot, one(slot), one(match_slot), one(q_idx), one(match_index),
        one(fitness), one(attempt), one(corr_R), one(corr_t), cfg,
    )
    return state, oks[0]


def _detect_intra(state: MapperState, robot: int, cfg: SlamConfig):
    """One intra-robot loop-closure attempt for the latest keyframe:
    descriptor query, then (on a hit: a host branch) yaw-seeded submap ICP,
    fitness gate, loop factor queued. Returns (state, ok, match, fitness,
    attempt); ``match`` holds the one query's fields as 0-d tensors."""
    slot, q_idx, match, attempt, match_slot = _retrieve_intra(state, robot, cfg)
    match = base.Match(*(f[0] for f in match))
    dtype, dev = state.opt_t.dtype, state.opt_t.device
    if bool(attempt):
        count = state.counts[robot].reshape(1)
        cur_clouds, targets, inits = _intra_verify_inputs(
            state, slot.reshape(1), match_slot.reshape(1), match.yaw.reshape(1),
            robot, cfg, count,
        )
        init = se3.Pose(inits.R[0], inits.t[0])
        source_world = pc.transform(
            pc.Cloud(cur_clouds.xyz[0], cur_clouds.mask[0]), init.R, init.t
        )
        res = reg.icp(
            source_world,
            pc.Cloud(targets.xyz[0], targets.mask[0]),
            max_iters=cfg.loop.icp_iterations,
            max_corr_dist=cfg.loop.icp_max_corr_dist,
            tol=cfg.loop.icp_tol,
            coarse_factor=cfg.loop.icp_coarse_factor,
            gate_fitness=cfg.loop.history_fitness_score,
            target_stride=cfg.loop.icp_target_stride,
            reuse_final_fitness=cfg.loop.icp_reuse_final_fitness,
        )
        corrected = se3.compose(res.pose, init)
        fitness, corr_R, corr_t = res.fitness.to(dtype), corrected.R, corrected.t
    else:
        fitness = torch.tensor(float("inf"), dtype=dtype, device=dev)
        corr_R = torch.eye(3, dtype=dtype, device=dev)
        corr_t = torch.zeros(3, dtype=dtype, device=dev)
    state, ok = _enqueue_intra(
        state, robot, slot, match_slot, q_idx, match.index, fitness, attempt,
        corr_R, corr_t, cfg,
    )
    return state, ok, match, fitness, attempt


def _ingest_and_detect(
    state: MapperState, robot: int, pose: se3.Pose, xyz: torch.Tensor,
    mask: torch.Tensor, stamp: torch.Tensor, cfg: SlamConfig,
):
    """Keyframe step: ingest, then intra-loop detection on it. Returns
    (state, wire, ok, match, fitness, attempt)."""
    state, wire = _ingest(state, robot, pose, xyz, mask, stamp, cfg)
    state, ok, match, fitness, attempt = _detect_intra(state, robot, cfg)
    return state, wire, ok, match, fitness, attempt


def _drain_queue(state: MapperState, cfg: SlamConfig):
    """Move queued loops into the factor graph (in place).

    Loop factors get diagonal noise from the ICP fitness taken as a
    variance, times ``loop_noise_scale``; entries whose endpoints are not
    ingested yet stay queued (moved to the front, in order); entries whose
    endpoints were evicted are dropped. The JAX ``fori_loop`` of masked
    appends is one append in row order (an exclusive cumsum of the ready
    rows), which gives the same edge rows. Returns (graph, n_new [0-d],
    compacted queue).
    """
    if cfg.optimizer.use_pcm:
        raise NotImplementedError(
            "use_pcm=True needs PCM outlier rejection, which is not ported "
            "yet (ROADMAP queue 1 item 15: graph/pcm.py)"
        )
    q = state.loop_queue
    Q = q.i.shape[0]
    in_queue = torch.arange(Q, device=q.i.device) < q.count
    slots_i, pend_i = _resolve_indices(state, q.i)
    slots_j, pend_j = _resolve_indices(state, q.j)
    ready = in_queue & (slots_i >= 0) & (slots_j >= 0)
    deferred = in_queue & ~ready & (pend_i | pend_j)
    var = torch.clamp(q.noise * cfg.optimizer.loop_noise_scale, min=1e-6)
    sq = 1.0 / torch.sqrt(var)
    graph = F.add_between_block(
        state.graph, torch.clamp(slots_i, min=0), torch.clamp(slots_j, min=0),
        se3.Pose(q.z_R, q.z_t), sq[:, None].expand(Q, 6), valid=ready,
    )
    n_new = ready.sum()
    # deferred entries first, in their order (a stable sort on ~deferred)
    order = torch.sort((~deferred).to(torch.int8), stable=True).indices
    new_queue = LoopQueue(
        i=q.i[order], j=q.j[order], z_R=q.z_R[order], z_t=q.z_t[order],
        noise=q.noise[order], count=deferred.sum().to(torch.int32),
    )
    return graph, n_new, new_queue


def _drain_queue_and_optimize(state: MapperState, cfg: SlamConfig):
    """Drain the loop queue into the factor graph, then solve (one device).

    Solves only when the drain added loop factors (a host branch). GN runs
    from two starts, the current estimate and a chordal rotation init, and
    the lower final chi2 wins. Returns (state, chi2_history
    [gn_iters + 1]; zeros when nothing was solved).
    """
    graph, n_new, new_queue = _drain_queue(state, cfg)
    poses = se3.Pose(state.opt_R, state.opt_t)
    o = cfg.optimizer
    if int(n_new) > 0:

        def run(init):
            r = solver.solve(
                graph, init, gn_iters=o.gn_iters, cg_iters=o.cg_iters,
                damping=o.damping, huber_delta=o.huber_delta,
                coarse_stride=o.coarse_stride, coarse_levels=o.coarse_levels,
            )
            return r.poses, r.chi2_history

        warm_poses, warm_chi = run(poses)
        staged_poses, staged_chi = run(chordal_rotation_init(graph, poses))
        use_staged = staged_chi[-1] < warm_chi[-1]
        opt_R = torch.where(use_staged, staged_poses.R, warm_poses.R)
        opt_t = torch.where(use_staged, staged_poses.t, warm_poses.t)
        chi2_history = torch.where(use_staged, staged_chi, warm_chi)
    else:
        opt_R, opt_t = poses.R, poses.t
        chi2_history = poses.t.new_zeros((o.gn_iters + 1,))
    state = state._replace(
        graph=graph,
        opt_R=opt_R,
        opt_t=opt_t,
        loop_queue=new_queue,
        loop_closed=torch.zeros_like(state.loop_closed),
    )
    return state, chi2_history


def _batch_body(
    state: MapperState,
    robot: int,
    poses: se3.Pose,        # [B]
    xyz: torch.Tensor,      # [B, N, 3]
    mask: torch.Tensor,     # [B, N]
    stamps: torch.Tensor,   # [B]
    cfg: SlamConfig,
):
    """One macro-batch of B keyframes (phases 0-3 in the module note).
    Returns (state, oks [B], match_indices [B], fitnesses [B])."""
    smalls, descriptors = _prepare_frame(xyz, mask, cfg)
    return _batch_body_prepared(
        state, robot, poses, smalls, descriptors, stamps, cfg
    )


def _batch_body_prepared(
    state: MapperState, robot: int, poses: se3.Pose, smalls, descriptors,
    stamps: torch.Tensor, cfg: SlamConfig,
):
    """Phases 1-3 of :func:`_batch_body` on prepared per-frame inputs.

    Retrieval against the post-insert DB equals sequential per-frame
    retrieval: the intra candidate mask is one-sided in the protocol
    index, so later batch-mates are always masked out.
    """
    B = stamps.shape[0]
    dev = stamps.device
    count0 = int(state.counts[robot])
    state, slots, q_idxs = _ingest_prepared_block(
        state, robot, poses, smalls, descriptors, stamps, cfg
    )
    match = registry.get_family(cfg).query(
        state.desc_db, descriptors, robot, q_idxs, "intra"
    )
    already = state.loop_target[slots.long()] >= 0
    attempts = match.found & ~already
    match_slots = torch.where(attempts, match.db_pos, slots)

    counts_hist = count0 + 1 + torch.arange(B, dtype=torch.int32, device=dev)
    cur_clouds, targets, inits = _intra_verify_inputs(
        state, slots, match_slots, match.yaw, robot, cfg, counts_hist
    )
    if bool(attempts.any()):
        src_world = pc.transform(cur_clouds, inits.R, inits.t)
        res = reg.icp_batched(
            src_world,
            targets,
            se3.identity((B,), dtype=state.opt_t.dtype, device=dev),
            attempts,
            max_iters=cfg.loop.icp_iterations,
            max_corr_dist=cfg.loop.icp_max_corr_dist,
            tol=cfg.loop.icp_tol,
            coarse_factor=cfg.loop.icp_coarse_factor,
            gate_fitness=cfg.loop.history_fitness_score,
            target_stride=cfg.loop.icp_target_stride,
            reuse_final_fitness=cfg.loop.icp_reuse_final_fitness,
        )
        corrected = se3.compose(res.pose, inits)
        fits, corr_R, corr_t = res.fitness, corrected.R, corrected.t
    else:
        fits = torch.full((B,), float("inf"), dtype=state.opt_t.dtype, device=dev)
        corr_R, corr_t = inits.R, inits.t

    state, oks = _enqueue_intra_block(
        state, robot, slots, match_slots, q_idxs, match.index, fits, attempts,
        corr_R, corr_t, cfg,
    )
    return state, oks, match.index, fits


def _replay_batches(
    state: MapperState,
    robot: int,
    poses: se3.Pose,        # leaves [R, B, ...]
    xyz: torch.Tensor,      # [R, B, N, 3]
    mask: torch.Tensor,     # [R, B, N]
    stamps: torch.Tensor,   # [R, B]
    cfg: SlamConfig,
):
    """R macro-batches in order (the JAX package scans them in one device
    program). Returns (state, oks [R*B], match_indices [R*B],
    fitnesses [R*B])."""
    oks, idxs, fits = [], [], []
    for r in range(xyz.shape[0]):
        state, ok, idx, fit = _batch_body(
            state, robot, se3.Pose(poses.R[r], poses.t[r]), xyz[r], mask[r],
            stamps[r], cfg,
        )
        oks.append(ok)
        idxs.append(idx)
        fits.append(fit)
    return state, torch.cat(oks), torch.cat(idxs), torch.cat(fits)


class Mapper:
    """Host-side shell for one robot's SLAM session on ``device``.

    Holds a :class:`MapperState` and applies the transitions above: the
    live path (:meth:`add_frame`, :meth:`spin_once`, :meth:`optimize`), the
    replay path (:meth:`add_frames`, :meth:`replay`) and the exports. The
    entry point runs on the card: ``device`` defaults to ``"cuda"`` and
    the constructor raises where there is none, unless the caller asks for
    ``device="cpu"`` (where every kernel takes its plain version). Peers,
    the inter-robot path and eviction are not ported yet (ROADMAP queue 1).
    """

    def __init__(self, cfg: SlamConfig, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Mapper runs on the GPU by default and torch.cuda.is_available() "
                "is false; pass device='cpu' to run on the CPU"
            )
        self.cfg = cfg
        self.state = make_state(cfg, self.device)
        self.robot = cfg.robot_id
        self._last_kf_pose: se3.Pose | None = None
        self._keyframes = 0
        self._last_opt_time = float("-inf")
        self._pending_intra = None
        self._pending_intra_valid = False
        self.icp_attempts = 0  # live-path ICP verifications run so far

    # -- keyframe gate (reference saveFrame, distributedMapping.h:755-780) --
    def should_add_keyframe(self, pose) -> bool:
        if self._last_kf_pose is None:
            return True
        R0, t0 = to_numpy(self._last_kf_pose.R), to_numpy(self._last_kf_pose.t)
        R1, t1 = to_numpy(pose.R), to_numpy(pose.t)
        dist = float(np.linalg.norm(t1 - t0))
        cos_ang = (np.trace(R0.T @ R1) - 1.0) * 0.5
        ang = float(np.arccos(np.clip(cos_ang, -1.0, 1.0)))
        return (
            dist >= self.cfg.keyframe.distance_threshold
            or ang >= self.cfg.keyframe.angle_threshold
        )

    def _gate(self, poses, n: int, apply_gate: bool) -> tuple[list, list]:
        accepted, sel = [], []
        for i in range(n):
            take = (not apply_gate) or self.should_add_keyframe(poses[i])
            accepted.append(take)
            if take:
                self._last_kf_pose = poses[i]
                sel.append(i)
        return accepted, sel

    def _stage(self, poses, scans, stamps, idx):
        """Padded host staging of the frames ``idx`` (stride-subsampled
        to capacity, as ``pc.from_points``), moved to the device."""
        cap = self.cfg.keyframe.raw_points_capacity
        n = len(idx)
        xyz_np = np.full((n, cap, 3), pc.PAD_VALUE, np.float32)
        mask_np = np.zeros((n, cap), bool)
        for j, i in enumerate(idx):
            s = pc.fit_capacity(np.asarray(scans[i], np.float32), cap)
            xyz_np[j, : s.shape[0]] = s
            mask_np[j, : s.shape[0]] = True
        R = np.stack([to_numpy(poses[i].R) for i in idx]).astype(np.float32)
        t = np.stack([to_numpy(poses[i].t) for i in idx]).astype(np.float32)
        st = np.asarray([stamps[i] for i in idx], np.float32)
        dev = self.device
        return (
            se3.Pose(torch.from_numpy(R).to(dev), torch.from_numpy(t).to(dev)),
            torch.from_numpy(xyz_np).to(dev),
            torch.from_numpy(mask_np).to(dev),
            torch.from_numpy(st).to(dev),
        )

    def _record(self, oks, idxs, fits) -> list:
        oks_h, idxs_h, fits_h = to_numpy(oks), to_numpy(idxs), to_numpy(fits)
        loops = [
            {"matched_index": int(idxs_h[b]), "fitness": float(fits_h[b])}
            if bool(oks_h[b])
            else None
            for b in range(len(oks_h))
        ]
        self._keyframes += len(loops)
        # hand the last frame's result to detect_intra_loop, so that a
        # following spin_once does not detect again on a keyframe the batch
        # already handled
        self._pending_intra = loops[-1] if loops else None
        self._pending_intra_valid = bool(loops)
        return loops

    def add_frames(self, poses, scans, stamps=None, apply_gate: bool = True) -> dict:
        """Macro-batched ingestion of many odometry frames as ONE batch
        (the keyframe gate runs host-side per frame; ``apply_gate=False``
        takes every frame). Returns ``{"accepted": [bool per frame],
        "loops": [dict | None per accepted frame], "keyframes": total}``.
        """
        n = len(scans)
        if stamps is None:
            stamps = [0.0] * n
        accepted, sel = self._gate(poses, n, apply_gate)
        if not sel:
            return {"accepted": accepted, "loops": [], "keyframes": self._keyframes}
        self._ensure_capacity(len(sel))
        self._ensure_queue_headroom(len(sel))
        pose_b, xyz, mask, st = self._stage(poses, scans, stamps, sel)
        self.state, oks, idxs, fits = _batch_body(
            self.state, self.robot, pose_b, xyz, mask, st, self.cfg
        )
        loops = self._record(oks, idxs, fits)
        return {"accepted": accepted, "loops": loops, "keyframes": self._keyframes}

    def _ensure_queue_headroom(self, k: int) -> None:
        """Drain the loop queue (and solve) when the next ``k`` frames could
        overflow it: a k-frame batch can enqueue up to k loop factors, and
        an append to a full queue drops the factor."""
        if int(self.state.loop_queue.count) + k > self.cfg.loop.queue_capacity:
            self.optimize()

    def _ensure_capacity(self, k: int) -> None:
        """The JAX mapper evicts keyframes until ``k`` more fit the
        robot's block; eviction is not ported yet."""
        K = self.cfg.keyframe.max_keyframes
        if k > K:
            raise ValueError(f"batch of {k} keyframes exceeds capacity {K}")
        if int(self.state.counts[self.robot]) + k > K:
            raise NotImplementedError(
                "the keyframe block is full and needs eviction "
                "(ROADMAP queue 1 item 9: eviction)"
            )

    def replay(
        self,
        poses,
        scans,
        stamps=None,
        apply_gate: bool = True,
        batch: int = 32,
        chunk_batches: int = 8,
        host_descriptors: bool = False,
        transfer: str = "f32",
    ) -> dict:
        """Whole-dataset replay: accepted keyframes go ``batch *
        chunk_batches`` at a time through :func:`_replay_batches`; the
        remainder goes through :meth:`add_frames`. Same return contract as
        :meth:`add_frames`.

        ``poses``: sequence of poses with ``.R`` [3, 3] / ``.t`` [3]
        (tensors or arrays); ``scans``: sequence of [Ni, 3] arrays.
        ``host_descriptors=True`` and ``transfer="int16"`` are JAX-package
        workarounds for a TPU host link and are not carried.
        """
        if transfer not in ("f32", "int16"):
            raise ValueError(f"unknown transfer mode {transfer!r}")
        if host_descriptors or transfer == "int16":
            raise NotImplementedError(
                "host_descriptors and transfer='int16' are not carried by "
                "the port (ROADMAP queue 1, 'Not carried')"
            )
        n = len(scans)
        if stamps is None:
            stamps = [0.0] * n
        accepted, sel = self._gate(poses, n, apply_gate)
        if not sel:
            return {"accepted": accepted, "loops": [], "keyframes": self._keyframes}
        B, R = batch, chunk_batches
        chunk = B * R
        loops: list = []
        pos = 0
        while len(sel) - pos >= chunk:
            idx = sel[pos : pos + chunk]
            self._ensure_capacity(chunk)
            self._ensure_queue_headroom(chunk)
            pose_b, xyz, mask, st = self._stage(poses, scans, stamps, idx)
            self.state, oks, idxs, fits = _replay_batches(
                self.state,
                self.robot,
                se3.Pose(pose_b.R.reshape(R, B, 3, 3), pose_b.t.reshape(R, B, 3)),
                xyz.reshape(R, B, *xyz.shape[1:]),
                mask.reshape(R, B, -1),
                st.reshape(R, B),
                self.cfg,
            )
            loops.extend(self._record(oks, idxs, fits))
            pos += chunk
        if pos < len(sel):
            rem = sel[pos:]
            out = self.add_frames(
                [poses[i] for i in rem],
                [scans[i] for i in rem],
                [stamps[i] for i in rem],
                apply_gate=False,
            )
            loops.extend(out["loops"])
        return {"accepted": accepted, "loops": loops, "keyframes": self._keyframes}

    # -- the live path --
    def add_frame(self, pose, xyz, stamp: float = 0.0) -> np.ndarray | None:
        """Process one odometry frame (``pose`` with ``.R`` [3, 3] / ``.t``
        [3], tensors or arrays; ``xyz`` [N, 3]). Returns the wire descriptor
        when the frame became a keyframe, else None. When intra detection is
        due for the keyframe, it runs right after the ingest and
        :meth:`spin_once` consumes the stored result."""
        self._drain_server_loops()
        if not self.should_add_keyframe(pose):
            return None
        self._last_kf_pose = pose
        self._ensure_capacity(1)
        pose_b, xyz_b, mask_b, st = self._stage([pose], [xyz], [stamp], [0])
        args = (
            self.state, self.robot, se3.Pose(pose_b.R[0], pose_b.t[0]),
            xyz_b[0], mask_b[0], st[0], self.cfg,
        )
        detection_due = (
            self.cfg.loop.intra_enabled
            and self._keyframes + 1 > registry.exclude_recent(self.cfg) + 1
        )
        if detection_due:
            self.state, wire, ok, match, fitness, attempt = _ingest_and_detect(*args)
            self.icp_attempts += int(attempt)
            self._pending_intra = (
                {
                    "matched_index": int(match.index),
                    "distance": float(match.distance),
                    "fitness": float(fitness),
                    "yaw": float(match.yaw),
                }
                if bool(ok)
                else None
            )
            self._pending_intra_valid = True
        else:
            self.state, wire = _ingest(*args)
            self._pending_intra = None
            self._pending_intra_valid = False
        self._keyframes += 1
        return to_numpy(wire)

    def detect_intra_loop(self) -> dict | None:
        """Try closing a loop on the latest own keyframe (or hand over the
        result that :meth:`add_frame` already produced for it)."""
        if not self.cfg.loop.intra_enabled or self._keyframes < 2:
            return None
        if self._pending_intra_valid:
            self._pending_intra_valid = False
            out, self._pending_intra = self._pending_intra, None
            return out
        # nothing can match while every DB entry is inside the recent-
        # exclusion window
        if self._keyframes <= registry.exclude_recent(self.cfg) + 1:
            return None
        self.state, ok, match, fitness, attempt = _detect_intra(
            self.state, self.robot, self.cfg
        )
        self.icp_attempts += int(attempt)
        if bool(ok):
            return {
                "matched_index": int(match.index),
                "distance": float(match.distance),
                "fitness": float(fitness),
                "yaw": float(match.yaw),
            }
        return None

    def optimize(self) -> np.ndarray:
        """Drain the loop queue and run the pose-graph solve. Returns the
        chi2 history (zeros when no loop factor was added)."""
        self._drain_server_loops()
        self.state, chi2_hist = _drain_queue_and_optimize(self.state, self.cfg)
        return to_numpy(chi2_hist)

    def attach_mesh(self, mesh, axis: str = "shard") -> None:
        raise NotImplementedError(
            "the mesh-attached distributed solve is not ported yet "
            "(ROADMAP queue 1 item 17: distributed)"
        )

    def attach_bus(self, bus) -> None:
        raise NotImplementedError(
            "peers and the transport bus are not ported yet "
            "(ROADMAP queue 1 item 13: inter-robot)"
        )

    def detect_inter_loop(self) -> dict | None:
        """Inter-robot detection needs a bus (:meth:`attach_bus`); with none
        attached there is nothing to query, as in the JAX package."""
        return None

    def _drain_server_loops(self) -> None:
        """Factors verified for peers wait here in the JAX package; with no
        bus there are none."""

    def spin_once(self, now: float | None = None) -> dict:
        """One loop-thread iteration: intra detection, then the drain and
        solve when a loop closed and ``mapping_process_interval`` seconds
        have passed since the last one (``now`` drives that throttle from a
        simulated clock; default ``time.monotonic()``)."""
        self._drain_server_loops()
        info = {"loop": self.detect_intra_loop()}
        inter = self.detect_inter_loop()
        if inter:
            info["inter_loop"] = inter
        now = time.monotonic() if now is None else now
        due = (now - self._last_opt_time) >= self.cfg.optimizer.mapping_process_interval
        if bool(self.state.loop_closed) and due:
            info["chi2"] = self.optimize()
            self._last_opt_time = now
        return info

    # -- outputs --
    def trajectory(self, robot: int | None = None) -> np.ndarray:
        """Optimized keyframe poses [N, 4, 4] for a robot (own by default)."""
        return self._traj_from(self.state, robot)

    def _traj_from(self, st: MapperState, robot: int | None = None) -> np.ndarray:
        robot = self.robot if robot is None else robot
        K = self.cfg.keyframe.max_keyframes
        n = int(st.counts[robot])
        out = np.tile(np.eye(4), (n, 1, 1))
        out[:, :3, :3] = to_numpy(st.opt_R[robot * K : robot * K + n])
        out[:, :3, 3] = to_numpy(st.opt_t[robot * K : robot * K + n])
        return out

    def trajectory_with_stamps(self, robot: int | None = None):
        """(poses [N, 4, 4], stamps [N]) from one state snapshot."""
        st = self.state
        robot = self.robot if robot is None else robot
        K = self.cfg.keyframe.max_keyframes
        n = int(st.counts[robot])
        return self._traj_from(st, robot), to_numpy(st.stamps[robot * K : robot * K + n])

    def keyframe_stamps(self, robot: int | None = None) -> np.ndarray:
        return self.trajectory_with_stamps(robot)[1]

    def full_trajectory(self, robot: int | None = None):
        """(poses [N, 4, 4], stamps [N]) in keyframe-index order. Without
        eviction (not ported yet) every keyframe is resident."""
        robot = self.robot if robot is None else robot
        K = self.cfg.keyframe.max_keyframes
        n = int(self.state.counts[robot])
        idx = to_numpy(self.state.desc_db.index[robot * K : robot * K + n])
        poses, stamps = self.trajectory_with_stamps(robot)
        order = np.argsort(idx, kind="stable")
        return poses[order], stamps[order]

    def save_trajectories(self, directory: str):
        """TUM + KITTI export for every robot with keyframes."""
        from ..io import trajectory as tio

        os.makedirs(directory, exist_ok=True)
        for r in range(self.cfg.number_of_robots):
            if int(self.state.counts[r]) == 0:
                continue
            poses, stamps = self.full_trajectory(r)
            name = chr(ord("a") + r)
            tio.save_tum(os.path.join(directory, f"{name}_tum.txt"), poses, stamps)
            tio.save_kitti(os.path.join(directory, f"{name}_kitti.txt"), poses)
