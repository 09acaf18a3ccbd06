"""The SLAM orchestrator (port of ``scl_slam_tpu/runtime/mapper.py``):
the live single-robot path, the keyframe replay path, and the loop-queue
drain with the pose-graph solve.

Live, per keyframe (``Mapper.add_frame`` + ``Mapper.spin_once``):

0. storage downsample + descriptor build of the raw scan (the family
   ``descriptor_type`` names; Scan Context and LiDAR-Iris on kernel K2 on
   CUDA), and single-frame ingest into the fixed-capacity state;
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

Inter-robot, per keyframe of each robot (``Mapper.broadcast_latest``,
``Mapper.detect_inter_loop``, ``Mapper.serve_verification``): the new
keyframe's descriptor goes to every peer over a bus (``transport.py``),
where ``_ingest_peer`` chains the peer's pose and stores the descriptor;
``_detect_inter`` queries the peers' descriptors for the latest own
keyframe and, on a hit, the robot that owns the match verifies it by RPC:
``_verify_ransac`` gathers its submap around the match and runs RANSAC +
SVD (kernel K3 for the 1-NN) against the requester's map-frame cloud. A
verified factor joins both robots' loop queues (``_queue_loop``).

When a robot's keyframe block is full, the oldest redundant keyframes are
evicted and the block compacted (``runtime/eviction.py``, host numpy); the
evicted poses are archived for ``full_trajectory``. The centralized fleet
(``runtime/fleet.py``) shares every stage function here.

The storage downsample is the stride permutation by default, or the voxel
modes (``storage_downsample="voxel_hash"``/``"voxel"``); with ``use_pcm``
the drain keeps only the largest pairwise-consistent set of the ready
loops (``graph/pcm.py``).

With a mesh attached (``Mapper.attach_mesh``) the drain's solve is the
distributed two-stage path (chordal rotation init, then the edge-sharded
Gauss-Newton of ``parallel/sharded.py``); ``Mapper.shard_database`` shards
the descriptor DB by rows over the same mesh.

The state is updated in place (the JAX steps donate their state). The
C++ host-descriptor path and int16 transfer are not carried, and raise
``NotImplementedError``.
"""
from __future__ import annotations

import functools
import os
import threading
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
    db_robot = base.column(state.desc_db, "robot")
    db_index = base.column(state.desc_db, "index")
    robot = (enc // IDX_BASE).long()
    index = enc % IDX_BASE
    hits = (db_robot[None, :] == robot[:, None]) & (db_index[None, :] == index[:, None])
    found = hits.any(dim=1)
    first = hits.to(torch.int8).argmax(dim=1)   # first hit, as jnp.argmax
    slot = torch.where(found, first, -1).to(torch.int32)
    K = state.kf_xyz.shape[0] // state.counts.shape[0]
    count = state.counts[robot]
    last_slot = torch.clamp(robot * K + count - 1, min=0)
    last_index = torch.where(count > 0, db_index[last_slot], -1)
    pending = ~found & (index > last_index)
    return slot, pending


def _db_index(state: MapperState, slots):
    """The protocol keyframe index at DB rows ``slots`` (from their owner
    on a sharded DB)."""
    return base.rows(state.desc_db, slots, ("index",))[0]


def _prepare_frame(xyz: torch.Tensor, mask: torch.Tensor, cfg: SlamConfig):
    """DB-independent per-frame work for frames [..., N, 3]: storage
    downsample + descriptor build. The descriptor is built from the RAW
    scan; only storage is downsampled."""
    cloud = pc.Cloud(xyz, mask)
    small = _prepare_cloud(cloud, cfg)
    descriptor = registry.get_family(cfg).make(cloud)
    return small, descriptor


def _prepare_cloud(cloud: pc.Cloud, cfg: SlamConfig) -> pc.Cloud:
    """Storage downsample of clouds [..., N, 3] to ``points_per_keyframe``:
    ``"stride"`` (the default), ``"voxel_hash"`` or ``"voxel"`` (also
    ``fast_voxel=False``) at ``descript_leaf_size``; the voxel modes take one
    cloud at a time, so the frames are walked here (JAX vmaps them)."""
    kf = cfg.keyframe
    mode = kf.storage_downsample
    if not kf.fast_voxel:
        mode = "voxel"  # back-compat alias
    if mode == "stride":
        return pc.stride_permute_downsample(cloud, kf.points_per_keyframe)
    down = pc.voxel_downsample_hash if mode == "voxel_hash" else pc.voxel_downsample
    lead, n = cloud.xyz.shape[:-2], cloud.xyz.shape[-2]
    outs = [
        down(pc.Cloud(x, m), kf.descript_leaf_size, kf.points_per_keyframe)
        for x, m in zip(cloud.xyz.reshape(-1, n, 3), cloud.mask.reshape(-1, n))
    ]
    return pc.Cloud(
        torch.stack([o.xyz for o in outs]).reshape(*lead, -1, 3),
        torch.stack([o.mask for o in outs]).reshape(*lead, -1),
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
    idx0 = 0 if first else _db_index(state, prev_slot) + 1
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
    state: MapperState, center_slots, robot, cfg: SlamConfig, count
):
    """±near_keyframes submap around each of B slots, in the map frame.

    ``robot`` is the robot of every lane, or one per lane ([B], a fleet
    batch). Gathers 2*near+1 clouds per lane (clipped to the lane robot's
    chain as it stood at ``count`` [B] keyframes), transforms each by its optimized pose,
    and keeps a per-cloud prefix sized to fill ``submap_capacity`` (stored
    clouds are scramble-ordered, so a prefix is a uniform subsample). A
    plain index gather: the JAX one-hot matmul was a TPU workaround. The
    pad to ``submap_capacity`` is kept so shapes match the JAX outputs.
    """
    K = cfg.keyframe.max_keyframes
    near = cfg.loop.near_keyframes
    dev = state.kf_xyz.device
    lo = torch.as_tensor(robot, device=dev).long().reshape(-1, 1) * K
    offs = torch.arange(-near, near + 1, device=dev)
    hi = lo + torch.clamp(torch.as_tensor(count, device=dev).long().reshape(-1, 1) - 1, min=0)
    slots = torch.minimum(
        torch.maximum(center_slots.long()[:, None] + offs[None], lo), hi
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
    state: MapperState, slots, match_slots, yaws, robot, cfg: SlamConfig,
    count,
):
    """ICP inputs for B intra-loop verifications: (current keyframe cloud
    prefix, ±near submap target, yaw-seeded start pose). ``robot`` is one
    robot or [B] robots; ``count`` [B] is each frame's keyframe count at
    its sequential detection time."""
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
    q_idx = _db_index(state, slots)               # protocol index [1]
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
    endpoints were evicted are dropped. With ``use_pcm``, only the ready
    loops in the largest pairwise-consistent set under the current
    estimates are added (``graph/pcm.py``); a rejected loop leaves the
    queue. The JAX ``fori_loop`` of masked appends is one append in row
    order (an exclusive cumsum of the added rows), which gives the same
    edge rows. Returns (graph, n_new [0-d], compacted queue).
    """
    q = state.loop_queue
    Q = q.i.shape[0]
    in_queue = torch.arange(Q, device=q.i.device) < q.count
    slots_i, pend_i = _resolve_indices(state, q.i)
    slots_j, pend_j = _resolve_indices(state, q.j)
    ready = in_queue & (slots_i >= 0) & (slots_j >= 0)
    deferred = in_queue & ~ready & (pend_i | pend_j)
    qi_slot = torch.clamp(slots_i, min=0).long()
    qj_slot = torch.clamp(slots_j, min=0).long()
    added = ready
    if cfg.optimizer.use_pcm:
        from ..graph import pcm

        added = ready & pcm.pcm_filter(
            se3.Pose(state.opt_R[qi_slot], state.opt_t[qi_slot]),
            se3.Pose(state.opt_R[qj_slot], state.opt_t[qj_slot]),
            se3.Pose(q.z_R, q.z_t), ready, threshold=cfg.optimizer.pcm_threshold,
        )
    var = torch.clamp(q.noise * cfg.optimizer.loop_noise_scale, min=1e-6)
    sq = 1.0 / torch.sqrt(var)
    graph = F.add_between_block(
        state.graph, qi_slot, qj_slot,
        se3.Pose(q.z_R, q.z_t), sq[:, None].expand(Q, 6), valid=added,
    )
    n_new = added.sum()
    # deferred entries first, in their order (a stable sort on ~deferred)
    order = torch.sort((~deferred).to(torch.int8), stable=True).indices
    new_queue = LoopQueue(
        i=q.i[order], j=q.j[order], z_R=q.z_R[order], z_t=q.z_t[order],
        noise=q.noise[order], count=deferred.sum().to(torch.int32),
    )
    return graph, n_new, new_queue


def _solved(poses: se3.Pose, chi2_history: torch.Tensor) -> torch.Tensor:
    """0-d bool: a solve ended finite (its final chi2 and every pose)."""
    return (torch.isfinite(chi2_history[-1]) & torch.isfinite(poses.R).all()
            & torch.isfinite(poses.t).all())


def _drain_queue_and_optimize(state: MapperState, cfg: SlamConfig):
    """Drain the loop queue into the factor graph, then solve (one device).

    Solves only when the drain added loop factors (a host branch). GN runs
    from two starts, the current estimate and a chordal rotation init, and
    the lower final chi2 of a finite solve wins. Returns (state,
    chi2_history [gn_iters + 1]; zeros when nothing was solved, broken
    [2] int32: per start (warm, chordal) 0 where its solve ended finite or
    did not run, else its ``SolveResult.breakdown`` code, -1 where no step
    flagged the breakdown).
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
            return r.poses, r.chi2_history, r.breakdown

        warm_poses, warm_chi, warm_code = run(poses)
        staged_poses, staged_chi, staged_code = run(chordal_rotation_init(graph, poses))
        # a start whose solve broke down (a non-finite chi2 or pose) never
        # replaces the estimate: the other start is kept, or, where both
        # broke down, the estimate from before the drain (the new factors
        # stay in the graph for the next solve). The JAX module keeps the
        # warm start there, which a NaN then takes over.
        warm_ok, staged_ok = _solved(warm_poses, warm_chi), _solved(staged_poses, staged_chi)
        use_staged = staged_ok & (~warm_ok | (staged_chi[-1] < warm_chi[-1]))
        neither = ~(warm_ok | staged_ok)
        opt_R = torch.where(neither, poses.R,
                            torch.where(use_staged, staged_poses.R, warm_poses.R))
        opt_t = torch.where(neither, poses.t,
                            torch.where(use_staged, staged_poses.t, warm_poses.t))
        chi2_history = torch.where(use_staged, staged_chi, warm_chi)
        broken = torch.stack([
            torch.where(ok, 0, torch.where(code != 0, code, -1)).to(torch.int32)
            for ok, code in ((warm_ok, warm_code), (staged_ok, staged_code))
        ])
    else:
        opt_R, opt_t = poses.R, poses.t
        chi2_history = poses.t.new_zeros((o.gn_iters + 1,))
        broken = torch.zeros((2,), dtype=torch.int32, device=poses.t.device)
    state = state._replace(
        graph=graph,
        opt_R=opt_R,
        opt_t=opt_t,
        loop_queue=new_queue,
        loop_closed=torch.zeros_like(state.loop_closed),
    )
    return state, chi2_history, broken


def _drain_queue_and_optimize_mesh(state: MapperState, cfg: SlamConfig, group):
    """The mesh-attached drain (``Mapper.attach_mesh``): the distributed
    two-stage solve of the JAX function.

    1. The queue drains into the factor graph (``_drain_queue``, PCM where
       ``use_pcm``), as on one device.
    2. The rotation stage: chordal rotation averaging
       (``chordal_rotation_init``), the global linear relaxation that
       converges whatever the accumulated rotation error.
    3. The pose stage: edge-sharded Gauss-Newton over ``group``
       (``parallel/sharded.sharded_solve``) for ``max_outer_rounds``
       steps, with ``gamma`` over-relaxation and the two change thresholds'
       freeze.

    Every rank runs the same drain on the same state; only the edge work is
    split. Solves only when the drain added a loop factor. A solve that
    ends non-finite never replaces the estimate (the JAX function keeps
    it). Returns (state, chi2_history [max_outer_rounds], zeros when
    nothing was solved; broken [1] int32: 0, or where the solve ended
    non-finite its ``breakdown`` code, -1 where no step flagged it).
    """
    from ..parallel import sharded

    graph, n_new, new_queue = _drain_queue(state, cfg)
    poses = se3.Pose(state.opt_R, state.opt_t)
    o = cfg.optimizer
    broken = torch.zeros((1,), dtype=torch.int32, device=poses.t.device)
    if int(n_new) > 0:
        new, chi2_history, code = sharded.sharded_solve(
            group, graph, chordal_rotation_init(graph, poses),
            gn_iters=o.max_outer_rounds, cg_iters=o.cg_iters, damping=o.damping,
            gamma=o.gamma, rotation_change_threshold=o.rotation_change_threshold,
            pose_change_threshold=o.pose_change_threshold,
            coarse_stride=o.coarse_stride, coarse_levels=o.coarse_levels,
        )
        ok = _solved(new, chi2_history)
        opt_R = torch.where(ok, new.R, poses.R)
        opt_t = torch.where(ok, new.t, poses.t)
        broken = torch.where(ok, broken, torch.where(code != 0, code, -1))
    else:
        opt_R, opt_t = poses.R, poses.t
        chi2_history = poses.t.new_zeros((o.max_outer_rounds,))
    state = state._replace(
        graph=graph, opt_R=opt_R, opt_t=opt_t, loop_queue=new_queue,
        loop_closed=torch.zeros_like(state.loop_closed),
    )
    return state, chi2_history, broken


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


def _ingest_peer(
    state: MapperState, robot: int, index: int, pre_pose: se3.Pose,
    cur_pose: se3.Pose, wire: torch.Tensor, stamp, cfg: SlamConfig,
):
    """Peer descriptor ingestion, in place: extend the peer's pose chain by
    a between factor (prePose -> curPose), or hold its first pose by the
    weak prior (the reference adds none for peers; the prior keeps the
    joint solve well-posed before any inter-robot loop), and store the wire
    descriptor. ``index`` is the peer's protocol keyframe index; the slot
    is the next free position of its block. No cloud is stored: clouds
    move only in verification RPCs. The caller has checked capacity."""
    K = cfg.keyframe.max_keyframes
    pos = int(state.counts[robot])
    slot = robot * K + pos
    first = pos == 0
    g = state.graph
    if first:
        F.add_prior(g, slot, cur_pose, [1.0 / s for s in cfg.optimizer.prior_sigmas])
    else:
        F.add_between(
            g, slot - 1, slot, se3.between(pre_pose, cur_pose),
            [1.0 / s for s in cfg.optimizer.odometry_sigmas],
        )
    fam = registry.get_family(cfg)
    fam.insert(state.desc_db, fam.from_wire(wire), robot, index, slot)

    prev_slot = max(slot - 1, robot * K)
    prev_opt = se3.Pose(state.opt_R[prev_slot], state.opt_t[prev_slot])
    prev_odom = se3.Pose(state.odom_R[prev_slot], state.odom_t[prev_slot])
    opt = cur_pose if first else se3.compose(prev_opt, se3.between(prev_odom, cur_pose))
    state.odom_R[slot] = cur_pose.R
    state.odom_t[slot] = cur_pose.t
    state.opt_R[slot] = opt.R
    state.opt_t[slot] = opt.t
    state.stamps[slot] = stamp
    state.counts[robot] += 1
    return state


def _detect_inter(state: MapperState, robot: int, cfg: SlamConfig):
    """Inter-robot candidate for the latest own keyframe: an 'inter' query
    of the DB. Returns (found 0-d, match with 0-d fields, the keyframe's
    cloud in the map frame [P, 3], its mask [P]): the payload of the
    verification RPC."""
    K = cfg.keyframe.max_keyframes
    fam = registry.get_family(cfg)
    pos = int(state.counts[robot]) - 1
    slot = robot * K + max(pos, 0)
    slots = torch.tensor([slot], device=state.kf_xyz.device)
    q_idx = _db_index(state, slots)
    match = fam.query(state.desc_db, fam.from_db(state.desc_db, slots), robot, q_idx, "inter")
    match = base.Match(*(f[0] for f in match))
    found = match.found & ~(state.loop_target[slot] >= 0)
    P = cfg.keyframe.points_per_keyframe
    cloud = pc.Cloud(state.kf_xyz[slot].reshape(P, 3), state.kf_mask[slot])
    world = pc.transform(cloud, state.opt_R[slot], state.opt_t[slot])
    return found, match, world.xyz, world.mask


def _verify_inputs(state: MapperState, robot_pre: int, index_pre: int, cfg: SlamConfig):
    """What verification reads of the state: (resident 0-d, the submap
    around (robot_pre, index_pre) as a Cloud, that keyframe's optimized
    pose), all fresh tensors. A frame evicted since the requester's
    retrieval is not resident, and the verification then fails."""
    enc = torch.tensor([encode_kf(robot_pre, index_pre)], dtype=torch.int32,
                       device=state.kf_xyz.device)
    pre_slots, _ = _resolve_indices(state, enc)
    resident = pre_slots[0] >= 0
    pre_slot = torch.clamp(pre_slots[:1], min=0)
    submap = _gather_submap(state, pre_slot, robot_pre, cfg, state.counts[robot_pre].reshape(1))
    pre_pose = se3.Pose(state.opt_R[pre_slot[0]].clone(), state.opt_t[pre_slot[0]].clone())
    return resident, pc.Cloud(submap.xyz[0], submap.mask[0]), pre_pose


def _verify_align(
    inputs, cloud_xyz, cloud_mask, cur_pose_est: se3.Pose, cfg: SlamConfig,
    seed: int, attempt: int, samples=None,
):
    """RANSAC + SVD of the requester's map-frame cloud against the gathered
    submap (:func:`_verify_inputs`). Returns (success, z = T_pre^-1 *
    T_cur_corrected, inlier_ratio)."""
    resident, submap, pre_pose = inputs
    res = reg.ransac_align(
        pc.Cloud(cloud_xyz, cloud_mask), submap, seed, attempt,
        num_hypotheses=cfg.loop.ransac_max_iter,
        inlier_thresh=cfg.loop.ransac_outlier_threshold,
        min_inlier_ratio=cfg.loop.ransac_inlier_ratio,
        samples=samples,
    )
    # the alignment composed onto the estimate that made the cloud
    corrected = se3.compose(res.pose, cur_pose_est)
    z = se3.between(pre_pose, corrected)
    return res.success & resident, z, res.inlier_ratio


def _verify_ransac(
    state: MapperState, cloud_xyz, cloud_mask, cur_pose_est: se3.Pose,
    robot_pre: int, index_pre: int, cfg: SlamConfig, seed: int, attempt: int,
    samples=None,
):
    """Server side of geometric verification: :func:`_verify_inputs` then
    :func:`_verify_align`. ``cur_pose_est`` is the requester's own estimate
    that put the cloud in its map frame (carried in the request). RANSAC
    draws with (``seed``, ``attempt``) unless ``samples`` is given."""
    inputs = _verify_inputs(state, robot_pre, index_pre, cfg)
    return _verify_align(inputs, cloud_xyz, cloud_mask, cur_pose_est, cfg, seed, attempt, samples)


def _queue_loop(
    state: MapperState, i_enc: int, j_enc: int, z: se3.Pose, noise: float,
    cfg: SlamConfig,
):
    """Append a verified loop factor in place, in canonical order (lower
    (robot, index) first; z inverted when swapped). Endpoints are
    ``encode_kf`` values, resolved to slots at drain time; a full queue
    drops the factor. The dedup marker is set only when both endpoints are
    resident here."""
    swap = i_enc > j_enc
    a, b = (j_enc, i_enc) if swap else (i_enc, j_enc)
    zc = se3.inverse(z) if swap else z
    q = state.loop_queue
    cnt = int(q.count)
    qok = cnt < q.i.shape[0]
    if qok:
        q.i[cnt] = a
        q.j[cnt] = b
        q.z_R[cnt] = zc.R
        q.z_t[cnt] = zc.t
        q.noise[cnt] = noise
        q.count.add_(1)
        enc = torch.tensor([a, b], dtype=torch.int32, device=q.i.device)
        slots, _ = _resolve_indices(state, enc)
        mark = (slots[0] >= 0) & (slots[1] >= 0)
        b_slot = torch.clamp(slots[1], min=0)
        state.loop_target[b_slot] = torch.where(mark, slots[0], state.loop_target[b_slot])
    return state._replace(loop_closed=state.loop_closed | qok)


def _gather_global_map(state: MapperState, per: int):
    """A ``per``-point prefix of every keyframe slot in the map frame
    (empty slots masked by the DB's occupancy). Returns ([S, per, 3],
    [S, per])."""
    xyz = state.kf_xyz[:, : per * 3].reshape(-1, per, 3)
    occupied = base.column(state.desc_db, "index") >= 0
    mask = state.kf_mask[:, :per] & occupied[:, None]
    return se3.transform_points(se3.Pose(state.opt_R, state.opt_t), xyz), mask


def _locked(method):
    """Serialize a Mapper entry point on the instance's state lock (bus
    threads call into the same object; see ``Mapper.__init__``)."""

    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        with self._state_lock:
            return method(self, *args, **kwargs)

    return wrapper


class Mapper:
    """Host-side shell for one robot's SLAM session on ``device``.

    Holds a :class:`MapperState` and applies the transitions above: the
    live path (:meth:`add_frame`, :meth:`spin_once`, :meth:`optimize`), the
    replay path (:meth:`add_frames`, :meth:`replay`), the inter-robot path
    over a bus (:meth:`attach_bus`, :meth:`broadcast_latest`,
    :meth:`detect_inter_loop`, :meth:`serve_verification`) and the exports.
    The entry point runs on the card: ``device`` defaults to ``"cuda"`` and
    the constructor raises where there is none, unless the caller asks for
    ``device="cpu"`` (where every kernel takes its plain version). A full
    keyframe block is compacted by eviction (:meth:`_compact`); a session
    is saved and resumed by ``runtime/checkpoint.py`` (``_frames_seen``,
    the own frames fed so far, is its resume cursor).

    Threads: with a socket bus, peer descriptors arrive and verification
    requests are served on the bus's threads. Every state-changing entry
    point holds ``_state_lock`` (as in the JAX package). The state is
    changed in place here, so each transition that writes it also holds
    ``_write_lock``, which is never held across an RPC;
    :meth:`serve_verification` takes only ``_write_lock``, and only while it
    gathers the submap. So a serve never reads a half-written state, and a
    robot blocked in its own verification RPC (holding its ``_state_lock``)
    can still serve a peer: no cross-robot lock cycle.
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
        # own frames offered to the keyframe gate (add_frame, add_frames,
        # replay): the resume cursor of a checkpoint
        self._frames_seen = 0
        self._last_opt_time = float("-inf")
        self._pending_intra = None
        self._pending_intra_valid = False
        self.icp_attempts = 0  # live-path ICP verifications run so far
        # drains where a start's solve ended non-finite (the drain then kept
        # the other start or the estimate from before it), and each such
        # start with the step and stage where it broke down
        self.broken_drains = 0
        self.solve_breakdowns: list[str] = []
        # the inter-robot path's outcomes: own queries run, candidates found,
        # verification RPCs that failed, verifications refused by the peer,
        # loops queued; peer descriptors dropped as out of order
        self.inter_log = dict.fromkeys(
            ("queries", "found", "rpc_failed", "rejected", "verified", "peer_dropped"), 0)
        self._state_lock = threading.RLock()
        self._write_lock = threading.Lock()
        # factors verified for peers on the bus thread, queued into the
        # state by the next locked entry point (_drain_server_loops)
        self._pending_server_loops: list[tuple] = []
        self._pending_loops_lock = threading.Lock()
        self._bus = None
        # RANSAC draws: the JAX seed (robot_id + 1) and a serve counter
        self._verify_seed = cfg.robot_id + 1
        self._verify_attempts = 0
        # the inter query's inputs changed since its last dispatch: a new
        # own keyframe, a peer descriptor, or a verification that failed
        self._inter_dirty = False
        # fixed-lag archive: evicted keyframes' (index, stamp, pose at
        # eviction) per robot, merged back in by full_trajectory
        self._evicted: dict[int, list] = {}
        self._mesh_group = None   # set by attach_mesh()
        self._db_group = None     # set by shard_database()

    # -- keyframe gate (reference saveFrame, distributedMapping.h:755-780) --
    def should_add_keyframe(self, pose) -> bool:
        return self._moved_enough(self._last_kf_pose, pose)

    def _moved_enough(self, last, pose) -> bool:
        """The keyframe gate on the host: ``pose`` is ``distance_threshold``
        or ``angle_threshold`` away from ``last`` (or there is no last)."""
        if last is None:
            return True
        R0, t0 = to_numpy(last.R), to_numpy(last.t)
        R1, t1 = to_numpy(pose.R), to_numpy(pose.t)
        dist = float(np.linalg.norm(t1 - t0))
        cos_ang = (np.trace(R0.T @ R1) - 1.0) * 0.5
        ang = float(np.arccos(np.clip(cos_ang, -1.0, 1.0)))
        return (
            dist >= self.cfg.keyframe.distance_threshold
            or ang >= self.cfg.keyframe.angle_threshold
        )

    def _gate_frames(self, poses, n: int, apply_gate: bool) -> tuple[list, list]:
        accepted, sel = [], []
        for i in range(n):
            self._frames_seen += 1
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

    @_locked
    def add_frames(self, poses, scans, stamps=None, apply_gate: bool = True) -> dict:
        """Macro-batched ingestion of many odometry frames as ONE batch
        (the keyframe gate runs host-side per frame; ``apply_gate=False``
        takes every frame). Returns ``{"accepted": [bool per frame],
        "loops": [dict | None per accepted frame], "keyframes": total}``.
        Loops served for peers are queued first, as in ``add_frame``.
        """
        self._drain_server_loops()
        n = len(scans)
        if stamps is None:
            stamps = [0.0] * n
        accepted, sel = self._gate_frames(poses, n, apply_gate)
        if not sel:
            return {"accepted": accepted, "loops": [], "keyframes": self._keyframes}
        self._ensure_capacity(len(sel))
        self._ensure_queue_headroom(len(sel))
        pose_b, xyz, mask, st = self._stage(poses, scans, stamps, sel)
        with self._write_lock:
            self.state, oks, idxs, fits = _batch_body(
                self.state, self.robot, pose_b, xyz, mask, st, self.cfg
            )
        loops = self._record(oks, idxs, fits)
        self._inter_dirty = True
        return {"accepted": accepted, "loops": loops, "keyframes": self._keyframes}

    def _ensure_queue_headroom(self, k: int) -> None:
        """Drain the loop queue (and solve) when the next ``k`` frames could
        overflow it: a k-frame batch can enqueue up to k loop factors, and
        an append to a full queue drops the factor."""
        if int(self.state.loop_queue.count) + k > self.cfg.loop.queue_capacity:
            self.optimize()

    def _compact(self, robot: int) -> None:
        """Evict and compact one robot's block (``runtime/eviction.py``),
        archiving the evicted keyframes."""
        from . import eviction

        with self._write_lock:
            # a sharded DB is gathered, compacted whole, and sharded again
            self.state, records = eviction.compact_robot(self.unsharded_state(), self.cfg, robot)
            self._evicted.setdefault(robot, []).extend(records)
            self._reshard()

    def _ensure_capacity(self, k: int, robot: int | None = None) -> None:
        """Evict (compact) until ``k`` more keyframes fit the robot's block
        (own by default). An impossible request and a compaction that frees
        nothing raise instead of spinning."""
        robot = self.robot if robot is None else robot
        K = self.cfg.keyframe.max_keyframes
        if k > K:
            raise ValueError(f"batch of {k} keyframes exceeds capacity {K}")
        while int(self.state.counts[robot]) + k > K:
            before = int(self.state.counts[robot])
            self._compact(robot)
            if int(self.state.counts[robot]) >= before:
                raise RuntimeError("eviction could not free capacity for the batch")

    @_locked
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
        accepted, sel = self._gate_frames(poses, n, apply_gate)
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
            with self._write_lock:
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
            self._inter_dirty = True
            pos += chunk
        if pos < len(sel):
            rem = sel[pos:]
            # counted above: add_frames counts the remainder again
            self._frames_seen -= len(rem)
            out = self.add_frames(
                [poses[i] for i in rem],
                [scans[i] for i in rem],
                [stamps[i] for i in rem],
                apply_gate=False,
            )
            loops.extend(out["loops"])
        return {"accepted": accepted, "loops": loops, "keyframes": self._keyframes}

    # -- the live path --
    @_locked
    def add_frame(self, pose, xyz, stamp: float = 0.0) -> np.ndarray | None:
        """Process one odometry frame (``pose`` with ``.R`` [3, 3] / ``.t``
        [3], tensors or arrays; ``xyz`` [N, 3]). Returns the wire descriptor
        when the frame became a keyframe, else None. When intra detection is
        due for the keyframe, it runs right after the ingest and
        :meth:`spin_once` consumes the stored result."""
        self._drain_server_loops()
        self._frames_seen += 1
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
            with self._write_lock:
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
            with self._write_lock:
                self.state, wire = _ingest(*args)
            self._pending_intra = None
            self._pending_intra_valid = False
        self._keyframes += 1
        self._inter_dirty = True
        return to_numpy(wire)

    @_locked
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
        with self._write_lock:
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

    @_locked
    def optimize(self) -> np.ndarray:
        """Drain the loop queue and run the pose-graph solve. Returns the
        chi2 history (zeros when no loop factor was added)."""
        self._drain_server_loops()
        with self._write_lock:
            if self._mesh_group is not None:
                self.state, chi2_hist, broken = _drain_queue_and_optimize_mesh(
                    self.state, self.cfg, self._mesh_group)
                starts = ("mesh",)
            else:
                self.state, chi2_hist, broken = _drain_queue_and_optimize(self.state, self.cfg)
                starts = ("warm", "chordal")
        broken = to_numpy(broken)
        if broken.any():
            self.broken_drains += 1
            self.solve_breakdowns += [
                f"{start}: " + (solver.breakdown_stages(c) if c > 0 else "no step flagged")
                for start, c in zip(starts, broken.tolist()) if c != 0
            ]
        return to_numpy(chi2_hist)

    # -- the distributed path (parallel/) --
    def attach_mesh(self, mesh, axis: str = "shard") -> None:
        """Route every drain's solve through the distributed two-stage path
        (chordal rotation init, then the edge-sharded Gauss-Newton over the
        mesh axis's group): :func:`_drain_queue_and_optimize_mesh`. Every
        rank of the group must run the same mapper on the same frames.
        ``mesh`` is a ``torch.distributed`` ``DeviceMesh``
        (``parallel/multihost.make_mesh``). Composes with
        :meth:`shard_database` on the same mesh."""
        group = mesh.get_group(axis)
        world = torch.distributed.get_world_size(group)
        if self.cfg.optimizer.edge_capacity % world:
            raise ValueError(
                f"edge_capacity {self.cfg.optimizer.edge_capacity} not "
                f"divisible by mesh axis {axis}={world}"
            )
        self._mesh_group = group

    def detach_mesh(self) -> None:
        """Back to the single-device drain."""
        self._mesh_group = None

    @_locked
    def shard_database(self, mesh, axis: str = "shard") -> None:
        """Shard the descriptor DB by rows over the mesh axis's group: rank
        r keeps only rows ``[r S / D, (r + 1) S / D)`` of its four arrays
        (``descriptors/base.ShardedDB``). Queries take the top-k over the
        local rows and merge the ranks' candidates
        (``parallel/sharded.sharded_topk``); inserts write on the owning
        rank; compaction gathers the DB, compacts it and shards it again;
        checkpoints and every other reader see the whole DB
        (:meth:`unsharded_state`). The answers are the unsharded ones.
        Every rank must run the same mapper on the same frames; the DB's
        row count (``number_of_robots * max_keyframes``) must divide by
        the axis size. Calls from a bus thread are not supported."""
        group = mesh.get_group(axis)
        world = torch.distributed.get_world_size(group)
        S = self.state.kf_xyz.shape[0]
        if S % world:
            raise ValueError(f"DB rows {S} not divisible by mesh axis {axis}={world}")
        with self._write_lock:
            self.state = self.state._replace(desc_db=base.unshard_db(self.state.desc_db))
            self._db_group = group
            self._reshard()

    def _reshard(self) -> None:
        """Shard a whole DB again where :meth:`shard_database` asked for it
        (after a compaction or a checkpoint load)."""
        if self._db_group is not None and base.shard_of(self.state.desc_db) is None:
            self.state = self.state._replace(
                desc_db=base.shard_db(self.state.desc_db, self._db_group))

    def unsharded_state(self) -> MapperState:
        """The state with the whole descriptor DB (gathered where it is
        sharded; the state itself otherwise)."""
        return self.state._replace(desc_db=base.unshard_db(self.state.desc_db))

    # -- inter-robot loop closure --
    def next_index(self, robot: int) -> int:
        """Next protocol keyframe index in a robot's chain (tail index + 1)."""
        K = self.cfg.keyframe.max_keyframes
        n = int(self.state.counts[robot])
        if n == 0:
            return 0
        return int(_db_index(self.state, robot * K + n - 1)) + 1

    def _pose_in(self, T) -> se3.Pose:
        """A [4, 4] wire pose as an f32 Pose on this mapper's device."""
        T = np.asarray(T, np.float32)
        return se3.Pose(
            torch.from_numpy(T[:3, :3].copy()).to(self.device),
            torch.from_numpy(T[:3, 3].copy()).to(self.device),
        )

    def _pose_out(self, R, t) -> np.ndarray:
        """A Pose's (R, t) as the wire's f64 [4, 4]."""
        T = np.eye(4)
        T[:3, :3] = to_numpy(R)
        T[:3, 3] = to_numpy(t)
        return T

    @_locked
    def ingest_peer_descriptor(
        self, robot: int, index: int, pre_pose, cur_pose, wire, stamp: float = 0.0,
    ) -> bool:
        """In-order peer descriptor ingestion (poses with ``.R`` / ``.t``,
        wire a flat float vector). Returns False when the descriptor is
        dropped as out of order. A full peer block is compacted first."""
        if index != self.next_index(robot):
            self.inter_log["peer_dropped"] += 1
            return False
        self._ensure_capacity(1, robot)
        dev = self.device

        def pose(p):
            return se3.Pose(
                torch.as_tensor(p.R, dtype=torch.float32).to(dev),
                torch.as_tensor(p.t, dtype=torch.float32).to(dev),
            )

        values = torch.as_tensor(np.asarray(wire, np.float32)).to(dev)
        with self._write_lock:
            self.state = _ingest_peer(
                self.state, robot, index, pose(pre_pose), pose(cur_pose), values,
                float(stamp), self.cfg,
            )
        self._inter_dirty = True
        return True

    def attach_bus(self, bus) -> None:
        """Wire this mapper to a transport bus (``LocalBus`` or ``TcpBus``
        of ``runtime/transport.py``)."""
        self._bus = bus
        bus.register(self.robot, self._on_peer_descriptor, self.serve_verification)

    def _on_peer_descriptor(self, msg) -> None:
        self.ingest_peer_descriptor(
            msg.robot, msg.index, self._pose_in(msg.pre_pose),
            self._pose_in(msg.cur_pose), msg.values, msg.stamp,
        )

    @_locked
    def broadcast_latest(self, wire: np.ndarray) -> None:
        """Publish the latest own keyframe's descriptor to the peers, with
        its odometry pose and the previous keyframe's (the pair a peer
        chains by)."""
        if self._bus is None:
            return
        from .transport import DescriptorMsg

        K = self.cfg.keyframe.max_keyframes
        pos = int(self.state.counts[self.robot]) - 1
        slot = self.robot * K + pos
        st = self.state
        cur = self._pose_out(st.odom_R[slot], st.odom_t[slot])
        pre = self._pose_out(st.odom_R[slot - 1], st.odom_t[slot - 1]) if pos > 0 else cur.copy()
        msg = DescriptorMsg(
            robot=self.robot, index=int(_db_index(st, slot)), pre_pose=pre,
            cur_pose=cur, values=np.asarray(wire, np.float32),
            stamp=float(st.stamps[slot]),
        )
        self._bus.broadcast_descriptor(self.robot, msg)

    @_locked
    def detect_inter_loop(self) -> dict | None:
        """Query for a cross-robot loop on the latest own keyframe; on a hit,
        ask the owning robot to verify it (RPC) and queue the factor.

        Runs only when the query's inputs changed (a new own keyframe or a
        peer descriptor), or after a verification that failed or could not
        be made: RANSAC draws anew each time and the pose estimate moves,
        so a failed candidate is retried on the next spin."""
        if (
            not self.cfg.loop.inter_enabled
            or self._bus is None
            or self.cfg.number_of_robots < 2
            or self._keyframes < 1
            or not self._inter_dirty
        ):
            return None
        self._inter_dirty = False
        self.inter_log["queries"] += 1
        found, match, cloud_xyz, cloud_mask = _detect_inter(self.state, self.robot, self.cfg)
        if not bool(found):
            return None
        self.inter_log["found"] += 1
        from .transport import _DECODE_ERRORS, VerifyRequest

        robot_pre, index_pre = int(match.robot), int(match.index)
        K = self.cfg.keyframe.max_keyframes
        cur_slot = self.robot * K + int(self.state.counts[self.robot]) - 1
        idx_cur = int(_db_index(self.state, cur_slot))
        req = VerifyRequest(
            robot_cur=self.robot, index_cur=idx_cur, robot_pre=robot_pre,
            index_pre=index_pre, cloud_xyz=to_numpy(cloud_xyz),
            cloud_mask=to_numpy(cloud_mask),
            cur_pose_est=self._pose_out(self.state.opt_R[cur_slot], self.state.opt_t[cur_slot]),
        )
        try:
            resp = self._bus.verify(robot_pre, req)
        except (OSError, ConnectionError, EOFError, TimeoutError, *_DECODE_ERRORS):
            # a peer down or a malformed reply: a missed verification, not
            # an error; retried on the next spin
            self._inter_dirty = True
            self.inter_log["rpc_failed"] += 1
            return None
        if not resp.success:
            self._inter_dirty = True
            self.inter_log["rejected"] += 1
            return None
        self.inter_log["verified"] += 1
        with self._write_lock:
            self.state = _queue_loop(
                self.state, encode_kf(robot_pre, index_pre), encode_kf(self.robot, idx_cur),
                self._pose_in(resp.pose_between), max(1e-3, 1.0 - resp.inlier_ratio),
                self.cfg,
            )
        return {
            "robot": robot_pre,
            "matched_index": index_pre,
            "distance": float(match.distance),
            "inlier_ratio": resp.inlier_ratio,
        }

    def serve_verification(self, req):
        """Server side of the verification RPC (called on a bus thread).

        Takes ``_write_lock`` only to gather what it reads of the state,
        never ``_state_lock`` (see the class note). A verified factor joins
        both robots' graphs: this one's copy is buffered and queued by the
        next locked entry point (:meth:`_drain_server_loops`)."""
        from .transport import VerifyResponse

        with self._pending_loops_lock:
            attempt = self._verify_attempts
            self._verify_attempts += 1
        dev = self.device
        with self._write_lock:
            inputs = _verify_inputs(self.state, req.robot_pre, req.index_pre, self.cfg)
        success, z, ratio = _verify_align(
            inputs,
            torch.as_tensor(np.asarray(req.cloud_xyz, np.float32)).to(dev),
            torch.as_tensor(np.asarray(req.cloud_mask, bool)).to(dev),
            self._pose_in(req.cur_pose_est), self.cfg, self._verify_seed, attempt,
        )
        ratio = float(ratio)
        if not bool(success):
            return VerifyResponse(False, None, ratio)
        T = self._pose_out(z.R, z.t)
        with self._pending_loops_lock:
            self._pending_server_loops.append((
                encode_kf(req.robot_pre, req.index_pre),
                encode_kf(req.robot_cur, req.index_cur), T, max(1e-3, 1.0 - ratio),
            ))
        return VerifyResponse(True, T, ratio)

    def _drain_server_loops(self) -> None:
        """Queue the factors that :meth:`serve_verification` buffered. The
        caller holds ``_state_lock`` (every call site is a locked entry
        point)."""
        if not self._pending_server_loops:
            return
        with self._pending_loops_lock:
            pending, self._pending_server_loops = self._pending_server_loops, []
        for a_enc, b_enc, T, noise in pending:
            with self._write_lock:
                self.state = _queue_loop(self.state, a_enc, b_enc, self._pose_in(T), noise, self.cfg)

    @_locked
    def spin_once(self, now: float | None = None) -> dict:
        """One loop-thread iteration: intra detection, inter detection, then
        the drain and solve when a loop closed and
        ``mapping_process_interval`` seconds have passed since the last one
        (``now`` drives that throttle from a simulated clock; default
        ``time.monotonic()``)."""
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
        """(poses [N, 4, 4], stamps [N]) from one state snapshot (read under
        ``_write_lock``, so a bus-thread ingest cannot land between them)."""
        robot = self.robot if robot is None else robot
        K = self.cfg.keyframe.max_keyframes
        with self._write_lock:
            st = self.state
            n = int(st.counts[robot])
            return self._traj_from(st, robot), to_numpy(st.stamps[robot * K : robot * K + n])

    def keyframe_stamps(self, robot: int | None = None) -> np.ndarray:
        return self.trajectory_with_stamps(robot)[1]

    def full_trajectory(self, robot: int | None = None):
        """(poses [N, 4, 4], stamps [N]) of every keyframe, evicted ones
        included, in keyframe-index order. Evicted poses are frozen at their
        estimate when evicted (fixed-lag semantics); resident poses are
        current."""
        robot = self.robot if robot is None else robot
        K = self.cfg.keyframe.max_keyframes
        with self._write_lock:
            st = self.state
            n = int(st.counts[robot])
            idx = to_numpy(_db_index(st, torch.arange(robot * K, robot * K + n)))
            poses = self._traj_from(st, robot)
            stamps = to_numpy(st.stamps[robot * K : robot * K + n])
            archived = list(self._evicted.get(robot, []))
        entries = [(r["index"], r["stamp"], r["pose"]) for r in archived]
        entries += [(int(idx[k]), float(stamps[k]), poses[k]) for k in range(n)]
        entries.sort(key=lambda e: e[0])
        if not entries:
            return np.zeros((0, 4, 4)), np.zeros((0,))
        return np.stack([e[2] for e in entries]), np.asarray([e[1] for e in entries])

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

    def export_artifacts(self, directory: str):
        """Global map (``global_map.ply``), each robot's keyframe positions
        (``<name>_keyposes.pcd``) and the loop constraints
        (``loop_constraints.json``): the offline equivalents of the
        reference's rviz topics and PCD exports. Each part reads the state
        under ``_write_lock``, as :meth:`global_map` does."""
        from ..io import export as eio

        os.makedirs(directory, exist_ok=True)
        gmap = self.global_map()
        if len(gmap):
            eio.save_ply(os.path.join(directory, "global_map.ply"), gmap)
        K = self.cfg.keyframe.max_keyframes
        with self._write_lock:
            counts = to_numpy(self.state.counts)
            opt_t = [to_numpy(self.state.opt_t[r * K : r * K + int(counts[r])])
                     for r in range(self.cfg.number_of_robots)]
        for r, keyposes in enumerate(opt_t):
            if len(keyposes):
                eio.save_pcd(os.path.join(directory, f"{chr(ord('a') + r)}_keyposes.pcd"), keyposes)
        eio.save_loop_constraints(
            os.path.join(directory, "loop_constraints.json"), self.loop_constraints()
        )

    def start_map_publisher(self, directory: str, interval: float | None = None):
        """A daemon thread that calls :meth:`export_artifacts` every
        ``interval`` seconds (default ``global_map_publish_interval``): the
        reference's ``globalMapThread``. A failed export is logged and never
        ends the session. Returns a ``stop()`` callable."""
        interval = interval or self.cfg.global_map_publish_interval
        stop = threading.Event()

        def loop():
            while not stop.wait(interval):
                try:
                    self.export_artifacts(directory)
                except Exception:  # an export must never kill the session
                    from ..utils.logging import get_logger

                    get_logger("mapper").exception("map publish failed")

        t = threading.Thread(target=loop, daemon=True)
        t.start()

        def stopper():
            stop.set()
            t.join(timeout=5)

        return stopper

    def global_map(self, max_points: int = 1 << 18) -> np.ndarray:
        """The assembled global map: a prefix of every keyframe's cloud in
        the map frame (the per-keyframe budget rounded down to a power of
        two), merged, stride-subsampled to ``max_points`` and
        voxel-downsampled at ``map_leaf_size``. Peer keyframes have no
        cloud here."""
        with self._write_lock:
            n = int(self.state.counts.sum())
            if n == 0:
                return np.zeros((0, 3), np.float32)
            P = self.cfg.keyframe.points_per_keyframe
            per = max(1, min(P, max_points // n))
            per = 1 << (per.bit_length() - 1)
            world, mask = _gather_global_map(self.state, per)
        merged = world.reshape(-1, 3)[mask.reshape(-1)]
        if merged.shape[0] == 0:
            return np.zeros((0, 3), np.float32)
        cloud = pc.from_points(merged, min(merged.shape[0], max_points))
        ds = pc.voxel_downsample(cloud, self.cfg.keyframe.map_leaf_size)
        return to_numpy(ds.xyz[ds.mask])

    def loop_constraints(self) -> list[dict]:
        """The loop factors of the graph (every edge but the odometry
        chain): endpoint slots, their optimized positions, ``intra`` or
        ``inter``, and the factor's sigma."""
        K = self.cfg.keyframe.max_keyframes
        with self._write_lock:
            g = self.state.graph
            n = int(g.num_edges)
            i, j = to_numpy(g.i[:n]), to_numpy(g.j[:n])
            si = to_numpy(g.sqrt_info[:n, 0])
            opt_t = to_numpy(self.state.opt_t)
        out = []
        for e in range(n):
            a, b = int(i[e]), int(j[e])
            if b - a == 1 and a // K == b // K:
                continue  # odometry edge
            out.append({
                "i": a, "j": b, "pi": opt_t[a].tolist(), "pj": opt_t[b].tolist(),
                "kind": "intra" if a // K == b // K else "inter",
                "sigma": float(1.0 / max(float(si[e]), 1e-9)),
            })
        return out
