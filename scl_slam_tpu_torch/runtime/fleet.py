"""Centralized multi-robot serving: every robot in one device-resident
state (port of ``scl_slam_tpu/runtime/fleet.py``).

The decentralized path (``Mapper`` over a bus) keeps one state per robot
and moves descriptors and verification clouds between them. When one card
serves the whole fleet, that replication is overhead: the one
:class:`MapperState` already partitions its fixed-capacity arrays by
robot, a keyframe ingested for robot r is visible to every query at once,
and an inter-robot verification needs no RPC, since both clouds are
resident. One solve optimizes the whole fleet.

A fleet step (``_fleet_step``) processes a batch of keyframes from any mix
of robots: the batched frame prep (kernel K2 in the descriptor build), the
mixed-robot block ingest, the batched intra ICP (kernel K1), then the
batched inter-robot RANSAC (kernel K1 for the 1-NN, kernel K6 for the
hypothesis scores). Where the JAX step decides under ``lax.cond`` whether
any lane verifies, the port reads that one flag on the host. RANSAC draws
from a counter hash of (seed, step, lane, hypothesis, sample), so the CPU
and the card draw alike; the step counter advances once per fleet batch.

Semantics are those of the JAX module: per robot equal to sequential
ingestion; across robots within one batch relaxed (inter retrieval sees
every batch-mate, and queue rows group intra before inter).
"""
from __future__ import annotations

import time

import torch

from ..config import SlamConfig
from ..descriptors import base, registry
from ..geometry import se3, so3
from ..ops import pointcloud as pc
from ..ops import registration as reg
from .mapper import (
    Mapper,
    _enqueue_intra_block,
    _gather_submap,
    _intra_verify_inputs,
    _locked,
    _prepare_frame,
    _scatter_rows_capped,
    _yaw_seed_pose,
    encode_kf,
)
from .state import LoopQueue, MapperState, to_numpy


def _ingest_prepared_fleet_block(
    state: MapperState, robots: torch.Tensor, poses: se3.Pose, smalls: pc.Cloud,
    descriptors, stamps: torch.Tensor, cfg: SlamConfig,
):
    """Mixed-robot B-frame ingestion, one row scatter per state array, in
    place (the caller has checked every robot's capacity).

    Frame b of robot r lands at block position ``counts[r] + rank_b``, where
    ``rank_b`` counts its earlier same-robot batch-mates, so each robot's
    slots stay consecutive and the previous same-robot frame (a batch-mate
    or the stored chain end) is at ``slot - 1``. Protocol indices continue
    each robot's chain; the odometry increment is taken from the previous
    same-robot frame. The optimized poses chain per robot with per-step
    orthonormalization: a host loop over B tiny composes with an [NR]
    carry (the JAX ``lax.scan``). The same between factors and priors, in
    the same rows, as B sequential single-frame ingests.

    Returns (state, slots [B], indices [B], counts_hist [B]): counts_hist[b]
    is robot ``robots[b]``'s keyframe count just after frame b's sequential
    insert (the submap clip the detection phases need).
    """
    K = cfg.keyframe.max_keyframes
    NR = cfg.number_of_robots
    B = stamps.shape[0]
    dev = stamps.device
    robots = robots.to(torch.int32)
    rl = robots.long()
    ar = torch.arange(B, dtype=torch.int32, device=dev)

    earlier = (rl[:, None] == rl[None, :]) & (ar[None, :] < ar[:, None])
    rank = earlier.sum(dim=1, dtype=torch.int32)
    counts0 = state.counts[rl]
    pos = counts0 + rank
    slots = robots * K + pos
    first = pos == 0  # the robot's first-ever keyframe

    pre_end = rl * K + torch.clamp(counts0 - 1, min=0).long()
    idx_base = torch.where(counts0 > 0, base.rows(state.desc_db, pre_end, ("index",))[0] + 1, 0)
    idxs = (idx_base + rank).to(torch.int32)

    # odometry increment from the previous same-robot frame: a batch-mate
    # when rank > 0, else the stored chain end
    j_prev = torch.where(earlier, ar[None, :], -1).max(dim=1).values
    in_batch = j_prev >= 0
    jp = torch.clamp(j_prev, min=0).long()
    prev_slots = torch.maximum(slots - 1, robots * K).long()
    prev_R = torch.where(in_batch[:, None, None], poses.R[jp], state.odom_R[prev_slots])
    prev_t = torch.where(in_batch[:, None], poses.t[jp], state.odom_t[prev_slots])
    incs = se3.between(se3.Pose(prev_R, prev_t), poses)

    # optimized-pose chaining, per robot in batch order
    chain_ends = torch.arange(NR, device=dev) * K + torch.clamp(
        state.counts[:NR].long() - 1, min=0
    )
    cR = list(state.opt_R[chain_ends].unbind(0))
    ct = list(state.opt_t[chain_ends].unbind(0))
    opt_R, opt_t = [], []
    for b, (r, f) in enumerate(zip(robots.tolist(), first.tolist())):
        if f:
            cR[r], ct[r] = so3.orthonormalize(poses.R[b]), poses.t[b]
        else:
            comp = se3.compose(se3.Pose(cR[r], ct[r]), se3.Pose(incs.R[b], incs.t[b]))
            cR[r], ct[r] = so3.orthonormalize(comp.R), comp.t
        opt_R.append(cR[r])
        opt_t.append(ct[r])

    # factor graph: a between factor slot-1 -> slot for every non-first
    # frame (batch row order), a prior for each first frame; rows past
    # capacity go to the scratch row (no-op when full)
    g = state.graph
    odom_si = torch.tensor([1.0 / s for s in cfg.optimizer.odometry_sigmas],
                           dtype=torch.float32, device=dev)
    prior_si = torch.tensor([1.0 / s for s in cfg.optimizer.prior_sigmas],
                            dtype=torch.float32, device=dev)
    keep_i = (~first).to(torch.int32)
    E = g.edge_capacity
    e_pos = g.num_edges + torch.cumsum(keep_i, 0, dtype=torch.int32) - keep_i
    e_ok = ~first & (e_pos < E)
    e_w = torch.where(e_ok, e_pos, E)
    f_i = first.to(torch.int32)
    P = g.prior_capacity
    p_pos = g.num_priors + torch.cumsum(f_i, 0, dtype=torch.int32) - f_i
    p_ok = first & (p_pos < P)
    p_w = torch.where(p_ok, p_pos, P)

    def edges(arr, rows):
        return _scatter_rows_capped(arr, rows, e_w, E)

    def priors(arr, rows):
        return _scatter_rows_capped(arr, rows, p_w, P)

    g = g._replace(
        i=edges(g.i, slots - 1),
        j=edges(g.j, slots),
        z=se3.Pose(edges(g.z.R, incs.R), edges(g.z.t, incs.t)),
        sqrt_info=edges(g.sqrt_info, odom_si.expand(B, 6)),
        num_edges=g.num_edges + e_ok.sum().to(torch.int32),
        prior_idx=priors(g.prior_idx, slots),
        prior_z=se3.Pose(priors(g.prior_z.R, poses.R), priors(g.prior_z.t, poses.t)),
        prior_sqrt_info=priors(g.prior_sqrt_info, prior_si.expand(B, 6)),
        num_priors=g.num_priors + p_ok.sum().to(torch.int32),
    )

    full, key = registry.get_family(cfg).parts(descriptors)
    base.db_insert_rows(state.desc_db, full, key, robots, idxs, slots)

    sl = slots.long()
    state.kf_xyz[sl] = smalls.xyz.reshape(B, -1)
    state.kf_mask[sl] = smalls.mask
    state.odom_R[sl] = poses.R
    state.odom_t[sl] = poses.t
    state.opt_R[sl] = torch.stack(opt_R)
    state.opt_t[sl] = torch.stack(opt_t)
    state.stamps[sl] = stamps
    state.counts.index_add_(0, rl, torch.ones_like(robots))
    return state._replace(graph=g), slots, idxs, pos + 1


def _detect_verify_inter_block(
    state: MapperState, seed: int, step: int, robots, slots, q_idxs, descs,
    cfg: SlamConfig,
):
    """Batched inter-robot loop closure for a fleet batch, without RPCs.

    One 'inter' retrieval for every frame (other robots' keyframes only);
    when any lane has a candidate (one host read), one batched RANSAC
    (:func:`reg.ransac_align_batched`: K1, then K6) aligns each candidate
    frame's resident cloud prefix (``icp_source_points``, a uniform
    subsample of the scramble-ordered storage), in the map frame, against
    the submap around its matched peer keyframe. Each verified factor
    z = T_pre^-1 ∘ (alignment ∘ T_cur) is queued once (an exclusive cumsum
    over the accepted lanes, scratch-row drop past capacity) and marks
    ``loop_target``.

    Returns (state, oks [B], peer_robot [B], peer_index [B], ratio [B]).
    """
    B = slots.shape[0]
    dtype, dev = state.opt_t.dtype, state.opt_t.device
    sl = slots.long()
    match = registry.get_family(cfg).query(state.desc_db, descs, robots, q_idxs, "inter")
    already = state.loop_target[sl] >= 0
    attempts = match.found & ~already
    pre_slots = torch.where(attempts, match.db_pos, slots)
    m_robs, m_idxs = match.robot, match.index
    cur_poses = se3.Pose(state.opt_R[sl], state.opt_t[sl])

    if bool(attempts.any()):
        n_src = min(cfg.loop.icp_source_points, cfg.keyframe.points_per_keyframe)
        clouds = pc.Cloud(
            state.kf_xyz[sl, : n_src * 3].reshape(B, n_src, 3), state.kf_mask[sl, :n_src]
        )
        worlds = pc.transform(clouds, cur_poses.R, cur_poses.t)
        # lanes without a candidate gather around their own slot: RANSAC
        # reads nothing of an inactive lane
        g_robs = torch.where(attempts, m_robs, robots).long()
        submaps = _gather_submap(state, pre_slots, g_robs, cfg, state.counts[g_robs])
        res = reg.ransac_align_batched(
            worlds, submaps, seed, step, attempts,
            num_hypotheses=cfg.loop.ransac_max_iter,
            inlier_thresh=cfg.loop.ransac_outlier_threshold,
            min_inlier_ratio=cfg.loop.ransac_inlier_ratio,
        )
        success, a_R, a_t, ratio = res.success, res.pose.R, res.pose.t, res.inlier_ratio
    else:
        success = torch.zeros((B,), dtype=torch.bool, device=dev)
        a_R = torch.eye(3, dtype=dtype, device=dev).expand(B, 3, 3)
        a_t = torch.zeros((B, 3), dtype=dtype, device=dev)
        ratio = torch.zeros((B,), dtype=dtype, device=dev)
    oks = attempts & success

    corrected = se3.compose(se3.Pose(a_R, a_t), cur_poses)
    ps = pre_slots.long()
    z = se3.between(se3.Pose(state.opt_R[ps], state.opt_t[ps]), corrected)
    noise = torch.clamp(1.0 - ratio, min=1e-3)

    lq = state.loop_queue
    Q = lq.i.shape[0]
    ok_i = oks.to(torch.int32)
    qpos = lq.count + torch.cumsum(ok_i, 0, dtype=torch.int32) - ok_i
    qoks = oks & (qpos < Q)
    pos_w = torch.where(qoks, qpos, Q)

    def rows(arr, new):
        return _scatter_rows_capped(arr, new, pos_w, Q)

    new_q = LoopQueue(
        i=rows(lq.i, encode_kf(m_robs, m_idxs)),
        j=rows(lq.j, encode_kf(robots, q_idxs)),
        z_R=rows(lq.z_R, z.R),
        z_t=rows(lq.z_t, z.t),
        noise=rows(lq.noise, noise),
        count=lq.count + qoks.sum().to(torch.int32),
    )
    state.loop_target[sl] = torch.where(qoks, pre_slots, state.loop_target[sl])
    state = state._replace(loop_queue=new_q, loop_closed=state.loop_closed | qoks.any())
    return state, oks, m_robs, m_idxs, ratio


def _fleet_step(
    state: MapperState, seed: int, step: int, robots, pose_R, pose_t, xyz, mask,
    stamps, cfg: SlamConfig,
):
    """One fleet batch (any mix of robots), in place:

    0. the batched frame prep (storage downsample + descriptor build);
    1. the mixed-robot block ingest (:func:`_ingest_prepared_fleet_block`);
    2. intra loops: one batched retrieval, one batched ICP on the lanes
       with a candidate (a host read decides whether any), the queue append;
    3. inter loops (:func:`_detect_verify_inter_block`), which read the
       post-intra ``loop_target``, so a frame whose intra loop was accepted
       is not verified again.

    Returns (state, (ok_intra, intra_index, fitness, ok_inter, peer,
    peer_index, inlier_ratio)), each [B].
    """
    B = stamps.shape[0]
    dtype, dev = state.opt_t.dtype, stamps.device
    robots = robots.to(torch.int32)
    smalls, descs = _prepare_frame(xyz, mask, cfg)
    state, slots, q_idxs, counts_hist = _ingest_prepared_fleet_block(
        state, robots, se3.Pose(pose_R, pose_t), smalls, descs, stamps, cfg
    )

    if cfg.loop.intra_enabled:
        sl = slots.long()
        match = registry.get_family(cfg).query(state.desc_db, descs, robots, q_idxs, "intra")
        attempts = match.found & ~(state.loop_target[sl] >= 0)
        match_slots = torch.where(attempts, match.db_pos, slots)
        init_poses = _yaw_seed_pose(se3.Pose(state.opt_R[sl], state.opt_t[sl]), match.yaw)
        if bool(attempts.any()):
            cur, tgt, _ = _intra_verify_inputs(
                state, slots, match_slots, match.yaw, robots, cfg, counts_hist
            )
            res = reg.icp_batched(
                pc.transform(cur, init_poses.R, init_poses.t),
                tgt,
                se3.identity((B,), dtype=dtype, device=dev),
                attempts,
                max_iters=cfg.loop.icp_iterations,
                max_corr_dist=cfg.loop.icp_max_corr_dist,
                tol=cfg.loop.icp_tol,
                coarse_factor=cfg.loop.icp_coarse_factor,
                gate_fitness=cfg.loop.history_fitness_score,
                target_stride=cfg.loop.icp_target_stride,
                reuse_final_fitness=cfg.loop.icp_reuse_final_fitness,
            )
            corrected = se3.compose(res.pose, init_poses)
            fits, corr_R, corr_t = res.fitness, corrected.R, corrected.t
        else:
            fits = torch.full((B,), float("inf"), dtype=dtype, device=dev)
            corr_R, corr_t = init_poses.R, init_poses.t
        state, ok_i = _enqueue_intra_block(
            state, robots, slots, match_slots, q_idxs, match.index, fits, attempts,
            corr_R, corr_t, cfg,
        )
        m_idxs = match.index
    else:
        m_idxs = torch.zeros((B,), dtype=torch.int32, device=dev)
        fits = torch.full((B,), float("inf"), dtype=dtype, device=dev)
        ok_i = torch.zeros((B,), dtype=torch.bool, device=dev)

    if cfg.loop.inter_enabled and cfg.number_of_robots > 1:
        state, ok_x, peers, p_idxs, ratios = _detect_verify_inter_block(
            state, seed, step, robots, slots, q_idxs, descs, cfg
        )
    else:
        ok_x = torch.zeros((B,), dtype=torch.bool, device=dev)
        peers = torch.zeros((B,), dtype=torch.int32, device=dev)
        p_idxs = torch.zeros((B,), dtype=torch.int32, device=dev)
        ratios = torch.zeros((B,), dtype=dtype, device=dev)
    return state, (ok_i, m_idxs, fits, ok_x, peers, p_idxs, ratios)


def _fleet_replay(
    state: MapperState, seed: int, step: int, robots, pose_R, pose_t, xyz, mask,
    stamps, cfg: SlamConfig,
):
    """R fleet batches in order (leaves [R, B, ...]): a host loop where the
    JAX package scans them in one device program, with the RANSAC step
    counter advancing per batch. Returns (state, next step, the
    :func:`_fleet_step` outputs flattened to [R*B])."""
    outs = []
    for r in range(robots.shape[0]):
        state, out = _fleet_step(
            state, seed, step + r, robots[r], pose_R[r], pose_t[r], xyz[r], mask[r],
            stamps[r], cfg,
        )
        outs.append(out)
    return state, step + robots.shape[0], tuple(torch.cat(o) for o in zip(*outs))


def _events(robots: list[int], outs) -> list[dict]:
    """One event dict per processed keyframe, with the intra and inter
    loops accepted for it."""
    ok_i, idx_i, fit, ok_x, peer, p_idx, ratio = (to_numpy(o) for o in outs)
    events = []
    for b, r in enumerate(robots):
        ev: dict = {"robot": r}
        if ok_i[b]:
            ev["loop"] = {"matched_index": int(idx_i[b]), "fitness": float(fit[b])}
        if ok_x[b]:
            ev["inter_loop"] = {
                "robot": int(peer[b]),
                "matched_index": int(p_idx[b]),
                "inlier_ratio": float(ratio[b]),
            }
        events.append(ev)
    return events


class FleetMapper(Mapper):
    """Serve N robots' SLAM sessions from one shared state on ``device``
    (the card unless ``device="cpu"``).

    Feed odometry frames per robot with :meth:`add_robot_frame` (keyframe
    gate per robot); :meth:`step` then processes every staged keyframe as
    one fleet batch; :meth:`spin` runs the throttled joint solve. What
    :class:`Mapper` offers on the whole state (``trajectory``,
    ``full_trajectory``, ``save_trajectories``, ``loop_constraints``,
    ``optimize``, eviction) works unchanged: the state layout is the same,
    only the feeding path differs.
    """

    def __init__(self, cfg: SlamConfig, device="cuda"):
        super().__init__(cfg, device)
        self._fleet_last_pose: dict = {}
        self._fleet_staged: list[tuple] = []
        self._staged_per_robot: dict[int, int] = {}
        # RANSAC draws: the JAX key's seed (robot_id + 101) and the count
        # of fleet batches processed
        self._fleet_seed = cfg.robot_id + 101
        self._fleet_steps = 0

    # -- feeding --
    def _gate(self, robot: int, pose) -> bool:
        """Per-robot keyframe gate (the reference's ``saveFrame``)."""
        return self._moved_enough(self._fleet_last_pose.get(robot), pose)

    @_locked
    def add_robot_frame(self, robot: int, pose, xyz, stamp: float = 0.0) -> bool:
        """Gate + stage one robot's odometry frame (``pose`` with ``.R`` /
        ``.t``, tensors or arrays; ``xyz`` [N, 3]). Returns True when it
        became a keyframe (processed at the next :meth:`step`)."""
        if not 0 <= robot < self.cfg.number_of_robots:
            raise ValueError(f"robot {robot} out of range")
        if not self._gate(robot, pose):
            return False
        self._fleet_last_pose[robot] = pose
        self._fleet_staged.append((robot, pose, to_numpy(xyz), float(stamp)))
        self._staged_per_robot[robot] = self._staged_per_robot.get(robot, 0) + 1
        return True

    def _stage_batch(self, part: list[tuple]):
        """Robots [n] int32 and the padded device batch of staged frames."""
        poses = [p for _, p, _, _ in part]
        scans = [s for _, _, s, _ in part]
        stamps = [st for *_, st in part]
        pose_b, xyz, mask, st = self._stage(poses, scans, stamps, range(len(part)))
        robots = torch.tensor([r for r, *_ in part], dtype=torch.int32, device=self.device)
        return robots, pose_b, xyz, mask, st

    # -- processing --
    @_locked
    def step(self) -> list[dict]:
        """Process every staged keyframe as one fleet batch. Returns one
        event dict per keyframe, with the intra and inter loops found for
        it."""
        if not self._fleet_staged:
            return []
        # compact each robot's block before the batch lands (eviction)
        for r, n_staged in self._staged_per_robot.items():
            self._ensure_capacity(n_staged, r)
        staged, self._fleet_staged = self._fleet_staged, []
        self._staged_per_robot = {}
        robots, pose_b, xyz, mask, st = self._stage_batch(staged)
        with self._write_lock:
            self.state, outs = _fleet_step(
                self.state, self._fleet_seed, self._fleet_steps, robots, pose_b.R,
                pose_b.t, xyz, mask, st, self.cfg,
            )
        self._fleet_steps += 1
        return _events([r for r, *_ in staged], outs)

    @_locked
    def replay(self, frames, apply_gate: bool = True, batch: int = 16,
               chunk_batches: int = 8) -> dict:
        """Whole-stream multi-robot replay (the fleet's counterpart of
        :meth:`Mapper.replay`). ``frames`` is the arrival-ordered stream of
        ``(robot, pose, scan[, stamp])``. Frames are gated per robot;
        accepted keyframes go ``batch * chunk_batches`` at a time through
        :func:`_fleet_replay`, the remainder through :meth:`step`. Returns
        ``{"accepted": [...], "events": [...], "keyframes": {robot: n}}``
        with one event per accepted keyframe."""
        accepted, sel = [], []
        for rec in frames:
            robot, pose, scan, stamp = rec if len(rec) == 4 else (*rec, 0.0)
            take = (not apply_gate) or self._gate(robot, pose)
            accepted.append(take)
            if take:
                self._fleet_last_pose[robot] = pose
                sel.append((robot, pose, to_numpy(scan), float(stamp)))

        B, R = batch, chunk_batches
        chunk = B * R
        events: list[dict] = []
        pos = 0
        while len(sel) - pos >= chunk:
            part = sel[pos : pos + chunk]
            per_robot: dict[int, int] = {}
            for r, *_ in part:
                per_robot[r] = per_robot.get(r, 0) + 1
            for r, n_new in per_robot.items():
                self._ensure_capacity(n_new, r)
            self._ensure_queue_headroom(chunk)
            robots, pose_b, xyz, mask, st = self._stage_batch(part)
            with self._write_lock:
                self.state, self._fleet_steps, outs = _fleet_replay(
                    self.state, self._fleet_seed, self._fleet_steps,
                    robots.reshape(R, B), pose_b.R.reshape(R, B, 3, 3),
                    pose_b.t.reshape(R, B, 3), xyz.reshape(R, B, *xyz.shape[1:]),
                    mask.reshape(R, B, -1), st.reshape(R, B), self.cfg,
                )
            events.extend(_events([r for r, *_ in part], outs))
            pos += chunk
        for rec in sel[pos:]:  # already gated
            self._fleet_staged.append(rec)
            self._staged_per_robot[rec[0]] = self._staged_per_robot.get(rec[0], 0) + 1
        if self._fleet_staged:
            events.extend(self.step())
        return {
            "accepted": accepted,
            "events": events,
            "keyframes": {
                r: int(self.state.counts[r]) for r in range(self.cfg.number_of_robots)
            },
        }

    @_locked
    def spin(self, now: float | None = None) -> dict:
        """The throttled joint solve (``spin_once`` without the per-robot
        detection: the fleet detects inside :meth:`step`): drain and solve
        when a loop closed and ``mapping_process_interval`` seconds have
        passed since the last solve (``now`` drives the throttle from a
        simulated clock; default ``time.monotonic()``)."""
        now = time.monotonic() if now is None else now
        info: dict = {}
        due = (now - self._last_opt_time) >= self.cfg.optimizer.mapping_process_interval
        if bool(self.state.loop_closed) and due:
            info["chi2"] = self.optimize()
            self._last_opt_time = now
        return info
