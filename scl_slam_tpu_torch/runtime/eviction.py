"""Keyframe eviction and block compaction (port of
``scl_slam_tpu/runtime/eviction.py``).

Every robot's keyframes live in a fixed-capacity block of
``max_keyframes`` slots. When a block fills, this module evicts redundant
keyframes and compacts the block, so a session runs on past capacity.

Policy (``plan_keep``): keep the block's first frame (the gauge anchor),
the ``evict_keep_recent`` newest frames, and every frame that anchors a
loop (a non-chain graph edge, an accepted ``loop_target`` pair, a queued
loop, a prior); of the rest keep every ``evict_stride``-th. The odometry
factors across a gap are recomposed from the stored odometry poses
exactly, with the variance scaled by the gap.

It runs on the host in numpy, as in the JAX package: eviction fires once
per ~``max_keyframes / 2`` keyframes, so an O(K) host pass is amortized,
and every device step keeps its shapes. Protocol keyframe indices are
never renumbered; only block positions change.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import SlamConfig
from ..geometry import se3
from ..graph.factors import FactorGraph
from .state import MapperState, to_numpy


def _between_np(Ra, ta, Rb, tb):
    """T_a^-1 ∘ T_b in numpy: (R, t)."""
    R = Ra.T @ Rb
    t = Ra.T @ (tb - ta)
    return R, t


def plan_keep(state: MapperState, cfg: SlamConfig, robot: int) -> np.ndarray:
    """Boolean keep-mask over the robot's resident block positions."""
    from .mapper import IDX_BASE

    K = cfg.keyframe.max_keyframes
    lo = robot * K
    n = int(state.counts[robot])
    keep = np.zeros(n, bool)
    keep[0] = True
    keep_recent = min(cfg.keyframe.evict_keep_recent, n)
    keep[n - keep_recent:] = True

    # loop anchors from the factor graph: any non-chain edge touching the block
    g = state.graph
    ne = int(g.num_edges)
    gi = to_numpy(g.i[:ne])
    gj = to_numpy(g.j[:ne])
    chain = (gj == gi + 1) & (gi // K == gj // K)
    for ends in (gi[~chain], gj[~chain]):
        inb = ends[(ends >= lo) & (ends < lo + n)] - lo
        keep[inb] = True
    # priors
    npri = int(g.num_priors)
    pidx = to_numpy(g.prior_idx[:npri])
    keep[pidx[(pidx >= lo) & (pidx < lo + n)] - lo] = True
    # accepted loops not drained yet (loop_target pairs)
    partners_all = to_numpy(state.loop_target)
    keep[partners_all[lo : lo + n] >= 0] = True
    partners = partners_all[(partners_all >= lo) & (partners_all < lo + n)] - lo
    keep[partners] = True
    # queued loops ((robot, index) encoded: match by index)
    q = state.loop_queue
    qn = int(q.count)
    indices = to_numpy(state.desc_db.index[lo : lo + n])
    for enc in np.concatenate([to_numpy(q.i[:qn]), to_numpy(q.j[:qn])]):
        if enc // IDX_BASE == robot:
            keep[np.nonzero(indices == enc % IDX_BASE)[0]] = True

    # decimate the rest
    evictable = np.nonzero(~keep)[0]
    keep[evictable[:: cfg.keyframe.evict_stride]] = True

    if keep.all():
        # everything anchored or recent: drop the oldest quarter of the
        # non-recent frames (not position 0) with their loop edges, or the
        # session could not go on
        candidates = np.arange(1, max(n - keep_recent, 2))
        keep[candidates[: max(len(candidates) // 4, 1)]] = False
    return keep


def compact_robot(
    state: MapperState, cfg: SlamConfig, robot: int
) -> tuple[MapperState, list[dict]]:
    """Evict + compact one robot's block. Returns (new state, evicted
    records): each record holds (index, stamp, pose [4, 4]) with the pose
    frozen at its current optimized estimate (fixed-lag semantics), for
    the caller's archive. The new state's tensors are fresh, on the old
    state's device."""
    K = cfg.keyframe.max_keyframes
    S = state.kf_xyz.shape[0]
    dev = state.kf_xyz.device
    lo = robot * K
    n = int(state.counts[robot])
    keep = plan_keep(state, cfg, robot)
    kept_pos = np.nonzero(keep)[0]
    dropped_pos = np.nonzero(~keep)[0]
    m = len(kept_pos)

    # old global slot -> new global slot (-1 = evicted)
    slotmap = np.arange(S, dtype=np.int64)
    slotmap[lo : lo + n] = -1
    slotmap[lo + kept_pos] = lo + np.arange(m)

    opt_R = to_numpy(state.opt_R[lo : lo + n])
    opt_t = to_numpy(state.opt_t[lo : lo + n])
    odom_R = to_numpy(state.odom_R[lo : lo + n])
    odom_t = to_numpy(state.odom_t[lo : lo + n])
    stamps = to_numpy(state.stamps[lo : lo + n])
    indices = to_numpy(state.desc_db.index[lo : lo + n])

    evicted = []
    for p in dropped_pos:
        T = np.eye(4)
        T[:3, :3] = opt_R[p]
        T[:3, 3] = opt_t[p]
        evicted.append({"index": int(indices[p]), "stamp": float(stamps[p]), "pose": T})

    def compact_rows(arr, fill):
        a = to_numpy(arr)
        out = a.copy()
        out[lo : lo + m] = a[lo + kept_pos]
        out[lo + m : lo + K] = fill
        return out

    def dev_t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    eye = np.eye(3, dtype=np.float32)
    db = state.desc_db
    lt = to_numpy(state.loop_target)
    # loop_target: compact positions, remap partner values
    lt_vals = np.where(lt >= 0, slotmap[np.clip(lt, 0, S - 1)], -1).astype(np.int32)
    new_index = compact_rows(db.index, -1)

    # ---- factor graph rebuild ----
    g = state.graph
    ne = int(g.num_edges)
    gi = to_numpy(g.i[:ne])
    gj = to_numpy(g.j[:ne])
    gzR = to_numpy(g.z.R[:ne])
    gzt = to_numpy(g.z.t[:ne])
    gsq = to_numpy(g.sqrt_info[:ne])

    in_block_i = (gi >= lo) & (gi < lo + n)
    in_block_j = (gj >= lo) & (gj < lo + n)
    chain = (gj == gi + 1) & (gi // K == gj // K) & in_block_i & in_block_j
    mi = slotmap[np.clip(gi, 0, S - 1)]
    mj = slotmap[np.clip(gj, 0, S - 1)]
    keep_edge = ~chain & (mi >= 0) & (mj >= 0)

    ei = list(mi[keep_edge])
    ej = list(mj[keep_edge])
    ezR = list(gzR[keep_edge])
    ezt = list(gzt[keep_edge])
    esq = list(gsq[keep_edge])

    # recomposed odometry chain over kept positions (exact composition of
    # the stored odometry poses; variance grows linearly with the gap)
    odom_sigma = np.asarray(cfg.optimizer.odometry_sigmas, np.float64)
    for k, (a, b) in enumerate(zip(kept_pos[:-1], kept_pos[1:])):
        R, t = _between_np(odom_R[a], odom_t[a], odom_R[b], odom_t[b])
        gap = float(b - a)
        ei.append(lo + k)
        ej.append(lo + k + 1)
        ezR.append(R.astype(np.float32))
        ezt.append(t.astype(np.float32))
        esq.append((1.0 / (odom_sigma * np.sqrt(gap))).astype(np.float32))

    E = g.edge_capacity
    if len(ei) > E:
        raise RuntimeError(f"compacted graph needs {len(ei)} edges > capacity {E}")
    ni = np.zeros(E, np.int32)
    nj = np.zeros(E, np.int32)
    nzR = np.tile(eye, (E, 1, 1))
    nzt = np.zeros((E, 3), np.float32)
    nsq = np.zeros((E, 6), np.float32)
    ncount = len(ei)
    if ncount:
        ni[:ncount] = ei
        nj[:ncount] = ej
        nzR[:ncount] = np.stack(ezR)
        nzt[:ncount] = np.stack(ezt)
        nsq[:ncount] = np.stack(esq)

    npri = int(g.num_priors)
    pidx = to_numpy(g.prior_idx[:npri])
    pmap = slotmap[np.clip(pidx, 0, S - 1)]
    pkeep = pmap >= 0
    P = g.prior_capacity
    npidx = np.zeros(P, np.int32)
    npzR = np.tile(eye, (P, 1, 1))
    npzt = np.zeros((P, 3), np.float32)
    npsq = np.zeros((P, 6), np.float32)
    pc = int(pkeep.sum())
    npidx[:pc] = pmap[pkeep]
    npzR[:pc] = to_numpy(g.prior_z.R[:npri])[pkeep]
    npzt[:pc] = to_numpy(g.prior_z.t[:npri])[pkeep]
    npsq[:pc] = to_numpy(g.prior_sqrt_info[:npri])[pkeep]

    new_graph = FactorGraph(
        i=dev_t(ni),
        j=dev_t(nj),
        z=se3.Pose(dev_t(nzR), dev_t(nzt)),
        sqrt_info=dev_t(nsq),
        num_edges=torch.tensor(ncount, dtype=torch.int32, device=dev),
        prior_idx=dev_t(npidx),
        prior_z=se3.Pose(dev_t(npzR), dev_t(npzt)),
        prior_sqrt_info=dev_t(npsq),
        num_priors=torch.tensor(pc, dtype=torch.int32, device=dev),
    )

    new_counts = to_numpy(state.counts).copy()
    new_counts[robot] = m
    new_state = state._replace(
        kf_xyz=dev_t(compact_rows(state.kf_xyz, 1e6)),
        kf_mask=dev_t(compact_rows(state.kf_mask, False)),
        odom_R=dev_t(compact_rows(state.odom_R, eye)),
        odom_t=dev_t(compact_rows(state.odom_t, 0.0)),
        opt_R=dev_t(compact_rows(state.opt_R, eye)),
        opt_t=dev_t(compact_rows(state.opt_t, 0.0)),
        stamps=dev_t(compact_rows(state.stamps, 0.0)),
        counts=dev_t(new_counts),
        desc_db=db._replace(
            descriptors=dev_t(compact_rows(db.descriptors, 0)),
            keys=dev_t(compact_rows(db.keys, 0)),
            robot=dev_t(compact_rows(db.robot, -1)),
            index=dev_t(new_index),
            count=torch.tensor(int((new_index >= 0).sum()), dtype=torch.int32, device=dev),
        ),
        graph=new_graph,
        loop_target=dev_t(compact_rows(lt_vals, -1)),
    )
    return new_state, evicted
