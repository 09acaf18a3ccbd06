"""Distributed descriptor retrieval and pose-graph solve over a
``torch.distributed`` group (port of ``scl_slam_tpu/parallel/sharded.py``).

- The **descriptor DB is sharded by rows**: rank r holds rows
  ``[r S / D, (r + 1) S / D)``. A query takes the local top-k on the
  rank's own rows, gathers the ``D x k`` candidates and takes the global
  top-k (:func:`sharded_topk`).
- The **factor graph is sharded by edges**: the poses are replicated, each
  rank linearizes its ``E / D`` edges, and an all-reduce sums the
  Gauss-Newton products (:func:`sharded_solve`).

The JAX module writes both with ``shard_map`` and lets XLA place the
collectives. Here each is explicit, and only ``all_reduce(SUM)`` and
``broadcast`` are used: a gather is the all-reduce of a zero-filled
``[world, ...]`` buffer in which each rank fills its own row, summed as
32-bit integer words so that the rows come back bit for bit. That is what
lets two ranks share one card over gloo (which takes CUDA tensors for
these two collectives alone), and NCCL and gloo then run the same code.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..geometry import se3
from ..graph import factors as F
from ..graph import solver

# collectives issued since the last reset_counts(): all-reduce calls and
# bytes, broadcast calls
COUNTS = {"all_reduce": 0, "all_reduce_bytes": 0, "broadcast": 0}


def reset_counts() -> None:
    for k in COUNTS:
        COUNTS[k] = 0


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the group in place; returns it."""
    COUNTS["all_reduce"] += 1
    COUNTS["all_reduce_bytes"] += t.numel() * t.element_size()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def broadcast(t: torch.Tensor, group=None) -> torch.Tensor:
    """The group's first rank's ``t`` on every rank, in place; returns it."""
    COUNTS["broadcast"] += 1
    src = 0 if group is None else dist.get_global_rank(group, 0)
    dist.broadcast(t, src=src, group=group)
    return t


def group_rank(group=None) -> tuple[int, int]:
    """(this process's rank in ``group``, the group's size)."""
    return dist.get_rank(group), dist.get_world_size(group)


def _as_words(t: torch.Tensor):
    """``t`` as int32 words, and the map back: 4-byte types by a view,
    8-byte types by a view of two words each, bool and narrower integers
    widened (exactly)."""
    dtype, shape = t.dtype, t.shape
    t = t.contiguous()
    if dtype.itemsize == 4:
        return t.view(torch.int32), lambda w: w.view(dtype)
    if dtype.itemsize == 8:
        return (t.reshape(*shape, 1).view(torch.int32),
                lambda w: w.view(dtype).reshape(*w.shape[:-1]))
    if dtype.is_floating_point:
        raise TypeError(f"no exact gather of {dtype}")
    return t.to(torch.int32), lambda w: w.to(dtype)


def gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``t`` stacked in rank order, [world, *t.shape], bit
    for bit: one all-reduce of a zero-filled buffer."""
    rank, world = group_rank(group)
    words, back = _as_words(t)
    buf = words.new_zeros((world, *words.shape))
    buf[rank] = words
    return back(all_reduce(buf, group))


def sharded_topk(group, db_keys, query_key, mask, k: int, row0: int | None = None):
    """Global top-k nearest keys over a row-sharded DB: ``db_keys`` [n, D]
    and ``mask`` [..., n] are this rank's rows, whose first is global row
    ``row0`` (rank * n by default); ``query_key`` [..., D]. Returns (d2
    [..., k], global position [..., k] int64), the same on every rank.

    The local top-k (ties to the lower row) is gathered in rank order and
    ranked by (d2, position): ties go to the lowest global position, the
    contract of ``descriptors/base.topk_by_key`` on the whole DB."""
    rank, world = group_rank(group)
    n = db_keys.shape[0]
    if row0 is None:
        row0 = rank * n
    d2 = torch.sum((db_keys - query_key[..., None, :]) ** 2, dim=-1)
    d2 = torch.where(mask, d2, float("inf"))
    vals, pos = torch.sort(d2, dim=-1, stable=True)
    kk = min(k, n)
    vals, pos = vals[..., :kk], pos[..., :kk] + row0
    if kk < k:   # a shard of fewer than k rows: pads that rank last
        pad = (*vals.shape[:-1], k - kk)
        vals = torch.cat([vals, vals.new_full(pad, float("inf"))], -1)
        pos = torch.cat([pos, pos.new_full(pad, torch.iinfo(torch.int64).max)], -1)
    all_d2 = torch.movedim(gather(vals, group), 0, -2).flatten(-2)     # [..., world*k]
    all_pos = torch.movedim(gather(pos, group), 0, -2).flatten(-2)
    by_pos = torch.argsort(all_pos, dim=-1)
    d2_p = torch.gather(all_d2, -1, by_pos)
    vals2, sel = torch.sort(d2_p, dim=-1, stable=True)
    pos2 = torch.gather(torch.gather(all_pos, -1, by_pos), -1, sel)
    return vals2[..., :k], pos2[..., :k]


def edge_shard(g: F.FactorGraph, rank: int, world: int) -> F.FactorGraph:
    """Rank ``rank``'s edges of ``g``, rows ``[rank E / D, (rank + 1) E /
    D)``, with the validity of their global edge ids, and the priors on
    rank 0 only (they are replicated)."""
    E = g.edge_capacity
    if E % world:
        raise ValueError(f"edge_capacity {E} not divisible by {world} ranks")
    n = E // world
    lo = rank * n
    rows = slice(lo, lo + n)
    return g._replace(
        i=g.i[rows], j=g.j[rows], z=se3.Pose(g.z.R[rows], g.z.t[rows]),
        sqrt_info=g.sqrt_info[rows],
        num_edges=torch.clamp(g.num_edges - lo, 0, n).to(g.num_edges.dtype),
        num_priors=g.num_priors if rank == 0 else torch.zeros_like(g.num_priors),
    )


def sharded_solve(
    group,
    g: F.FactorGraph,
    poses: se3.Pose,
    gn_iters: int = 8,
    cg_iters: int = 48,
    damping: float = 1e-6,
    gamma: float = 1.0,
    rotation_change_threshold: float = 0.0,
    pose_change_threshold: float = 0.0,
    coarse_stride: int = -1,
    coarse_levels: int = 1,
):
    """Distributed Gauss-Newton: edges sharded over ``group``, poses
    replicated. Every rank passes the whole graph and the same poses and
    linearizes its own edge shard (:func:`edge_shard`); an all-reduce sums
    the block diagonal, the right-hand side, every PCG step's J^T W J x,
    the dense coarse matrix and chi2.

    What each rank computes for itself must stay the same on every rank:
    each applies its edges to its own copy of PCG's search direction, and
    where the copies part, the summed operator is no longer one symmetric
    matrix. The CPU's scatter-sums are deterministic; the card's run on
    atomics, and two ranks sharing an H100 broke down (at "p.Ap <= 0" or a
    non-finite PCG step) in 2 of 3 solves at 16,384 poses until rank 0's
    start poses and every coarse correction (its restriction is a
    scatter-sum) were broadcast.
    Returns (poses, chi2_history
    [gn_iters], breakdown), the same on every rank; ``chi2_history[k]`` is
    the chi2 at step k's linearization point, ``breakdown`` the port's own
    0-d code of the first step that broke down (``solver.breakdown_stages``;
    0 where none did).

    The steps are the port's single-device ones (``solver.gn_step``,
    given the all-reduce and the broadcast): its linearization (the
    closed-form Jacobians times ``_arccos_tangent``), block-Jacobi PCG
    with the r.z clamp, and the dense Galerkin coarsest level at
    ``coarse_stride ** coarse_levels`` (-1: ``auto_coarse`` from the pose
    count; 0: none), which seeds and closes every PCG solve. As in the JAX
    function there are no intermediate Jacobi levels and no robust kernel.
    ``gamma`` over-relaxes each update (new = retract(cur, gamma dx)), and
    the iteration freezes once the largest per-pose update is below both
    change thresholds (rotation |dx[:, :3]| in rad, translation |dx[:, 3:]|
    in m); a threshold <= 0 always passes, and with both <= 0 every step
    runs. Where a threshold is set, each step reads rank 0's freeze flag
    to the host, and a frozen solve stops there (the JAX function scans
    on with the poses held; the history repeats the frozen point's chi2).
    """
    rank, world = group_rank(group)
    local = edge_shard(g, rank, world)

    def reduce(t):
        return all_reduce(t, group)

    def share(t):
        return broadcast(t, group)

    if coarse_stride < 0:
        coarse_stride, coarse_levels = solver.auto_coarse(poses.t.shape[0])
    enabled = rotation_change_threshold > 0 or pose_change_threshold > 0
    cur = se3.Pose(share(poses.R.clone()), share(poses.t.clone()))
    done = torch.zeros((), dtype=torch.bool, device=poses.t.device)
    chis = []
    breakdown = torch.zeros((), dtype=torch.int32, device=poses.t.device)
    for step in range(gn_iters):
        if enabled and step and bool(share(done.to(torch.int32))):
            # frozen: every later step's linearization point is cur
            chis += [reduce(F.chi2(local, cur).reshape(1))[0]] * (gn_iters - step)
            break
        st = solver.gn_step(local, cur, cg_iters, damping, float("inf"), coarse_stride,
                            coarse_levels, reduce=reduce, share=share)
        dx = gamma * st.dx
        # below both thresholds (one <= 0 always passes): the next step
        # reads the freeze (done is False here: a frozen solve has stopped)
        done = torch.ones_like(done)
        for thr, part in ((rotation_change_threshold, dx[:, :3]),
                          (pose_change_threshold, dx[:, 3:])):
            if thr > 0:
                done = done & (torch.linalg.norm(part, dim=-1).max() < thr)
        chis.append(reduce(F.chi2(local, cur).reshape(1))[0])
        # (its chi2 flag reads the chi2 at this step's linearization point)
        breakdown = solver.note_breakdown(breakdown, step, st, dx, chis[-1])
        cur = se3.retract(cur, dx)
    return cur, torch.stack(chis) if chis else poses.t.new_zeros((0,)), breakdown
