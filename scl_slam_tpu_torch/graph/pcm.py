"""Pairwise Consistency Maximization (PCM) outlier rejection (port of
``scl_slam_tpu/graph/pcm.py``; the reference's ``distributed_pcm`` +
``fast_max-clique_finder``, enabled by ``usePCM`` with ``pcmThreshold``
0.75).

Two loop measurements z_p, z_q are pairwise consistent when the cycle

    z_p^-1 * (a: i_p -> i_q) * z_q * (b: j_q -> j_p)

composes to about the identity under the current pose estimates. The
M x M consistency matrix is one batched composition over every pair; the
largest consistent set is approximated by the greedy maximum clique of the
JAX module (a fixed number of steps, no host read).
"""
from __future__ import annotations

import torch

from ..geometry import se3


def consistency_matrix(
    loops_i: se3.Pose,    # [M] poses of the anchor keyframes (robot a)
    loops_j: se3.Pose,    # [M] poses of the matched keyframes (robot b)
    loops_z: se3.Pose,    # [M] measured relative poses a_i -> b_j
    valid: torch.Tensor,  # [M] bool
) -> torch.Tensor:
    """[M, M] squared consistency error of every loop pair (p rows, q
    columns), ``inf`` where either loop is invalid."""
    M = loops_z.t.shape[0]

    def rows(p: se3.Pose) -> se3.Pose:      # element p of pair (p, q)
        return se3.Pose(p.R[:, None].expand(M, M, 3, 3), p.t[:, None].expand(M, M, 3))

    def cols(p: se3.Pose) -> se3.Pose:      # element q of pair (p, q)
        return se3.Pose(p.R[None].expand(M, M, 3, 3), p.t[None].expand(M, M, 3))

    a_rel = se3.between(rows(loops_i), cols(loops_i))
    b_rel = se3.between(cols(loops_j), rows(loops_j))
    cycle = se3.compose(
        se3.inverse(rows(loops_z)),
        se3.compose(a_rel, se3.compose(cols(loops_z), b_rel)),
    )
    err = torch.sum(se3.log(cycle) ** 2, dim=-1)
    both = valid[:, None] & valid[None, :]
    return torch.where(both, err, float("inf"))


def greedy_max_clique(adj: torch.Tensor, max_iters: int = 64) -> torch.Tensor:
    """Greedy maximum clique over a boolean adjacency matrix [M, M]:
    ``min(max_iters, M)`` steps, each adding the candidate with the most
    connections into the candidate set (the first such on ties, as
    ``argmax`` gives). Returns a bool membership mask [M]."""
    M = adj.shape[0]
    ar = torch.arange(M, device=adj.device)
    adj = adj & (ar[:, None] != ar[None, :])     # no self loops
    in_clique = torch.zeros(M, dtype=torch.bool, device=adj.device)
    candidates = torch.ones(M, dtype=torch.bool, device=adj.device)
    for _ in range(min(max_iters, M)):
        deg = torch.sum(adj & candidates[None, :], dim=1)
        deg = torch.where(candidates, deg, -1)
        best = torch.argmax(deg)
        can_add = candidates[best]
        in_clique = in_clique | ((ar == best) & can_add)
        candidates = candidates & adj[best] & (ar != best) & can_add
    return in_clique


def pcm_filter(
    loops_i: se3.Pose,
    loops_j: se3.Pose,
    loops_z: se3.Pose,
    valid: torch.Tensor,
    threshold: float = 0.75,
) -> torch.Tensor:
    """Accept mask over loops: the valid members of the largest pairwise-
    consistent set, ``threshold`` gating the cycle error's norm."""
    err = consistency_matrix(loops_i, loops_j, loops_z, valid)
    clique = greedy_max_clique(err < threshold * threshold)
    return clique & valid
