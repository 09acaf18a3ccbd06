"""Device-resident SLAM state (port of ``scl_slam_tpu/runtime/state.py``).

Fixed-capacity tensors with the JAX package's shapes and dtypes (int32
indices, f32 geometry, bool masks), so :func:`state_from_numpy` /
:func:`state_to_numpy` carry a state between the two packages exactly.
Keyframe slots are global: robot r, local index i -> slot
``r * max_keyframes + i``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import SlamConfig
from ..descriptors import base as desc_base
from ..descriptors import scan_context as sc
from ..geometry import se3
from ..graph import factors as F


class LoopQueue(NamedTuple):
    """Pending verified loop factors."""

    i: torch.Tensor          # [Q] int32 encoded (robot, keyframe index)
    j: torch.Tensor          # [Q] int32
    z_R: torch.Tensor        # [Q, 3, 3]
    z_t: torch.Tensor        # [Q, 3]
    noise: torch.Tensor      # [Q] ICP fitness
    count: torch.Tensor      # 0-d int32


class MapperState(NamedTuple):
    kf_xyz: torch.Tensor       # [S, P*3] keyframe clouds, xyz interleaved
    kf_mask: torch.Tensor      # [S, P] bool
    odom_R: torch.Tensor       # [S, 3, 3] odometry-frame poses
    odom_t: torch.Tensor       # [S, 3]
    opt_R: torch.Tensor        # [S, 3, 3] optimized map-frame poses
    opt_t: torch.Tensor        # [S, 3]
    stamps: torch.Tensor       # [S] f32
    counts: torch.Tensor       # [R] int32 per-robot keyframe counts
    desc_db: desc_base.DescriptorDB
    graph: F.FactorGraph
    loop_target: torch.Tensor  # [S] int32 accepted loop partner slot or -1
    loop_queue: LoopQueue
    loop_closed: torch.Tensor  # 0-d bool


def make_state(cfg: SlamConfig, device) -> MapperState:
    from ..descriptors import registry

    R = cfg.number_of_robots
    K = cfg.keyframe.max_keyframes
    P = cfg.keyframe.points_per_keyframe
    S = R * K
    Q = cfg.loop.queue_capacity

    def eye(n):
        return torch.eye(3, dtype=torch.float32, device=device).repeat(n, 1, 1)

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return MapperState(
        kf_xyz=torch.full((S, P * 3), 1e6, dtype=torch.float32, device=device),
        kf_mask=zeros(S, P, dtype=torch.bool),
        odom_R=eye(S),
        odom_t=zeros(S, 3),
        opt_R=eye(S),
        opt_t=zeros(S, 3),
        stamps=zeros(S),
        counts=zeros(R, dtype=torch.int32),
        desc_db=registry.get_family(cfg).make_db(S, device),
        graph=F.make_graph(
            cfg.optimizer.edge_capacity, cfg.optimizer.prior_capacity, device
        ),
        loop_target=torch.full((S,), -1, dtype=torch.int32, device=device),
        loop_queue=LoopQueue(
            i=zeros(Q, dtype=torch.int32),
            j=zeros(Q, dtype=torch.int32),
            z_R=eye(Q),
            z_t=zeros(Q, 3),
            noise=zeros(Q),
            count=zeros(dtype=torch.int32),
        ),
        loop_closed=zeros(dtype=torch.bool),
    )


def scan_context_config(cfg: SlamConfig) -> sc.ScanContextConfig:
    p = cfg.scan_context
    return sc.ScanContextConfig(
        num_rings=p.num_rings,
        num_sectors=p.num_sectors,
        max_radius=p.max_radius,
        lidar_height=p.lidar_height,
        num_candidates=p.num_candidates,
        exclude_recent=p.exclude_recent,
        distance_threshold=p.distance_threshold,
        max_bin_points=p.max_bin_points,
    )


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def state_leaves(state, prefix: str = "") -> dict:
    """The leaves of a state as ``{"desc_db.keys": leaf, ...}``: nested
    NamedTuple fields joined by dots, walked depth first in field order,
    which is the order of ``jax.tree_util.tree_flatten`` on the JAX
    package's MapperState (the checkpoint's ``leaf_{i}``)."""
    out: dict = {}
    for name, v in zip(state._fields, state):
        key = f"{prefix}{name}"
        if isinstance(v, tuple) and hasattr(v, "_fields"):
            out.update(state_leaves(v, key + "."))
        else:
            out[key] = v
    return out


def state_to_numpy(state) -> dict[str, np.ndarray]:
    """:func:`state_leaves` with every leaf as a numpy array.

    Takes this package's MapperState, and equally any tree of NamedTuples
    with the same field names whose leaves ``np.asarray`` reads — which is
    how a test flattens a ``scl_slam_tpu`` MapperState to hand over.
    """
    return {k: to_numpy(v) for k, v in state_leaves(state).items()}


# nested NamedTuple fields of MapperState, by field name
_NESTED = {
    "desc_db": desc_base.DescriptorDB,
    "graph": F.FactorGraph,
    "loop_queue": LoopQueue,
    "z": se3.Pose,
    "prior_z": se3.Pose,
}


def _from_numpy(cls, d: dict, device, prefix: str = ""):
    kwargs = {}
    for name in cls._fields:
        key = f"{prefix}{name}"
        if name in _NESTED:
            kwargs[name] = _from_numpy(_NESTED[name], d, device, key + ".")
        else:
            # np.array copies: the state is updated in place later
            kwargs[name] = torch.from_numpy(np.array(d[key])).to(device)
    return cls(**kwargs)


def state_from_numpy(d: dict[str, np.ndarray], device) -> MapperState:
    """Inverse of :func:`state_to_numpy`: build a MapperState on
    ``device`` from a flat dict of numpy arrays (dtypes kept as given)."""
    return _from_numpy(MapperState, d, device)
