"""Descriptor-family dispatch (port of
``scl_slam_tpu/descriptors/registry.py``): Scan Context, LiDAR-Iris, M2DP,
GRSD, FPFH and SHOT behind one batched protocol, chosen by
``SlamConfig.descriptor_type``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from ..config import DescriptorType, SlamConfig
from . import geometric, lidar_iris, m2dp, scan_context, shot


@dataclass(frozen=True)
class Family:
    """One descriptor family behind the uniform protocol.

    ``make(cloud)`` encodes a batch of clouds; ``make_db(capacity,
    device)`` allocates its DB; ``from_db(db, slots)`` reads the stored
    descriptors of slots [B] back as a batch; ``query(db, desc, robot,
    indices, mode)`` retrieves for a batch of frames; ``parts(desc)`` gives
    the (full DB array, retrieval key) pair that ``base.db_insert_block``
    stores; ``to_wire(desc)`` flattens one descriptor for broadcast and
    ``from_wire(values)`` decodes one; ``insert(db, desc, robot, index,
    pos)`` stores one descriptor at slot ``pos``; ``wire_dim`` is the
    length of a wire vector.
    """

    name: str
    make: Callable
    make_db: Callable
    from_db: Callable
    query: Callable
    parts: Callable
    to_wire: Callable
    from_wire: Callable
    insert: Callable
    wire_dim: int


def _vector_family(name: str, make_fn, dim: int, params) -> Family:
    """GRSD, FPFH, SHOT and M2DP share the plain-vector protocol: a
    ``geometric.Vector`` that is its own key and wire vector."""
    return Family(
        name=name,
        make=lambda cloud: geometric.Vector(make_fn(cloud).descriptor),
        make_db=lambda capacity, device: geometric.make_db(capacity, dim, device),
        from_db=lambda db, slots: geometric.Vector(db.descriptors[slots]),
        query=lambda db, d, r, i, mode: geometric.vector_query(
            db, d.descriptor, r, i,
            num_candidates=params.num_candidates,
            exclude_recent=params.exclude_recent,
            threshold=params.distance_threshold,
            mode=mode,
        ),
        parts=lambda d: (d.descriptor, d.descriptor),
        to_wire=lambda d: d.descriptor,
        from_wire=geometric.Vector,
        insert=geometric.insert,
        wire_dim=dim,
    )


def exclude_recent(cfg: SlamConfig) -> int:
    """The active family's recent-exclusion window (host-side gating must
    match what the family's query masks)."""
    params = {
        DescriptorType.SCAN_CONTEXT: cfg.scan_context,
        DescriptorType.LIDAR_IRIS: cfg.lidar_iris,
        DescriptorType.M2DP: cfg.m2dp,
        DescriptorType.GRSD: cfg.grsd,
        DescriptorType.FPFH: cfg.fpfh,
        DescriptorType.SHOT: cfg.shot,
    }.get(cfg.descriptor_type)
    if params is None:
        raise ValueError(f"unknown descriptor type {cfg.descriptor_type}")
    return params.exclude_recent


def get_family(cfg: SlamConfig) -> Family:
    kind = cfg.descriptor_type
    if kind == DescriptorType.SCAN_CONTEXT:
        from ..runtime.state import scan_context_config

        sc_cfg = scan_context_config(cfg)
        return Family(
            name="scan_context",
            make=lambda cloud: scan_context.make(cloud, sc_cfg),
            make_db=lambda capacity, device: scan_context.make_db(
                capacity, sc_cfg, device
            ),
            from_db=lambda db, slots: scan_context.ScanContext(
                db.descriptors[slots], db.keys[slots],
                db.descriptors[slots].mean(dim=-2),
            ),
            query=lambda db, d, r, i, mode: scan_context.query(
                db, d, r, i, sc_cfg, mode=mode
            ),
            parts=lambda d: (d.image, d.ring_key),
            to_wire=scan_context.to_wire,
            from_wire=lambda v: scan_context.from_wire(v, sc_cfg),
            insert=scan_context.insert,
            wire_dim=sc_cfg.num_rings * sc_cfg.num_sectors,
        )
    if kind == DescriptorType.LIDAR_IRIS:
        p = cfg.lidar_iris
        li_cfg = lidar_iris.LidarIrisConfig(
            rows=p.rows, cols=p.cols, n_scan=p.n_scan,
            distance_threshold=p.distance_threshold,
            exclude_recent=p.exclude_recent, num_candidates=p.num_candidates,
            nscale=p.nscale, min_wave_length=p.min_wave_length,
            mult=p.mult, sigma_on_f=p.sigma_on_f, match_mode=p.match_mode,
        )
        return Family(
            name="lidar_iris",
            make=lambda cloud: lidar_iris.make(cloud, li_cfg),
            make_db=lambda capacity, device: lidar_iris.make_db(capacity, li_cfg, device),
            from_db=lambda db, slots: lidar_iris.Iris(db.descriptors[slots], db.keys[slots]),
            query=lambda db, d, r, i, mode: lidar_iris.query(
                db, d, r, i, li_cfg, mode=mode
            ),
            parts=lambda d: (d.image, d.row_key),
            to_wire=lidar_iris.to_wire,
            from_wire=lambda v: lidar_iris.from_wire(v, li_cfg),
            insert=lidar_iris.insert,
            # image + row key: the max-z row key is not in the byte image
            wire_dim=p.rows * p.cols + p.rows,
        )
    if kind == DescriptorType.M2DP:
        p = cfg.m2dp
        m_cfg = m2dp.M2DPConfig(
            num_t=p.num_t, num_r=p.num_r, num_p=p.num_p, num_q=p.num_q,
            max_rho=p.max_rho, num_candidates=p.num_candidates,
            exclude_recent=p.exclude_recent, distance_threshold=p.distance_threshold,
        )
        return _vector_family("m2dp", lambda cloud: m2dp.make(cloud, m_cfg), m_cfg.dim, m_cfg)
    if kind == DescriptorType.GRSD:
        p = cfg.grsd
        g_cfg = geometric.GRSDConfig(
            num_bins=p.num_bins, knn=p.knn, num_candidates=p.num_candidates,
            exclude_recent=p.exclude_recent, distance_threshold=p.distance_threshold,
            voxel_width=p.voxel_width, extent_xy=p.extent_xy, extent_z=p.extent_z,
        )
        return _vector_family(
            "grsd", lambda cloud: geometric.grsd_make(cloud, g_cfg), g_cfg.num_bins, g_cfg
        )
    if kind == DescriptorType.FPFH:
        p = cfg.fpfh
        f_cfg = geometric.FPFHConfig(
            num_bins=p.num_bins, knn=p.knn, num_candidates=p.num_candidates,
            exclude_recent=p.exclude_recent, distance_threshold=p.distance_threshold,
        )
        return _vector_family(
            "fpfh", lambda cloud: geometric.fpfh_make(cloud, f_cfg), 3 * f_cfg.num_bins, f_cfg
        )
    if kind == DescriptorType.SHOT:
        p = cfg.shot
        s_cfg = shot.SHOTConfig(
            azimuth_bins=p.azimuth_bins, elevation_bins=p.elevation_bins,
            radial_bins=p.radial_bins, cos_bins=p.cos_bins, max_radius=p.max_radius,
            knn=p.knn, num_candidates=p.num_candidates,
            exclude_recent=p.exclude_recent, distance_threshold=p.distance_threshold,
        )
        return _vector_family("shot", lambda cloud: shot.shot_make(cloud, s_cfg), s_cfg.dim, s_cfg)
    raise ValueError(f"unknown descriptor type {kind}")
