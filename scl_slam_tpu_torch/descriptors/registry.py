"""Descriptor-family dispatch (port of
``scl_slam_tpu/descriptors/registry.py``, Scan Context family only).

The other families (LiDAR-Iris, M2DP, GRSD, FPFH, SHOT) wait for ROADMAP
queue 1 item 15; asking for one raises ``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from ..config import DescriptorType, SlamConfig
from . import scan_context


@dataclass(frozen=True)
class Family:
    """One descriptor family behind the uniform protocol.

    ``make(cloud)`` encodes a batch of clouds; ``make_db(capacity,
    device)`` allocates its DB; ``from_db(db, slots)`` reads the stored
    descriptors of slots [B] back as a batch; ``query(db, desc, robot,
    indices, mode)`` retrieves for a batch of frames; ``parts(desc)`` gives
    the (full DB array, retrieval key) pair that ``base.db_insert_block``
    stores; ``to_wire(desc)`` flattens one descriptor for broadcast.
    """

    name: str
    make: Callable
    make_db: Callable
    from_db: Callable
    query: Callable
    parts: Callable
    to_wire: Callable


def exclude_recent(cfg: SlamConfig) -> int:
    """The active family's recent-exclusion window (host-side gating must
    match what the family's query masks)."""
    if cfg.descriptor_type != DescriptorType.SCAN_CONTEXT:
        get_family(cfg)  # raises NotImplementedError naming the ROADMAP item
    return cfg.scan_context.exclude_recent


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
            to_wire=lambda d: d.image.reshape(-1),
        )
    raise NotImplementedError(
        f"descriptor_type {kind.value!r} is not ported yet "
        "(ROADMAP queue 1 item 15: other descriptor families)"
    )
