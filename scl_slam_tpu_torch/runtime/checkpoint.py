"""Checkpoint / resume of a whole SLAM session (port of
``scl_slam_tpu/runtime/checkpoint.py``).

The file layout is the JAX module's, so a checkpoint written by the JAX
package loads here: one pickle-free ``np.savez_compressed`` file holding a
JSON ``__meta__`` (``version: 1``) and the state arrays as ``leaf_{i}`` in
the order of ``jax.tree_util.tree_flatten(MapperState)``, which is the
port's field order walked depth first (``state.state_to_numpy``), dtypes
kept. The write is atomic (a ``.tmp`` file, then ``os.replace``).

The port's state is updated in place under ``Mapper._write_lock``, where
the JAX state is an immutable pytree, so :func:`save` clones the state on
its device and captures the host cursors under the mapper's locks, and
copies to the host, compresses and writes after releasing them: a bus
thread's peer ingest cannot land between the arrays and the cursors, and
no lock is held across the file write.

RANSAC draws: the JAX module saves its ``jax.random`` keys
(``verify_key``, ``fleet_key``); the port draws from counter hashes of a
seed and a count, and saves the counts (``verify_attempts``,
``fleet_steps``), so a resumed robot draws what an uninterrupted one
would. A JAX file's keys mean nothing here: loading one keeps the mapper's
own counters. A port file carries ``verify_key`` (and ``fleet_key``) as
the JAX package's ``PRNGKey`` of the same seed, so the JAX module loads it
too, its draws restarting from the seed. The port also saves the solve
throttle's last time (``last_opt_time``), which its runners drive from the
frame stamps where the JAX runners read the wall clock.

Not saved, as in the JAX module: a staged intra result
(``Mapper._pending_intra``, handed from ``add_frame`` to the next
``spin_once``).
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..geometry import se3
from ..ops import pointcloud as pc
from .state import state_from_numpy, state_leaves, state_to_numpy, to_numpy

VERSION = 1


def _prng_key(seed: int) -> list[int]:
    """``jax.random.PRNGKey(seed)`` (threefry) as the JAX module saves it."""
    return [(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF]


def _matrix(p) -> list:
    T = np.eye(4)
    T[:3, :3] = to_numpy(p.R)
    T[:3, 3] = to_numpy(p.t)
    return T.tolist()


def _pose(T) -> se3.Pose:
    T = np.asarray(T, np.float32)
    return se3.Pose(T[:3, :3].copy(), T[:3, 3].copy())


def _clone(x):
    """A copy of a tree of NamedTuples of tensors, on the same device."""
    if isinstance(x, tuple):
        return type(x)(*(_clone(v) for v in x))
    return x.clone()


def _snapshot(mapper):
    """(state clone on its device, meta, staged frames): the part of a save
    made under the mapper's locks."""
    with mapper._state_lock, mapper._write_lock:
        state = _clone(mapper.state)
        with mapper._pending_loops_lock:  # the serve thread appends here
            pending = list(mapper._pending_server_loops)
            attempts = mapper._verify_attempts
        meta = {
            "version": VERSION,
            "robot": mapper.robot,
            "frames_seen": mapper._frames_seen,
            "keyframes": mapper._keyframes,
            "last_kf_pose": None if mapper._last_kf_pose is None else _matrix(mapper._last_kf_pose),
            "verify_key": _prng_key(mapper._verify_seed),
            "verify_attempts": attempts,
            "last_opt_time": None if mapper._last_opt_time == float("-inf") else mapper._last_opt_time,
            "icp_attempts": mapper.icp_attempts,
            "evicted": {
                str(r): [
                    {"index": e["index"], "stamp": e["stamp"], "pose": np.asarray(e["pose"]).tolist()}
                    for e in lst
                ]
                for r, lst in mapper._evicted.items()
            },
            "pending_server_loops": [
                [int(a), int(b), np.asarray(T).tolist(), float(nz)] for a, b, T, nz in pending
            ],
        }
        staged = None
        if hasattr(mapper, "_fleet_last_pose"):
            meta["fleet_last_pose"] = {
                str(r): _matrix(p) for r, p in mapper._fleet_last_pose.items()
            }
            meta["fleet_key"] = _prng_key(mapper._fleet_seed)
            meta["fleet_steps"] = mapper._fleet_steps
            staged = list(mapper._fleet_staged)
            meta["fleet_staged_n"] = len(staged)
    return state, meta, staged


def _staged_arrays(staged: list, cap: int) -> dict:
    """The staged fleet frames in the JAX module's layout: each scan as the
    padded ``Cloud`` that ``pc.from_points(xyz, raw_points_capacity)``
    makes (``staged_xyz`` [n, cap, 3], ``staged_mask`` [n, cap])."""
    n = len(staged)
    xyz = np.full((n, cap, 3), pc.PAD_VALUE, np.float32)
    mask = np.zeros((n, cap), bool)
    for k, (_, _, scan, _) in enumerate(staged):
        s = pc.fit_capacity(np.asarray(scan, np.float32), cap)
        xyz[k, : s.shape[0]] = s
        mask[k, : s.shape[0]] = True
    return {
        "staged_robot": np.asarray([s[0] for s in staged], np.int32),
        "staged_R": np.stack([np.asarray(to_numpy(s[1].R), np.float32) for s in staged]),
        "staged_t": np.stack([np.asarray(to_numpy(s[1].t), np.float32) for s in staged]),
        "staged_xyz": xyz,
        "staged_mask": mask,
        "staged_stamp": np.asarray([s[3] for s in staged], np.float64),
    }


def save(mapper, path: str) -> dict:
    """Write a checkpoint of ``mapper`` (a ``Mapper`` or ``FleetMapper``)
    to ``path`` atomically. Returns the seconds the locks were held
    (``lock_s``), the whole save took (``save_s``) and the file's bytes."""
    t0 = time.perf_counter()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    state, meta, staged = _snapshot(mapper)
    t_lock = time.perf_counter() - t0
    arrays = {f"leaf_{i}": a for i, a in enumerate(state_to_numpy(state).values())}
    if staged:
        arrays.update(_staged_arrays(staged, mapper.cfg.keyframe.raw_points_capacity))
    del state
    tmp = path + ".tmp"
    np.savez_compressed(tmp, __meta__=json.dumps(meta), **arrays)
    # np.savez appends .npz to a name that lacks it
    os.replace(tmp if tmp.endswith(".npz") else tmp + ".npz", path)
    return {"lock_s": t_lock, "save_s": time.perf_counter() - t0, "bytes": os.path.getsize(path)}


def load(mapper, path: str):
    """Restore a checkpoint into ``mapper`` (same configuration; any
    device). Raises ``ValueError`` on another version or on a leaf whose
    shape differs from the mapper's."""
    with np.load(path, allow_pickle=False) as data:
        meta = json.loads(str(data["__meta__"]))
        if meta["version"] != VERSION:
            raise ValueError(f"unsupported checkpoint version {meta['version']}")
        arrays = {}
        for i, (name, old) in enumerate(state_leaves(mapper.state).items()):
            arr = data[f"leaf_{i}"]
            if arr.shape != tuple(old.shape) or torch.from_numpy(arr).dtype != old.dtype:
                raise ValueError(
                    f"checkpoint/config mismatch at leaf {i} ({name}): {arr.shape} "
                    f"{arr.dtype} vs {tuple(old.shape)} {old.dtype}; was the config changed?"
                )
            arrays[name] = arr
        staged = (
            {k: data[k] for k in ("staged_robot", "staged_R", "staged_t",
                                  "staged_xyz", "staged_mask", "staged_stamp")}
            if int(meta.get("fleet_staged_n", 0)) else None
        )
    state = state_from_numpy(arrays, mapper.device)
    with mapper._state_lock, mapper._write_lock:
        mapper.state = state
        mapper._frames_seen = meta["frames_seen"]
        mapper._keyframes = meta["keyframes"]
        lk = meta["last_kf_pose"]
        mapper._last_kf_pose = None if lk is None else _pose(lk)
        # a JAX file's verify_key cannot seed the port's counter hash: the
        # mapper keeps its own counter then
        if "verify_attempts" in meta:
            with mapper._pending_loops_lock:
                mapper._verify_attempts = int(meta["verify_attempts"])
        if "last_opt_time" in meta:
            t = meta["last_opt_time"]
            mapper._last_opt_time = float("-inf") if t is None else float(t)
        if "icp_attempts" in meta:
            mapper.icp_attempts = int(meta["icp_attempts"])
        mapper._pending_intra, mapper._pending_intra_valid = None, False
        # the crash may have cut an inter detection short: let the first
        # spin_once after the resume dispatch it again
        mapper._inter_dirty = True
        with mapper._pending_loops_lock:
            mapper._pending_server_loops = [
                (int(a), int(b), np.asarray(T, np.float64), float(nz))
                for a, b, T, nz in meta.get("pending_server_loops", [])
            ]
        mapper._evicted = {
            int(r): [
                {"index": e["index"], "stamp": e["stamp"], "pose": np.asarray(e["pose"])}
                for e in lst
            ]
            for r, lst in meta.get("evicted", {}).items()
        }
        if hasattr(mapper, "_fleet_last_pose") and "fleet_last_pose" in meta:
            mapper._fleet_last_pose = {
                int(r): _pose(T) for r, T in meta["fleet_last_pose"].items()
            }
            if "fleet_steps" in meta:
                mapper._fleet_steps = int(meta["fleet_steps"])
            mapper._fleet_staged, mapper._staged_per_robot = [], {}
            for k in range(int(meta.get("fleet_staged_n", 0))):
                r = int(staged["staged_robot"][k])
                mapper._fleet_staged.append((
                    r,
                    se3.Pose(staged["staged_R"][k].copy(), staged["staged_t"][k].copy()),
                    staged["staged_xyz"][k][staged["staged_mask"][k]],
                    float(staged["staged_stamp"][k]),
                ))
                mapper._staged_per_robot[r] = mapper._staged_per_robot.get(r, 0) + 1
    return mapper
