"""Process-group set-up and the device mesh of the distributed path (port
of ``scl_slam_tpu/parallel/multihost.py``, on ``torch.distributed``).

One process per rank, NCCL on the card and gloo on the CPU. The caller
gives the rendezvous: nothing tells a process of a cluster.

    from scl_slam_tpu_torch.parallel import multihost
    multihost.init("tcp://10.0.0.1:29500", num_processes=4, process_id=rank)
    mesh = multihost.make_mesh(("shard",))
    mapper.attach_mesh(mesh)          # edge-sharded solve in every drain
    mapper.shard_database(mesh)       # row-sharded descriptor DB

Unlike the JAX function, ``init`` makes a real process group for a single
process too (a world of size 1), so that the path runs its collectives
there as well. NCCL refuses two ranks on one card; two ranks that share a
card use gloo (``backend="gloo"``), which all-reduces CUDA tensors: the
only collective the path uses (``sharded.py``).
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile

import torch
import torch.distributed as dist

# a collective that waits longer than this fails its rank (and so the run)
TIMEOUT = datetime.timedelta(seconds=600)


def init(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    device: str = "cuda",
) -> None:
    """Join the default process group (a no-op where it is up already).

    ``coordinator``: the rendezvous, ``tcp://host:port`` (``host:port``
    means the same) or ``file:///path`` (a FileStore, as the tests use);
    None takes ``init_method="env://"``. ``backend``: NCCL for ``device
    == "cuda"``, gloo for ``"cpu"``, unless named (``"cpu:gloo,cuda:nccl"``
    takes both, by the tensors' device). A single process gets a group of
    world size 1."""
    if dist.is_initialized():
        return
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    if coordinator is None:
        init_method = "env://"
    elif "://" in coordinator:
        init_method = coordinator
    else:
        init_method = f"tcp://{coordinator}"
    kw = {}
    if "nccl" in backend:
        # one card a process: rank r takes card r of its host
        local = (process_id or 0) % torch.cuda.device_count()
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes or 1,
        rank=process_id or 0, timeout=TIMEOUT, **kw,
    )


def make_mesh(axis_names=("shard",), device_type: str | None = None):
    """A ``DeviceMesh`` over every rank of the default group: 1-D by
    default (what the edge-sharded solve and the row-sharded DB need);
    with two names, hosts x local ranks (``LOCAL_WORLD_SIZE`` ranks a
    host, else all on one). ``device_type`` defaults to "cuda" under NCCL
    and "cpu" under gloo (the mesh only hands out its groups here)."""
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(world)
    if len(axis_names) != 1:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        ranks = ranks.reshape(world // local, local)
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axis_names))


def robot_shard_bounds(num_robots: int, max_keyframes: int, num_shards: int):
    """Static (start, end) global-slot ranges assigning keyframe blocks to
    shards (keyframe blocks per host subsume per-robot subgraphs)."""
    total = num_robots * max_keyframes
    per = total // num_shards
    return [(s * per, (s + 1) * per if s < num_shards - 1 else total)
            for s in range(num_shards)]


def shutdown() -> None:
    """Leave the default process group, where there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(rank, fn, world, args, store, device, backend, out_dir, threads):
    if threads:
        torch.set_num_threads(threads)
    init(f"file://{store}", world, rank, backend=backend, device=device)
    try:
        result = fn(rank, world, *args)
        with open(os.path.join(out_dir, f"rank_{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        shutdown()


def spawn(fn, world: int, args=(), device: str = "cpu", backend: str | None = None,
          workdir: str | None = None, threads: int | None = None) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes (spawned,
    so each imports only what ``fn``'s module imports), each a rank of a
    process group that meets through a FileStore in ``workdir`` (a new
    temporary directory by default; never a TCP port). Returns each rank's
    result in rank order. A rank that fails stops the others and raises
    here (``torch.multiprocessing.ProcessRaisedException``). ``fn`` must
    be a module-level function. ``threads``: each rank's CPU threads, by
    default its share of the machine's cores (ranks that each take every
    core, and spin on them between their parallel regions, ran a gloo
    collective ~100x slower on 8 cores)."""
    import torch.multiprocessing as mp

    if threads is None:
        threads = max(1, (os.cpu_count() or world) // world)
    work = tempfile.mkdtemp(prefix="scl_ranks_", dir=workdir)
    store = os.path.join(work, "store")
    mp.start_processes(
        _rank_main, args=(fn, world, tuple(args), store, device, backend, work, threads),
        nprocs=world, join=True, start_method="spawn",
    )
    out = []
    for r in range(world):
        with open(os.path.join(work, f"rank_{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
