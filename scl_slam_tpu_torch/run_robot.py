"""Per-robot worker process of ``run_multi --transport tcp`` (port of
``scl_slam_tpu/run_robot.py``): one robot's Mapper over a socket bus
(``runtime/transport.py::TcpBus``). Started by ``run_multi``; it can also
be started by hand, one per machine, with ``--ports`` naming the peers.
Several workers may share one card.

The choreography runs on sentinel files in ``--workdir``:

- ``ready_<r>``: robot r's listener is up (the file holds its port, so
  ``--ports auto`` needs no port reserved in advance). Every worker waits
  for all of them before feeding, so no descriptor broadcast is lost (the
  in-order peer chain drops everything after a gap).
- ``fed_<r>``: robot r has fed all its frames. Robots feed one after
  another by id (robot r waits for ``fed_<r-1>``), so peer descriptors are
  ingested on the bus thread while the main thread waits, and a later
  robot verifies its inter-robot loops by RPC against the earlier, idle
  ones.
- after ``fed_<R-1>`` (no RPC can arrive any more) every worker runs a
  last solve and writes ``out_<r>``; robot 0's holds the joint ATE.

Recovery: ``--checkpoint-every N`` saves the session every N fed frames
(``runtime/checkpoint.py``, atomic) to ``<workdir>/ckpt_<r>.npz``, with the
loop counters in the ``ckpt_counters_<r>`` sidecar; ``--resume`` restores
it and restarts the feed at the checkpoint's ``_frames_seen`` (frames fed
after it are fed again: peers drop their descriptors as out of order).
``run_multi --respawn`` starts a crashed worker again this way.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _wait_for(path: str, timeout: float) -> None:
    t0 = time.time()
    while not os.path.exists(path):
        if time.time() - t0 > timeout:
            raise TimeoutError(f"timed out waiting for {path}")
        time.sleep(0.1)


def _publish(wd: str, name: str, content: str = "") -> None:
    """Write a sentinel file atomically (a temporary file, then a rename):
    waiters key on its existence, so its content must be whole when it
    appears."""
    tmp = os.path.join(wd, f".{name}.tmp")
    with open(tmp, "w") as f:
        f.write(content)
    os.replace(tmp, os.path.join(wd, name))


def main(argv=None):
    from .run_multi import (
        add_dataset_args, build_dataset, feed, make_cfg, make_splits, report_view,
        require_device,
    )

    p = argparse.ArgumentParser(description="scl_slam_tpu_torch per-robot worker")
    add_dataset_args(p)
    p.add_argument("--robot", type=int, required=True)
    p.add_argument("--ports", required=True,
                   help="comma-separated listen ports, one per robot, or 'auto': "
                   "each worker binds a free port and publishes it in its "
                   "ready_<r> sentinel (one machine only)")
    p.add_argument("--workdir", required=True, help="shared directory of the sentinels")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="checkpoint every N fed frames to <workdir>/ckpt_<r>.npz "
                   "(atomic); 0 disables")
    p.add_argument("--resume", action="store_true",
                   help="restore <workdir>/ckpt_<r>.npz if present and skip the "
                   "frames it has fed (the respawn path)")
    p.add_argument("--crash-after", type=int, default=0,
                   help="FAULT INJECTION: exit with code 3 after feeding N frames; "
                   "ignored under --resume")
    args = p.parse_args(argv)
    require_device(args.device)

    import torch

    from .runtime import Mapper
    from .runtime.transport import TcpBus

    r, R = args.robot, args.robots
    get_scan, get_pose, n = build_dataset(args)
    splits = make_splits(n, R, args.overlap)
    if args.ports == "auto":
        bus = TcpBus(r, 0, {})
    else:
        ports = [int(x) for x in args.ports.split(",")]
        if len(ports) != R:
            raise ValueError(f"--ports names {len(ports)} ports for {R} robots")
        bus = TcpBus(r, ports[r], {q: ("127.0.0.1", ports[q]) for q in range(R)})
    mapper = Mapper(make_cfg(args, r), device=args.device)
    mapper.attach_bus(bus)

    wd = args.workdir
    ckpt_path = os.path.join(wd, f"ckpt_{r}.npz")
    start_at = intra = inter = 0
    if args.resume and os.path.exists(ckpt_path):
        from .runtime import checkpoint

        checkpoint.load(mapper, ckpt_path)
        # _frames_seen counts this robot's own fed frames (a peer ingest
        # does not touch it): the resume cursor
        start_at = min(mapper._frames_seen, len(splits[r]))
        # the loop counters are the report's, not the mapper's: without the
        # sidecar a respawned worker would report only its later loops
        try:
            with open(os.path.join(wd, f"ckpt_counters_{r}")) as f:
                intra, inter = (int(x) for x in f.read().split(","))
        except (OSError, ValueError):
            pass
    # robot r waits behind r robots' whole feeds
    t_ready, t_feed = 120.0 * max(1, R), 900.0 * max(1, R)
    _publish(wd, f"ready_{r}", str(bus.port))
    for q in range(R):
        _wait_for(os.path.join(wd, f"ready_{q}"), t_ready)
    if args.ports == "auto":
        bus.peers = {
            q: ("127.0.0.1", int(open(os.path.join(wd, f"ready_{q}")).read()))
            for q in range(R)
        }
    if r > 0:
        _wait_for(os.path.join(wd, f"fed_{r - 1}"), t_feed)

    fed = 0
    for k in splits[r][start_at:]:
        info = feed(mapper, k, get_scan, get_pose)
        if info is not None:
            intra += bool(info.get("loop"))
            inter += bool(info.get("inter_loop"))
        fed += 1
        if args.checkpoint_every and fed % args.checkpoint_every == 0:
            from .runtime import checkpoint

            checkpoint.save(mapper, ckpt_path)
            _publish(wd, f"ckpt_counters_{r}", f"{intra},{inter}")
        if args.crash_after and not args.resume and fed >= args.crash_after:
            os._exit(3)  # fault injection: a hard crash mid-feed
    _publish(wd, f"fed_{r}")

    # all feeding done everywhere: no verification RPC can still arrive
    _wait_for(os.path.join(wd, f"fed_{R - 1}"), t_feed)
    mapper.optimize()
    from .ops import kernels

    out = {
        "robot": r, "frames": n, "intra_loops": intra, "inter_loops": inter,
        "device": torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu",
        "counts": [int(c) for c in mapper.state.counts[:R].tolist()],
        # this process's kernel launches (since its start: a respawned
        # worker's count begins at its resume)
        "launches": dict(kernels.LAUNCHES),
        # the port's own diagnostics: drains whose solve broke down, and
        # the inter-robot path's outcomes (Mapper.inter_log)
        "broken_drains": mapper.broken_drains,
        "solve_breakdowns": mapper.solve_breakdowns,
        "inter_log": dict(mapper.inter_log, send_failures=bus.send_failures),
    }
    if r == 0:
        os.makedirs(args.output, exist_ok=True)
        mapper.save_trajectories(args.output)
        out.update(report_view(mapper, get_pose, R))
    with open(os.path.join(wd, f"out_{r}"), "w") as f:
        json.dump(out, f)
    bus.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
