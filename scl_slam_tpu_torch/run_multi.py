"""Multi-robot pipeline runner of the PyTorch port (port of
``scl_slam_tpu/run_multi.py``).

Splits one sequence (synthetic or KITTI) into N overlapping per-robot index
ranges, the way the reference simulates several robots on one machine with
namespaced bag replays, and runs them one of three ways:

- ``--transport local`` (default): N decentralized mappers in one process
  that exchange descriptors and verify inter-robot loops over the
  in-process bus;
- ``--transport tcp``: one process per robot (``run_robot.py``) over real
  sockets (``runtime/transport.py::TcpBus``). On one card the processes
  share it;
- ``--fleet``: centralized serving, every robot in one shared state
  (``runtime/fleet.py::FleetMapper``): each step feeds one frame of every
  robot, processes the staged keyframes as one fleet batch and runs the
  throttled joint solve. It has no tcp transport.

    python -m scl_slam_tpu_torch.run_multi --robots 2 --frames 120
    python -m scl_slam_tpu_torch.run_multi --robots 2 --device cpu --config small.yaml
    python -m scl_slam_tpu_torch.run_multi --robots 2 --transport tcp
    python -m scl_slam_tpu_torch.run_multi --robots 2 --fleet

It runs on the GPU unless ``--device cpu`` is given, and raises when there
is no card. The solve throttle reads the frame stamps (0.1 s apart), so a
run does not depend on the machine's speed (the JAX runner reads the wall
clock). The last line of its output is the JSON report (``robots``,
``mode``, ``frames``, ``intra_loops``, ``inter_loops``, ``wall_s``,
``frames_per_s``, ``device``, ``output``, ``ate_rmse_m``; ``mode`` is
``decentralized``, ``decentralized-tcp`` or ``fleet``). Over tcp,
``--checkpoint-every N`` has each worker save its session every N fed
frames, and ``--respawn K`` starts a worker that died before its report
again with ``--resume``, at most K times (``respawn i/K`` on stderr):

    python -m scl_slam_tpu_torch.run_multi --robots 2 --transport tcp \
        --respawn 2 --checkpoint-every 5 --crash-robot 0 --crash-after 12

Robot 0's view of every robot is drawn into ``<output>/trajectory.png``
(``io/viz.save_fleet_figure``, one joint gauge alignment); where matplotlib
is missing the report says why (``figure_error``) and the run goes on.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np


def add_dataset_args(p: argparse.ArgumentParser) -> None:
    """Dataset and configuration options, shared with ``run_robot``."""
    p.add_argument("--robots", type=int, default=2)
    p.add_argument("--dataset", choices=["synthetic", "kitti"], default="synthetic")
    p.add_argument("--root", help="KITTI odometry root (contains sequences/, poses/)")
    p.add_argument("--sequence", default="05")
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--config", help="YAML config path (robot identity fields "
                   "are overridden per robot)")
    p.add_argument("--overlap", type=int, default=10,
                   help="frames of overlap between adjacent robot segments")
    p.add_argument("--output", default=os.path.join(tempfile.gettempdir(),
                                                    "scl_slam_tpu_torch_multi"))
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the mappers run (default: the GPU)")


def require_device(device: str) -> None:
    """Fail before any work when the GPU is asked for and there is none."""
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "run_multi runs on the GPU by default and torch.cuda.is_available() "
            "is false; pass --device cpu to run on the CPU"
        )


def make_cfg(args, r: int):
    """Robot r's configuration: the YAML (or the defaults) with the robot
    identity fields set."""
    from .config import SlamConfig, load_config

    base = load_config(args.config) if args.config else SlamConfig()
    return dataclasses.replace(
        base, number_of_robots=args.robots, robot_id=r, robot_name=chr(ord("a") + r),
    )


def build_dataset(args):
    """(get_scan, get_pose, n), deterministic, so that every worker process
    rebuilds the same dataset from the same options. Exits 2 without
    ``--root`` for KITTI."""
    from .io import kitti as kio

    if args.dataset == "kitti":
        if not args.root:
            print("--root required for kitti", file=sys.stderr)
            raise SystemExit(2)
        seq = kio.KittiSequence(args.root, args.sequence)
        n = min(len(seq), args.frames)
        return seq.scan, seq.gt_pose_velo, n
    world = kio.SyntheticWorld(seed=1)
    gt = kio.loop_trajectory(n_frames=args.frames, radius=70.0)
    return (lambda k: world.scan_at(gt[k], max_points=16384, seed=k)), (lambda k: gt[k]), args.frames


def make_splits(n: int, R: int, overlap: int) -> list[list[int]]:
    """Frame index ranges per robot, each overlapping the previous one."""
    seg = n // R
    return [
        list(range(max(0, r * seg - overlap), min(n, (r + 1) * seg)))
        for r in range(R)
    ]


def pose_of(T):
    from .geometry import se3

    T = np.asarray(T, np.float32)
    return se3.Pose(T[:3, :3], T[:3, 3])


def feed(mapper, k: int, get_scan, get_pose) -> dict | None:
    """One frame of robot ``mapper.robot``: ``add_frame``, then on a
    keyframe the broadcast and one ``spin_once`` on the frame's stamp.
    Returns the spin's info, or None when the frame was no keyframe."""
    stamp = 0.1 * k
    wire = mapper.add_frame(pose_of(get_pose(k)), get_scan(k), stamp=stamp)
    if wire is None:
        return None
    mapper.broadcast_latest(wire)
    return mapper.spin_once(now=stamp)


def report_view(mapper, get_pose, R: int, output: str | None = None) -> dict:
    """Joint ATE per robot from one mapper's view of every robot (robot 0's
    in-process; the worker's own over tcp), and with ``output`` the joint
    figure ``<output>/trajectory.png``: ``{"ate_rmse_m": {...}, "figure":
    path}``, or ``"figure_error"`` where the figure failed (it never fails
    the run)."""
    from .io import trajectory as tio

    ates, trajs, gts = {}, {}, {}
    if get_pose(0) is None:  # a KITTI root may lack poses/<seq>.txt
        return {"ate_rmse_m": ates}
    for r in range(R):
        est, stamps = mapper.trajectory_with_stamps(robot=r)
        if len(est) == 0:
            continue
        gt = np.stack([np.asarray(get_pose(int(round(float(s) / 0.1)))) for s in stamps])
        label = chr(ord("a") + r)
        ates[label] = round(tio.ate_rmse(est, gt), 4)
        trajs[label], gts[label] = est, gt
    frag = {"ate_rmse_m": ates}
    if output is None:
        return frag
    try:
        from .io import viz

        # one joint gauge alignment for display (the prior leaves yaw and
        # translation free): every robot, the loop chords and the map move
        # by the same transform, so a misalignment between robots shows
        loops = mapper.loop_constraints()
        map_pts = mapper.global_map(max_points=1 << 16)
        if trajs:
            s, Rw, tw = tio.umeyama_align(
                np.concatenate([trajs[k][:, :3, 3] for k in sorted(trajs)]),
                np.concatenate([gts[k][:, :3, 3] for k in sorted(trajs)]),
            )

            def apply(T):
                out = T.copy()
                out[:, :3, 3] = (s * (Rw @ T[:, :3, 3].T)).T + tw
                out[:, :3, :3] = Rw @ T[:, :3, :3]
                return out

            trajs = {k: apply(v) for k, v in trajs.items()}
            for lc in loops:
                lc["pi"] = s * (Rw @ np.asarray(lc["pi"])) + tw
                lc["pj"] = s * (Rw @ np.asarray(lc["pj"])) + tw
            if len(map_pts):
                map_pts = (s * (Rw @ np.asarray(map_pts).T)).T + tw
        n_intra = sum(not str(lc.get("kind", "")).startswith("inter") for lc in loops)
        frag["figure"] = viz.save_fleet_figure(
            os.path.join(output, "trajectory.png"), trajs, gts=gts, loops=loops,
            map_points=map_pts, title=f"scl_slam_tpu_torch — {R} robots",
            subtitle=(f"{n_intra} intra + {len(loops) - n_intra} inter loops  ·  ATE "
                      + ", ".join(f"{k}: {v}" for k, v in ates.items())),
        )
    except Exception as e:  # the figure is auxiliary output
        frag["figure_error"] = str(e)
    return frag


def _read(path: str) -> str:
    with open(path) as f:
        return f.read()


def _run_tcp(args) -> int:
    """One ``run_robot`` process per robot over real sockets. A worker that
    dies before writing its report is started again with ``--resume`` while
    its ``--respawn`` budget lasts; one that fails past it fails the run:
    the others are stopped and the exit codes reported."""
    R = args.robots
    workdir = tempfile.mkdtemp(prefix="scl_slam_torch_tcp_")
    args.output = os.path.abspath(args.output)
    os.makedirs(args.output, exist_ok=True)
    procs = []
    t0 = time.perf_counter()

    def worker_cmd(r: int, ports: str = "auto", resume: bool = False) -> list[str]:
        cmd = [
            sys.executable, "-m", "scl_slam_tpu_torch.run_robot",
            "--robot", str(r), "--robots", str(R), "--ports", ports,
            "--workdir", workdir, "--dataset", args.dataset,
            "--frames", str(args.frames), "--sequence", args.sequence,
            "--overlap", str(args.overlap), "--output", args.output,
            "--device", args.device,
        ]
        if args.root:
            cmd += ["--root", args.root]
        if args.config:
            cmd += ["--config", args.config]
        if args.checkpoint_every:
            cmd += ["--checkpoint-every", str(args.checkpoint_every)]
        if resume:
            cmd += ["--resume"]
        elif args.crash_robot >= 0 and r == args.crash_robot:
            cmd += ["--crash-after", str(args.crash_after)]
        return cmd

    # the workers import this package from the checkout it was loaded from
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        x for x in (root, os.environ.get("PYTHONPATH")) if x))
    try:
        procs = [subprocess.Popen(worker_cmd(r), env=env) for r in range(R)]
        rcs: list[int | None] = [None] * R
        restarts = [0] * R
        while any(rc is None for rc in rcs):
            time.sleep(0.2)
            for r, pr in enumerate(procs):
                if rcs[r] is not None or (rc := pr.poll()) is None:
                    continue
                if rc == 0 or os.path.exists(os.path.join(workdir, f"out_{r}")):
                    rcs[r] = 0  # its report is whole (written before the exit)
                elif restarts[r] < args.respawn:
                    restarts[r] += 1
                    print(f"worker {r} died rc={rc}; respawn {restarts[r]}/{args.respawn}",
                          file=sys.stderr, flush=True)
                    # the peers read the ready sentinels once: the new
                    # worker binds the port it published before
                    try:
                        ports = ",".join(_read(os.path.join(workdir, f"ready_{q}"))
                                         for q in range(R))
                    except OSError:
                        ports = "auto"  # it died before the ready barrier
                    procs[r] = subprocess.Popen(worker_cmd(r, ports, True), env=env)
                else:
                    rcs[r] = rc
            if any(rc not in (None, 0) for rc in rcs):
                # a failed worker (its respawns spent) fails the run,
                # whether or not it wrote its report; the others would wait
                # for it until their barrier timeouts, so stop them now
                for q, pr in enumerate(procs):
                    if rcs[q] is None:
                        pr.terminate()
                        rcs[q] = pr.wait()
                break
        wall = time.perf_counter() - t0
        if any(rcs):
            print(f"worker exit codes: {rcs}", file=sys.stderr)
            return 1
        reps = []
        for r in range(R):
            with open(os.path.join(workdir, f"out_{r}")) as f:
                reps.append(json.load(f))
    finally:
        for pr in procs:  # never orphan a worker
            if pr.poll() is None:
                pr.terminate()
                pr.wait()
        shutil.rmtree(workdir, ignore_errors=True)
    n = reps[0]["frames"]
    report = {
        "robots": R,
        "mode": "decentralized-tcp",
        "frames": n,
        "intra_loops": sum(rp["intra_loops"] for rp in reps),
        "inter_loops": sum(rp["inter_loops"] for rp in reps),
        "wall_s": round(wall, 2),
        "frames_per_s": round(n / wall, 2),
        "device": reps[0]["device"],
        "output": args.output,
        "ate_rmse_m": reps[0]["ate_rmse_m"],
        "respawns": sum(restarts),
        # the workers' kernel launches, summed (what their last processes
        # launched: a respawned worker counts from its resume)
        "launches": {k: sum(rp["launches"][k] for rp in reps) for k in reps[0]["launches"]},
        # per robot: drains whose solve broke down (their stages) and the
        # inter-robot path's outcomes
        "broken_drains": [rp["broken_drains"] for rp in reps],
        "solve_breakdowns": [rp["solve_breakdowns"] for rp in reps],
        "inter_log": [rp["inter_log"] for rp in reps],
    }
    for key in ("figure", "figure_error"):
        if key in reps[0]:
            report[key] = reps[0][key]
    print(json.dumps(report))
    return 0


def _refuse(args) -> str | None:
    """The reason an option cannot run on the port yet, or None."""
    if args.fleet and args.transport == "tcp":
        return ("--fleet is a single-process serving mode; it has no tcp "
                "transport (drop --transport tcp)")
    return None


def main(argv=None):
    p = argparse.ArgumentParser(description="scl_slam_tpu_torch multi-robot pipeline")
    add_dataset_args(p)
    p.add_argument("--fleet", action="store_true",
                   help="centralized serving: one shared state for all robots "
                   "(runtime/fleet.py) instead of N decentralized mappers")
    p.add_argument("--transport", choices=["local", "tcp"], default="local",
                   help="in-process bus (local) or one process per robot over "
                   "sockets (tcp)")
    p.add_argument("--respawn", type=int, default=0,
                   help="tcp: start a worker that died again with --resume, at "
                   "most this many times each")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="tcp: each worker checkpoints every N fed frames")
    p.add_argument("--crash-robot", type=int, default=-1,
                   help="FAULT INJECTION (tcp tests): which robot crashes")
    p.add_argument("--crash-after", type=int, default=0,
                   help="FAULT INJECTION: crash after N fed frames")
    args = p.parse_args(argv)
    reason = _refuse(args)
    if reason:
        print(reason, file=sys.stderr)
        return 2
    require_device(args.device)
    if args.transport == "tcp":
        return _run_tcp(args)

    import torch

    R = args.robots
    get_scan, get_pose, n = build_dataset(args)
    splits = make_splits(n, R, args.overlap)
    t0 = time.perf_counter()
    if args.fleet:
        mapper0, intra_loops, inter_loops = _run_fleet(args, splits, get_scan, get_pose)
    else:
        mapper0, intra_loops, inter_loops = _run_local(args, splits, get_scan, get_pose)
    if args.device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    mapper0.save_trajectories(args.output)
    report = {
        "robots": R,
        "mode": "fleet" if args.fleet else "decentralized",
        "frames": n,
        "intra_loops": intra_loops,
        "inter_loops": inter_loops,
        "wall_s": round(wall, 2),
        "frames_per_s": round(n / wall, 2),
        "device": torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu",
        "output": args.output,
    }
    report.update(report_view(mapper0, get_pose, R, args.output))
    print(json.dumps(report))
    return 0


def _run_local(args, splits, get_scan, get_pose):
    """N decentralized mappers over the in-process bus, fed in turn.
    Returns (robot 0's mapper, intra loops, inter loops)."""
    from .runtime import Mapper
    from .runtime.transport import LocalBus

    bus = LocalBus()
    mappers = []
    for r in range(args.robots):
        m = Mapper(make_cfg(args, r), device=args.device)
        m.attach_bus(bus)
        mappers.append(m)
    inter_loops = intra_loops = 0
    for step in range(max(len(s) for s in splits)):
        for r in range(args.robots):
            if step >= len(splits[r]):
                continue
            info = feed(mappers[r], splits[r][step], get_scan, get_pose)
            if info is not None:
                intra_loops += bool(info.get("loop"))
                inter_loops += bool(info.get("inter_loop"))
    for m in mappers:
        m.optimize()
    return mappers[0], intra_loops, inter_loops


def _run_fleet(args, splits, get_scan, get_pose):
    """One ``FleetMapper`` for every robot: each step stages one frame of
    every robot, processes the batch and runs the throttled solve on the
    step's latest frame stamp. Returns (the fleet, intra loops, inter
    loops)."""
    from .runtime import FleetMapper

    fleet = FleetMapper(make_cfg(args, 0), device=args.device)
    inter_loops = intra_loops = 0
    for step in range(max(len(s) for s in splits)):
        stamps = []
        for r in range(args.robots):
            if step >= len(splits[r]):
                continue
            k = splits[r][step]
            stamps.append(0.1 * k)
            fleet.add_robot_frame(r, pose_of(get_pose(k)), get_scan(k), stamp=0.1 * k)
        for ev in fleet.step():
            intra_loops += "loop" in ev
            inter_loops += "inter_loop" in ev
        fleet.spin(now=max(stamps))
    fleet.optimize()
    return fleet, intra_loops, inter_loops


if __name__ == "__main__":
    sys.exit(main())
