"""Single-robot pipeline runner of the PyTorch port (port of
``scl_slam_tpu/run.py``).

One command runs the live pipeline on the synthetic world (or a KITTI
sequence), exports TUM/KITTI trajectories, and reports ATE when ground
truth is available:

    python -m scl_slam_tpu_torch.run --dataset synthetic --frames 120
    python -m scl_slam_tpu_torch.run --dataset synthetic --device cpu --frames 40
    python -m scl_slam_tpu_torch.run --dataset kitti --root /data/kitti --sequence 00
    python -m scl_slam_tpu_torch.run --dataset synthetic --odometry icp --deskew const
    python -m scl_slam_tpu_torch.run --dataset synthetic --odometry imu --deskew gyro

It runs on the GPU unless ``--device cpu`` is given. ``--odometry gt`` takes
the dataset's poses (with injected drift on the synthetic world);
``icp`` runs the scan-to-map point-to-plane front end
(``runtime/odometry.Odometry``), ``imu`` that front end fused with the
15-state IMU window smoother (``ImuFusedOdometry``, window 6, 32 samples
an interval), its IMU synthesized from the ground-truth motion (20 samples
at 0.01 s an interval); ``--deskew`` picks their motion compensation.

It replays a recorded sequence, so the solve throttle
(``mapping_process_interval``) reads the frame stamps, 0.1 s apart, and a
run does not depend on the machine's speed (the JAX runner reads the wall
clock). The last line of its output is a JSON report (``ate_rmse_m``, ``ate_rmse_odom_only_m``,
``loops_closed``, ``keyframes``, ``wall_s``, ...; the odometry-only ATE
with ``--odometry gt`` only, as in the JAX runner).

``--loader native`` (KITTI only) reads the scans with the C++ prefetching
loader (``io/native_loader.py``, built with g++ at first use), in order;
the run fails where it cannot be built. ``--figure`` (the default) writes
``trajectory.png`` beside the trajectories (``io/viz.py``); it needs
matplotlib, and where the figure fails the report says why
(``figure_error``) and the run goes on.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np


def build_argparser():
    p = argparse.ArgumentParser(description="scl_slam_tpu_torch single-robot pipeline")
    p.add_argument("--dataset", choices=["synthetic", "kitti"], default="synthetic")
    p.add_argument("--root", help="KITTI odometry root (contains sequences/, poses/)")
    p.add_argument("--sequence", default="00")
    p.add_argument("--frames", type=int, default=120, help="max frames to process")
    p.add_argument("--config", help="YAML config path")
    p.add_argument("--output", default=os.path.join(tempfile.gettempdir(), "scl_slam_tpu_torch_run"))
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the pipeline runs (default: the GPU)")
    p.add_argument("--odom-drift", type=float, default=0.05,
                   help="synthetic: random-walk odometry noise sigma "
                   "(m/frame translation; rotation sigma is 1/10 of it)")
    p.add_argument("--figure", dest="figure", action="store_true", default=True,
                   help="write trajectory.png (paths + loop chords + map) to "
                   "--output (default on; needs matplotlib)")
    p.add_argument("--no-figure", dest="figure", action="store_false")
    p.add_argument("--loader", choices=["python", "native"], default="python",
                   help="kitti scan reader: python (numpy fromfile) or native "
                   "(the threaded C++ prefetcher, csrc/dataloader.cpp)")
    p.add_argument("--odometry", choices=["gt", "icp", "imu"], default="gt",
                   help="odometry source: gt = dataset poses (+injected drift "
                   "for synthetic); icp = scan-to-map point-to-plane odometry; "
                   "imu = icp fused with the 15-state IMU window smoother (IMU "
                   "synthesized from the dataset motion). For synthetic icp/imu "
                   "use >= ~60 frames: fewer widen the frame spacing past the "
                   "ICP correspondence gate")
    p.add_argument("--deskew", choices=["none", "const", "gyro"], default="none",
                   help="motion compensation of the icp/imu front end: const = "
                   "constant twist from the motion prediction; gyro = the "
                   "gyro-integrated rotation trajectory (imu mode)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch", type=int, default=0, metavar="B",
                   help="replay mode: B frames per Mapper.add_frames call "
                   "(0 = sequential add_frame, the live mode)")
    p.add_argument("--replay-chunks", type=int, default=0, metavar="R",
                   help="with --batch B: R macro-batches per chunk through "
                   "Mapper.replay; 0 = one add_frames call per batch")
    return p


def emit_figure(args, mapper, est, dead, gt_poses, report) -> None:
    """Write the run figure (trajectory, loop chords, map) and put its path
    in the report, or the reason it failed (``figure_error``): the figure
    is auxiliary output and never fails the run."""
    if not args.figure:
        return
    try:
        from .io import viz

        sub = None
        if "ate_rmse_m" in report and "ate_rmse_odom_only_m" in report:
            sub = (
                f"ATE {report['ate_rmse_m']:.3f} m optimized vs "
                f"{report['ate_rmse_odom_only_m']:.3f} m odometry-only  ·  "
                f"{report['loops_closed']} loops"
            )
        elif "ate_rmse_m" in report:
            sub = f"ATE {report['ate_rmse_m']:.3f} m  ·  {report['loops_closed']} loops"
        report["figure"] = viz.save_run_figure(
            os.path.join(args.output, "trajectory.png"),
            est,
            odom=dead,
            gt=gt_poses,
            loops=mapper.loop_constraints(),
            map_points=mapper.global_map(max_points=1 << 16),
            title=f"scl_slam_tpu_torch — {args.dataset}, {report['frames']} frames",
            subtitle=sub,
        )
    except Exception as e:  # the figure is auxiliary output
        report["figure_error"] = str(e)


def native_scans(paths):
    """``get_scan(k)`` over the C++ prefetching loader: the scans of
    ``paths`` streamed in order (the run loop asks for them in order)."""
    from .io.native_loader import NativeScanLoader

    stream = iter(NativeScanLoader(paths))
    next_k = [0]

    def get_scan(k):
        if k != next_k[0]:
            raise ValueError("the native loader streams the scans in order")
        xyz, n = next(stream)
        next_k[0] += 1
        return xyz[:n]

    return get_scan


def demo_config(odom_drift: float):
    """The synthetic demo's configuration (``scl_slam_tpu/run.py``): a short
    exclusion window, denser keyframe storage, the synthetic world's
    fitness gate, and a noise model that states the injected drift."""
    from .config import KeyframeConfig, ScanContextParams, SlamConfig

    cfg = SlamConfig()
    d = max(odom_drift, 1e-4)
    return dataclasses.replace(
        cfg,
        keyframe=KeyframeConfig(
            max_keyframes=512,
            points_per_keyframe=8192,
            raw_points_capacity=32768,
            distance_threshold=1.0,
            descript_leaf_size=0.3,
        ),
        scan_context=ScanContextParams(exclude_recent=15, distance_threshold=0.25),
        loop=dataclasses.replace(
            cfg.loop,
            history_fitness_score=8.0,
            submap_capacity=16384,
            near_keyframes=15,
        ),
        optimizer=dataclasses.replace(
            cfg.optimizer,
            odometry_sigmas=(d * 0.1,) * 3 + (d,) * 3,
            # fitness-as-variance calibration of this world (its fitness
            # floor is its sampling spacing, the alignment error cm-scale)
            loop_noise_scale=0.01,
        ),
    )


def synthetic_sequence(frames: int, seed: int, odom_drift: float):
    """The demo's world, trajectory and drifting odometry. Returns
    (n, get_scan, get_odom, gt_of), each a function of the frame index;
    poses are 4x4 arrays."""
    import torch

    from .geometry import se3
    from .io import kitti as kio

    world = kio.SyntheticWorld(
        seed=seed, extent=120.0, pts_per_cluster=800, max_range=50.0
    )
    # frame spacing stays ~1.5 m: up to two laps, fewer for short runs
    laps = float(min(2.0, max(1.25, frames * 1.5 / (2 * np.pi * 10.0))))
    radius = max(10.0, frames * 1.5 / (2 * np.pi * laps))
    gt = kio.loop_trajectory(n_frames=frames, radius=radius, laps=laps)
    # random-walk odometry noise (sigma = odom_drift m/frame, rotation
    # sigma 1/10 of it): the error process the noise model describes
    drift_rng = np.random.RandomState(seed + 17)
    odom = [gt[0]]
    for k in range(1, frames):
        inc = np.linalg.inv(gt[k - 1]) @ gt[k]
        xi = np.concatenate(
            [drift_rng.randn(3) * odom_drift * 0.1, drift_rng.randn(3) * odom_drift]
        )
        noise = se3.to_matrix(se3.exp(torch.tensor(xi, dtype=torch.float32))).numpy()
        odom.append(odom[-1] @ inc @ noise)
    return (
        frames,
        lambda k: world.scan_at(gt[k], max_points=32768, seed=k),
        lambda k: odom[k],
        lambda k: gt[k],
    )


def _pose(T):
    from .geometry import se3

    T = np.asarray(T, np.float32)
    return se3.Pose(T[:3, :3], T[:3, 3])


def run_live(mapper, n: int, get_scan, get_odom, front_end=None):
    """The live loop: ``add_frame`` per frame, ``spin_once`` per keyframe
    (throttled on the frame stamps), one final ``optimize``. The pose is
    ``get_odom(k)`` (4 x 4), or ``front_end(k, scan)`` (a Pose) where a
    front end is given. Returns (keyframe frame indices, loops as (frame,
    loop dict) pairs)."""
    kf_frames, loops = [], []
    for k in range(n):
        stamp = 0.1 * k
        scan = get_scan(k)
        pose = front_end(k, scan) if front_end is not None else _pose(get_odom(k))
        wire = mapper.add_frame(pose, scan, stamp=stamp)
        if wire is not None:
            kf_frames.append(k)
            info = mapper.spin_once(now=stamp)
            if info.get("loop"):
                loops.append((k, info["loop"]))
    mapper.optimize()
    return kf_frames, loops


def _run_batched(args, mapper, n, get_scan, get_odom):
    """Replay mode: fixed-size batches through ``Mapper.add_frames`` (or
    chunks through ``Mapper.replay``); the trailing partial batch goes
    through ``add_frame``. Returns (keyframe frame indices, loops closed)."""
    B = args.batch
    kf_frames, n_loops = [], 0
    if args.replay_chunks > 0:
        frames = list(range(n))
        out = mapper.replay(
            [_pose(get_odom(i)) for i in frames], [get_scan(i) for i in frames],
            stamps=[0.1 * i for i in frames], batch=B, chunk_batches=args.replay_chunks,
        )
        kf_frames.extend(i for i, a in zip(frames, out["accepted"]) if a)
        n_loops += sum(1 for x in out["loops"] if x)
    else:
        k = 0
        while k + B <= n:
            frames = list(range(k, k + B))
            out = mapper.add_frames(
                [_pose(get_odom(i)) for i in frames], [get_scan(i) for i in frames],
                stamps=[0.1 * i for i in frames],
            )
            kf_frames.extend(i for i, a in zip(frames, out["accepted"]) if a)
            n_loops += sum(1 for x in out["loops"] if x)
            mapper.spin_once(now=0.1 * k)
            k += B
        for i in range(k, n):
            if mapper.add_frame(_pose(get_odom(i)), get_scan(i), stamp=0.1 * i) is not None:
                kf_frames.append(i)
                if mapper.spin_once(now=0.1 * i).get("loop"):
                    n_loops += 1
    mapper.optimize()
    return kf_frames, n_loops


def make_front_end(args, gt_of):
    """The ``--odometry icp|imu`` front end as ``front_end(k, scan) ->
    Pose`` on ``--device``, or None for ``gt``. The imu mode's IMU is
    synthesized from the ground-truth motion between frames (KITTI odometry
    ships none), 20 samples at 0.01 s, none before the first frame."""
    from .runtime import imu as imu_mod
    from .runtime.odometry import ImuFusedOdometry, Odometry, OdometryConfig

    if args.odometry == "icp":
        odo = Odometry(OdometryConfig(deskew=args.deskew), device=args.device)
        return lambda k, scan: odo.step(scan)[0]
    if args.odometry != "imu":
        return None
    # a 6-node window of 32-sample intervals, as the JAX runner's
    fused = ImuFusedOdometry(OdometryConfig(deskew=args.deskew), window=6,
                             max_samples=32, device=args.device)

    def step(k, scan):
        if k == 0:
            acc = gyr = np.zeros((1, 3), np.float32)
            dts = np.zeros((1,), np.float32)
        else:
            acc, gyr, dts = imu_mod.synthesize_between_frames(gt_of(k - 1), gt_of(k), 20, 0.01)
        return fused.step(scan, acc, gyr, dts)[0]

    return step


def main(argv=None):
    args = build_argparser().parse_args(argv)
    if args.loader == "native" and args.dataset != "kitti":
        print("--loader native requires --dataset kitti (the synthetic world "
              "has no .bin files to prefetch)", file=sys.stderr)
        return 2
    if args.batch and args.odometry != "gt":
        print("--batch requires --odometry gt (precomputed poses)", file=sys.stderr)
        return 2

    import torch

    from .config import SlamConfig, load_config
    from .io import kitti as kio
    from .io import trajectory as tio
    from .runtime import Mapper

    if args.config:
        cfg = load_config(args.config)
    elif args.dataset == "synthetic":
        cfg = demo_config(args.odom_drift)
    else:
        cfg = SlamConfig()
    mapper = Mapper(cfg, device=args.device)

    if args.dataset == "kitti":
        if not args.root:
            print("--root required for kitti", file=sys.stderr)
            return 2
        seq = kio.KittiSequence(args.root, args.sequence)
        n = min(len(seq), args.frames)
        if args.loader == "native":
            get_scan = native_scans([os.path.join(seq.velo_dir, f) for f in seq.frames[:n]])
        else:
            get_scan = seq.scan
        get_odom = gt_of = seq.gt_pose_velo  # stand-in odometry
        if gt_of(0) is None:
            print("no odometry available (kitti gt missing)", file=sys.stderr)
            return 2
    else:
        n, get_scan, get_odom, gt_of = synthetic_sequence(
            args.frames, args.seed, args.odom_drift
        )

    front_end = make_front_end(args, gt_of)

    t_start = time.perf_counter()
    if args.batch:
        kf_frames, n_loops = _run_batched(args, mapper, n, get_scan, get_odom)
    else:
        kf_frames, loops = run_live(mapper, n, get_scan, get_odom, front_end)
        n_loops = len(loops)
    if mapper.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t_start

    mapper.save_trajectories(args.output)
    est = mapper.trajectory()
    report = {
        "frames": n,
        "keyframes": len(est),
        "loops_closed": n_loops,
        "wall_s": round(wall, 2),
        "frames_per_s": round(n / wall, 2),
        "device": (
            torch.cuda.get_device_name(mapper.device)
            if mapper.device.type == "cuda" else "cpu"
        ),
        "output": args.output,
    }
    if args.batch:
        report["batch"] = args.batch
    gt_poses = np.stack([gt_of(k) for k in kf_frames])
    report["ate_rmse_m"] = round(tio.ate_rmse(est, gt_poses), 4)
    dead = None
    if args.odometry == "gt":
        dead = np.stack([np.asarray(get_odom(k)) for k in kf_frames])
        report["ate_rmse_odom_only_m"] = round(tio.ate_rmse(dead, gt_poses), 4)
    emit_figure(args, mapper, est, dead, gt_poses, report)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
