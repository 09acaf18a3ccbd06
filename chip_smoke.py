#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``scl_slam_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. the card: fails without CUDA; prints ``nvidia-smi``'s name and power
   limit;
2. builds the CUDA kernels from ``scl_slam_tpu_torch/csrc`` with nvcc and
   prints the build seconds and ptxas' register/shared-memory report (the split
   kernels of K1, K7, K8, K4, K3 and K5 are the ``nn_split_kernel``
   entries);
3. K1 (batched 1-NN + payload select) against its plain PyTorch version on
   the card at both ICP shapes of the replay path, with inactive lanes and
   planted exact ties: d2 bit-equal, selection equal up to the stated tie
   tolerance; kernel and plain times by CUDA events; the launch geometry
   (blocks, warps per SM, slices), the time beside PERF.md's row from
   before the split-target design, and the share of the bound beside the
   50% issue ceiling;
4. K2 (max image) against its plain version into 20 x 60 bins at every
   shape the main paths launch it: one frame of 131,072, 65,536 and 32,768
   points of ``dense_world`` scans (live-kitti, ``run_multi``'s
   ``add_frame``, the demo), 16 and 32 frames of 65,536 points of bench.py's
   random scans (fleet bench, replay bench): bit-equal; kernel, plain and
   ``scatter_reduce_`` times, the launch geometry, the bound and its share,
   the row from before the redesign where there is one, and the floor of a
   timed launch;
5. the replay slice at the bench configuration (bench.py's pipeline
   workload: 192 frames of 65,536 points, 4,096-keyframe DB) through
   ``Mapper.replay``: warm-up, then timed on a fresh Mapper; the K1 and K2
   launch counters must grow; prints frames/s, loops and launch counts,
   the ICP lanes and their fitness, and the device's busy share and top
   kernels over one chunk under torch.profiler (the whole table goes to
   ``chiprun_out/profile_replay.txt``);
6. cross-device agreement on a revisiting synthetic world at a reduced
   size: the same frames through the port on the CPU (plain versions) and
   on the card (kernels) must make the same loop decisions;
7. K4 (solo 1-NN + payload select, lowest index on exact ties) against its
   plain version on the card at both ICP shapes of the live path (256 x
   4,096 and 1,024 x 16,384, P = 4) and at P = 8, with planted exact ties
   and padded targets: d2 bit-equal, selection equal; the geometry, the
   earlier row and the share of the bound as in phase 3;
8. the live demo ``python -m scl_slam_tpu_torch.run --dataset synthetic``
   on the card with its defaults (120 frames): it must close loops and
   end with an ATE below odometry-only; then a ``DEMO_CROSS_FRAMES``-frame
   run on the CPU (plain versions) and on the card must make the same
   loop decisions and match the same keyframes, with the trajectories
   within the stated tolerance;
9. live latency at the widths of ``configs/kitti_velodyne.yaml`` (built in
   code): 260 keyframes of a revisiting drive with scans of up to 131,072
   points through ``add_frame`` + ``spin_once`` (per-keyframe p50/p99 ms,
   ICP attempts, K2/K4 launches), then 32 ground-truth loop factors queued
   and one ``Mapper.optimize()`` timed at the full 4,096-pose / 8,192-edge
   capacity against the 0.3 s ``mapping_process_interval``;
10. K3 (solo 1-NN: distance and index, lowest index on exact ties) against
   its plain version on the card at 256 x 4,096, 4,096 x 8,192 (the
   default configuration's verification) and 4,096 x 16,384 (the
   kitti_velodyne widths), with planted exact ties and padded targets: d2
   bit-equal, index equal; the geometry, the earlier row and the share of
   the bound as in phase 3;
11. the inter-robot path: ``python -m scl_slam_tpu_torch.run_multi --robots
   2`` with its defaults (120 frames, the default ``SlamConfig``) on the
   card, with every inter-robot layer timed alone (a synchronize before
   and after each); it must verify inter-robot loops, with one K3 launch
   per verification; prints the loops, the wall time, per-verification ms
   (p50/p99), the layers' times and the joint ATE, and replays 10 of its
   verification RPCs under torch.profiler (the table goes to
   ``chiprun_out/profile_verify.txt``); then ``--robots 3`` for
   ``MULTI3_FRAMES`` frames; then a
   reduced two-robot session on the CPU and on the
   card, which must make the same retrieval hits and inter-loop decisions,
   with the trajectories within the stated tolerance;
12. ``run_multi --robots 2 --transport tcp`` on the card: two worker
   processes share it and verify inter-robot loops over sockets;
13. K6 (batched RANSAC hypothesis scoring: inlier counts) against its
   plain version on the card at the fleet run's 2 x 256 x 1,024, the fleet
   bench's 16 x 256 x 1,024, a full keyframe's 16 x 256 x 4,096 and a
   ragged 3 x 37 x 1,000, with points planted exactly on the threshold and
   a lane without a good point: counts equal; times, the launch geometry,
   the bound and its share, the row from before the redesign;
14. the fleet bench at full width (bench.py's fleet workload built in code:
   2 robots x 2,048 keyframes of 4,096 points, 65,536-point scans,
   8,192-point submaps, 20 ICP iterations): 4 steps of 16 keyframes through
   ``_fleet_step`` on a fresh state, median of 5 runs ended by a
   synchronize (``fleet_frames_per_s``), with the K1, K2 and K6 launches,
   the intra and inter attempts and the loops of an untimed run before
   them (their counting reads the card); one step under
   torch.profiler (``chiprun_out/profile_fleet.txt``);
15. ``run_multi --robots 2 --fleet`` at its defaults (120 frames, the
   default ``SlamConfig``): it must verify inter-robot loops through K6;
   its loop count is printed beside phase 11's decentralized one;
16. tests/test_fleet.py's reduced two-robot fleet on the CPU and on the
   card: the same retrieval hits, the same intra and inter decisions, the
   same keyframes per robot block, the trajectories within the stated
   tolerance;
17. eviction on the card: a fleet at 8 keyframes a robot and a replay past
   its capacity compact their blocks, keep the protocol indices monotone
   and export every keyframe through ``full_trajectory``;
18. K5 (one fused ICP iteration -> 18 Kabsch moment sums), both bodies,
   against its plain version at the bench's two ICP stage shapes (32 x
   1,024 x 8,192 and 32 x 256 x 2,048, 24 of 32 lanes active): the counts
   equal, every sum within 2e-6 of its terms' absolute mass of their exact
   sum, inactive lanes zero, mineq == argmin on tie-free inputs; then the
   mineq body on planted exact ties (identical and equidistant distinct
   targets), held the same way; times, the launch geometry, the earlier
   row and the share of the bound as in phase 3;
19. K7 (batched 1-NN index) and K1's argmin body against their plain
   versions at 32 x 1,024 x 8,192 and the fleet RANSAC's 16 x 1,024 x
   8,192, with planted exact ties: d2, index and selection bit-equal, K7 +
   one gather equal to K1-argmin; times;
20. K8 (K1's argmin contract by the expanded form) at 32 x 1,024 x 8,192 on
   recentred coordinates: bit-equal to its plain version; against K1 at
   least 99% identical winners, each winner's exact d2 within 5e-3 of
   K1's; times, the launch geometry, the earlier row and the share of the
   bound as in phase 3;
21. phase 5's replay under each batched-ICP switch (default, ``FUSED_ICP``,
   ``NN_INDEX``, ``MXU_NN``, ``SELECT_VARIANT="argmin"``): a warm-up, an
   untimed counting run, 5 timed runs (median frames/s and every run);
   each must launch its kernel (K5 and no K1; K7 and no K1; K8, and K1 for
   the exact final pass; K1's argmin body) and pass phase 5's state checks;
22. the revisit workload at 4,096-point submaps under each switch on the
   card: the default must close loops, and ``FUSED_ICP``, ``NN_INDEX`` and
   argmin must make its loop decisions, matched indices and queue
   endpoints, with z_t within 5e-3 m but for loops whose ICP lane ended at
   the stall exit (within its 1e-2 m bound); ``MXU_NN``'s loops are
   printed beside the default's; the fused run also on the CPU (the same
   checks against the card's); then the fleet bench's RANSAC under
   ``NN_INDEX`` (K7) must equal the argmin run and the default's attempts
   and successes;
23. the LiDAR simulator (``io/lidar_sim.py``) at the anchor's 1,024
   azimuths on the card against the CPU at 3 of its poses with the same
   injected noise: no ray's valid flag flipped, the points within 1e-4 m;
   ms a scan;
24. the quality anchor (``bench_quality.run_session``) at full width and
   depth on the card: 1,224 keyframes of the urban proxy world in 6 x 32
   replay chunks with a drain after each and eviction at capacity 1,024,
   held to ``tests/golden/quality_ate.json`` (ATE <= 3.272 m, ratio <=
   0.9) with keyframes evicted; its K1 and K2 launches, then K1 at the two
   shapes it launched most and K2 on 32 of its scans against their plain
   versions, alone and 20 to a graph, with their bounds;
25. the anchor session's first 384 frames (two 6 x 32 chunks, capacity
   cut to 256 so that the second evicts) on the CPU and on the card, on
   the same scans: every frame's loop decision and matched index the same, the
   descriptors within 1e-4, the trajectories within 1e-2 m and the card's
   last solve again on the CPU within 1e-3 m, raw where every drain kept
   the same start in both runs (``record_drains``), else each start held
   against its own;
26. phase 6's revisit world under ``storage_downsample="voxel_hash"`` (the
   hash path), ``"voxel"`` and ``use_pcm=True``, each on the CPU and the
   card and then drained: the same decisions, queue and drained edges,
   opt_t within 1e-3 m as in phase 25;
   ``pcm_filter`` on a 256-slot queue with planted outliers: the same
   accept mask; ``chain_solve`` on a 2-lap circle with loops: card against
   CPU within 1e-3 m, its ms beside one ``solver.solve`` of the graph;
27. ``run_multi --robots 4 --config configs/four_robot_cityscale.yaml``
   (PCM on, the configuration's widths) on the card for
   ``CITYSCALE_FRAMES`` frames: it must exit 0; prints the inter loops,
   the loops PCM rejected and the wall;
28. checkpoint on the card (``runtime/checkpoint.py``): phase 9's session
   (260 keyframes in 4,096 x 4,096-point slots) saved, then loaded onto
   the CPU and onto the card, bit-equal; the file's bytes, the save and
   load seconds and how long the locks were held; the resumed card
   mapper and the uninterrupted one go on 30 frames of a third lap, the
   CPU's on the first ``CKPT_CPU_FRAMES`` of them: the same keyframes, ICP
   attempts and loop decisions, the trajectories within 1e-4 m (card) and
   1e-3 m (CPU), K2 and K4 launched by the resumed run;
29. ``run_multi --robots 2 --transport tcp --respawn 2 --checkpoint-every
   RESPAWN_CKPT_EVERY --crash-robot 0 --crash-after RESPAWN_CRASH_AFTER``
   at its default 120
   frames: exit 0, ``respawn
   1/2`` on stderr, inter loops, both robots' ATE under 1 m, K2 and K3
   launched in the workers; printed beside phase 12's uncrashed run;
30. the serving daemon (``python -m scl_slam_tpu_torch.serve --config
   configs/kitti_velodyne.yaml``) on a free port with a map export every
   second: a revisiting drive of the simulator's urban world (2,048
   azimuths, up to 131,072 points a scan) with its poses; it must close
   loops, launch K2 a keyframe and K4, answer ``trajectory``, write the
   five exports on ``save``, have published, and exit 0 on ``shutdown``;
   per-request ms p50/p99 against the 100 ms sensor period; an in-process
   card Mapper fed the same frames makes the same keyframe and loop
   decisions, its trajectory within 1e-3 m (after yaw and translation
   only where one of its drains tied its two starts);
31. K2 at LiDAR-Iris's 80 x 360 bins (113 KB of shared memory a block, by
   the opt-in) against its plain version on the simulator's scans as
   ``lidar_iris.make`` hands them over: one frame's 9 channels [9,
   131,072] (the live path) and a 32-frame batch's [288, 131,072]:
   bit-equal; times, ``scatter_reduce_``, the bound and the geometry; then
   phase 4's Scan Context shapes timed again after the opt-in;
32. LiDAR-Iris on the simulator's scans at 1,800 azimuths on the card and
   on the CPU: tests/test_iris_realistic.py's true and false pairs, the
   0.32 gate separating them with a 2x margin, the distances of the two
   devices within the bound their flipped feature bits imply; ms a make
   and a match;
33. tests/test_iris_realistic.py's live Iris session on the card (296
   frames at 1,024 azimuths): >= 5 loops, ATE < 0.85 of dead reckoning's;
   a keyframe's p50/p99 ms, K2 a keyframe and K4 launched;
34. ``run_multi --robots 2 --config configs/two_robot_iris.yaml`` at the
   configuration's widths on the card: exit 0, inter loops, each robot's
   ATE under 1 m, one K3 launch a verification; then phase 11's reduced
   two-robot session under LiDAR-Iris on the CPU and on the card with the
   same hits and decisions;
35. M2DP, GRSD, FPFH and SHOT through ``Mapper.add_frame`` at 131,072 raw
   points (dense_world scans), 3 keyframes each, ms a make; the card's
   k-NN against the CPU's exact ranking on sampled rows, and each family's
   descriptor against the CPU's make fed that k-NN, within the stated
   tolerances.
36. K4 at the point-to-plane odometry's shape (4,096 x 32,768, P = 8,
   half the map PAD_VALUE rows, planted exact ties): d2 bit-equal, the
   selection equal; alone and 20 to a graph, the plain time, the bound and
   its share, the geometry and the split it took;
37. the ICP odometry (``runtime/odometry.Odometry`` at its defaults) on
   18 of the simulator's skewed sweeps at 1,800 azimuths
   (tests/test_deskew.py's ATE recovery at full width): deskew "const"
   beats "none" by 0.7 and lands under 0.6 m; ms a frame p50/p99, K4
   launches a frame, one frame under torch.profiler; 8 frames on the CPU
   and on the card, poses within ``FRONT_CROSS_ATOL``;
38. ``ImuFusedOdometry`` (deskew "gyro", window 6, 32 samples) at full
   width, its IMU exact under the preintegrator's scheme: from rest (5
   m/s^2) the divergence gate never fires; ms a frame, the smoother's
   solve ms; then on phase 37's 20 m/s sweeps, where the window's cold
   start fires the gate on the first frames (as in the JAX package), the
   output's ATE under 0.6 m;
39. ``run --dataset synthetic --odometry icp`` and ``--odometry imu
   --deskew gyro`` at the demo's widths, ``RUNNER_FRONT_FRAMES`` frames:
   exit 0, loops and ATE;
40. the daemon with ``--odometry icp`` answering pose-less frames of the
   simulator (a drive 1 m a frame) with finite poses, its ATE beside an in-process
   ``Odometry`` + ``Mapper`` on the card (the same keyframes, the
   trajectories within 1e-3 m);
41. the C++ prefetching loader (``io/native_loader.py``) built from the
   checkout: 24 scans of the simulator (up to 131,072 points) written as a
   KITTI tree, read at a 131,072-point capacity (scans/s), each bit-equal
   to the Python reader's; ``run --dataset kitti --loader native`` and
   ``--loader python`` on the card with the same keyframes and loops; the
   Euler and quaternion conversions on the card against the CPU;
42. ``parallel/sharded.sharded_solve`` at four_robot_cityscale.yaml's
   widths (16,384 poses, 32,768 edges, coarse stride 32, 96 PCG steps, 10
   Gauss-Newton steps) in a world of size 1 over NCCL and in two ranks
   sharing the card over gloo (NCCL refuses two ranks on one GPU), held
   against each other, and a 1,024-pose problem card against CPU in both;
   ms and all-reduces a solve;
43. ``parallel/dryrun.dryrun_multichip`` on the card at 2 x gloo and 1 x
   NCCL, then a ``FleetMapper`` at the city-scale widths with the DB
   sharded and the drain on the mesh over two gloo ranks against the
   whole-DB fleet (counts, queue, loops, trajectories); K1, K2 and K6
   launches and wall seconds;
44. the replay's input modes: phase 5's workload under ``transfer="f32"``,
   ``"int16"`` and ``host_descriptors=True``, 3 runs each in turns (the
   frames/s of each run, the bytes copied to the card a chunk, K1 and K2
   launches: none of K2 under ``host_descriptors``, whose one chunk has no
   remainder), each run's state checks; the host images (the C++
   ``sc_images_batch``) against K2's from the ``f32`` run on the same
   frames, at most ``HOST_IMAGE_BINS`` bins > 1e-5 apart in any 4 frames
   (the CPU test's bound); one ``host_descriptors`` run of the workload in
   3 chunks of 64 frames, where the next chunk's binning runs on a worker
   thread beside the card (the binning's ms a chunk, and the share of it
   the main thread did not wait for); then phase 24's anchor on its kept
   scans under ``host_descriptors``, under ``int16`` and under ``f32`` on
   the same scans round-tripped through int16 on the host: each passes the
   unchanged golden gate, and each mode's loops are within
   ``ANCHOR_LOOP_SPREAD`` of the ``f32`` run on its scans (phase 24's for
   host images; 5 mm quantization moves the session's loops: 576-581
   against 590-594).

Kernel times are CUDA events around replays of a CUDA graph of the call
(device time without the host's launch cost), beside the eager call's
time and, for K1, K2 and K6, 20 calls to a graph (without the host's replay
between launches, which a launch of a few microseconds does not hide);
each kernel's bound is the larger of its bytes over 3.35 TB/s and
its FP32 operations over 67 TFLOP/s (the H100 SXM data sheet at 700 W),
counted from this run's shapes (9 operations a query-target pair for K1,
K3, K4, K5, K7 and K8, 27 a hypothesis-point pair for K6, 13 bytes a
point for K2). The line before the last is a JSON object
with one entry per kernel, K4 twice (at the live path's shape and, as
``nn_select_odometry``, at the odometry's) (K1's, K2's, K6's and K4's at the
odometry shape also with ``graph20_ms``, the
time a launch of 20 to a graph, since their ``ms`` at the one-frame
shapes reads the launch floor); the last line is ``{"ok": true,
"device": {...}}``. This script imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# K1 tie averages of three or more distinct points may be summed in another
# order by the kernel (ascending target order) and the plain version (a
# matmul): allowed 2 ulp of the largest payload magnitude.
TIE_ULPS = 2


def log(msg: str) -> None:
    print(msg, flush=True)


def time_cuda(torch, fn, reps: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` by CUDA events around ``reps``
    back-to-back calls, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_graph(torch, fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` as the card runs it: ``fn`` is
    captured once in a CUDA graph (after warm-up on a side stream), and
    ``reps`` replays are timed by CUDA events, so the host's launch cost
    is left out."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_graph_many(torch, fn, n: int = 20, reps: int = 10) -> float:
    """Mean milliseconds per call of ``fn`` with ``n`` calls captured in one
    CUDA graph: the device's time without the host's cost between replays,
    which bounds :func:`time_graph` from below for a launch shorter than
    the host's replay."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * n)


# the H100 SXM's published peaks at 700 W (NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """(least milliseconds, what bounds it): the larger of the bytes over
    the memory rate and the FP32 operations over the FP32 peak."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# PERF.md's rows (NVIDIA H100 80GB HBM3, 700.00 W; CUDA-graph replays):
# each kernel's time before it moved onto the split-target design, or
# before its redesign
ROW_MS = {
    "K1-mineq full": 0.4269, "K1-mineq coarse": 0.1060,
    "K1-argmin replay": 0.1847, "K1-argmin fleet_ransac": 0.1369,
    "K7 replay": 0.1421, "K7 fleet_ransac": 0.0993,
    "K4 full": 0.0188, "K4 coarse": 0.0119, "K4 full_p8": 0.0190,
    "K3 full": 0.0273, "K3 small": 0.0123, "K3 kitti": 0.0477,
    "K5-mineq full": 0.4334, "K5-mineq coarse": 0.1101,
    "K5-argmin full": 0.1830, "K5-argmin coarse": 0.0401,
    "K8 replay": 0.1784,
    # K2 and K6 before their redesign for Hopper (the other shapes of
    # phases 4 and 13 had no row)
    "K2 replay": 0.0228, "K6 fleet": 0.0091, "K6 keyframe": 0.0280,
}


def split_geometry(torch, g, lanes: int, active_lanes: int) -> str:
    """The launch of a split-target kernel (csrc/nn_split.cuh): blocks,
    the working ones (of active lanes), their warps per SM, and the
    slices."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    working = g.q_groups * g.slices * active_lanes
    return (f"{g.q_groups * g.slices * lanes} blocks ({working} working) of "
            f"{g.threads // 32} warps, {32 * g.rq} queries a block, "
            f"{working * g.threads / 32 / sms:.1f} warps/SM; {g.slices} slices of "
            f"{g.slice_len} targets, {-(-g.slice_len // (g.threads // 32))} a warp")


def versus_row(key: str, ms: float, bound_ms: float) -> str:
    """The time beside PERF.md's row from before the split-target design
    and the share of the bound. The build's -fmad=false makes each of the
    9 operations of a pair its own instruction, so 50% of the stated FP32
    bound is the issue ceiling."""
    old = ROW_MS[key]
    return (f"row before the split design {old:.4f} ms, now {old / ms:.2f}x as fast; "
            f"{100 * bound_ms / ms:.1f}% of the bound (issue ceiling 50%)")


# ---------------------------------------------------------------------------
# workloads
# ---------------------------------------------------------------------------


def bench_scans(n_frames: int, n_pts: int, seed: int = 0) -> list:
    """bench.py's pipeline generator: independent random scans, r in
    [2, 75] m, z a sector wave plus noise (bench.py:447-456)."""
    rng = np.random.RandomState(seed)
    out = []
    for k in range(n_frames):
        theta = rng.uniform(-np.pi, np.pi, n_pts)
        r = rng.uniform(2, 75, n_pts)
        z = np.sin(theta * 3 + k * 0.1) * 2 + rng.normal(0, 0.4, n_pts) - 1.0
        out.append(
            np.stack([r * np.cos(theta), r * np.sin(theta), z], -1).astype(np.float32)
        )
    return out


def revisit_world(n_frames: int, max_points: int, seed: int = 3):
    """A static world of box buildings (surface samples) on a ground plane,
    and a trajectory of two laps of a 30 m circle: the second lap revisits
    the first, so Scan Context hits and ICP-verified loops occur. Returns
    (poses as 4x4 [N, 4, 4], scans in the sensor frame)."""
    rng = np.random.RandomState(seed)
    pts = []
    for _ in range(80):
        c = rng.uniform(-120, 120, 2)
        s = rng.uniform(2.0, 12.0, 2)
        h = rng.uniform(3.0, 15.0)
        n = 160
        u = rng.uniform(-1, 1, (n, 4))
        zs = rng.uniform(0, h, (n, 4))
        pts += [
            np.column_stack([c[0] + u[:, 0] * s[0], np.full(n, c[1] - s[1]), zs[:, 0]]),
            np.column_stack([c[0] + u[:, 1] * s[0], np.full(n, c[1] + s[1]), zs[:, 1]]),
            np.column_stack([np.full(n, c[0] - s[0]), c[1] + u[:, 2] * s[1], zs[:, 2]]),
            np.column_stack([np.full(n, c[0] + s[0]), c[1] + u[:, 3] * s[1], zs[:, 3]]),
        ]
    ground = rng.uniform(-120, 120, (8000, 2))
    pts.append(np.column_stack([ground, np.zeros(len(ground))]))
    world = np.concatenate(pts).astype(np.float32)

    poses, scans = [], []
    for k in range(n_frames):
        a = 4 * np.pi * k / n_frames
        yaw = a + np.pi / 2
        T = np.eye(4)
        T[:3, :3] = [[np.cos(yaw), -np.sin(yaw), 0], [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1]]
        T[:3, 3] = [30 * np.cos(a), 30 * np.sin(a), 1.8]
        vis = world[np.linalg.norm(world[:, :2] - T[:2, 3], axis=1) < 60.0]
        local = (vis - T[:3, 3]) @ T[:3, :3]
        if len(local) > max_points:
            local = local[np.random.RandomState(k).choice(len(local), max_points, replace=False)]
        poses.append(T)
        scans.append(local.astype(np.float32))
    return np.stack(poses), scans


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_card(torch) -> str:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "torch.cuda.is_available() is false: this smoke test needs an NVIDIA GPU"
        )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"[1] card: {smi}")
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    return smi


def phase_build(kernels) -> float:
    t0 = time.perf_counter()
    path, out = kernels.build(verbose=True)
    secs = time.perf_counter() - t0
    kernels.load_library()
    log(f"[2] built {os.path.relpath(path, ROOT)} in {secs:.2f} s "
        f"(one nvcc -c per source, all at once, then a link)")
    for line in out.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            log(f"[2]   {line.strip()}")
    return secs


def k1_inputs(torch, B, nq, nt, seed):
    """Queries are noisy copies of target points (ICP-like distances);
    every 4th lane is inactive; lane 1's targets come in triplicate and
    lane 2 has integer queries with three equidistant integer targets."""
    rng = np.random.RandomState(seed)
    t = rng.uniform(-60, 60, (B, nt, 3)).astype(np.float32)
    valid = rng.rand(B, nt) > 0.05
    pick = rng.randint(0, nt, (B, nq))
    q = np.take_along_axis(t, pick[..., None], 1) + rng.normal(0, 0.3, (B, nq, 3))
    q = q.astype(np.float32)
    t[1, 1::4] = t[1, 0::4]
    t[1, 2::4] = t[1, 0::4]
    valid[1, 1::4] = valid[1, 0::4]
    valid[1, 2::4] = valid[1, 0::4]
    c = rng.randint(-15, 15, (nq, 3)).astype(np.float32) * 4.0
    q[2] = c
    n_tie = min(nt // 3, nq)
    t[2, :n_tie] = c[:n_tie] + np.float32([1, 0, 0])
    t[2, n_tie : 2 * n_tie] = c[:n_tie] - np.float32([1, 0, 0])
    t[2, 2 * n_tie : 3 * n_tie] = c[:n_tie] + np.float32([0, 1, 0])
    valid[2, : 3 * n_tie] = True
    t[2, 3 * n_tie :] += 500.0  # keep lane 2's other targets out of the way
    t = np.where(valid[..., None], t, 1e6).astype(np.float32)
    payload = np.concatenate([np.swapaxes(t, -1, -2), valid[:, None].astype(np.float32)], 1)
    active = (np.arange(B) % 4 != 3).astype(np.int32)
    dev = torch.device("cuda")
    return (
        torch.from_numpy(q).to(dev),
        torch.from_numpy(np.ascontiguousarray(payload)).to(dev),
        torch.from_numpy(active).to(dev),
    )


def k1_case(torch, kernels, B, nq, nt, seed) -> dict:
    """K1 on k1_inputs at [B, nq, nt] against its plain version (d2
    bit-equal, the inactive lane unwritten, the planted ties found, the
    selection within the tie tolerance; or raise), and its times: by graph
    replays alone and 20 to a graph, the eager call's and the plain
    version's; with its bound."""
    q, payload, active = args = k1_inputs(torch, B, nq, nt, seed)
    d, sel = kernels.nn_select_batched(*args)
    d_p, sel_p = kernels.nn_select_batched_plain(*args)
    torch.cuda.synchronize()
    what = f"K1 {B}x{nq}x{nt}"
    if not torch.equal(d, d_p):
        raise AssertionError(f"{what}: d2 differs from the plain version in "
                             f"{(d != d_p).sum().item()} places")
    if not (torch.isinf(d[3]).all() and (sel[3] == 0).all()):
        raise AssertionError(f"{what}: an inactive lane was written")
    if not (d[2, : min(nt // 3, nq)] == 1.0).all():
        raise AssertionError(f"{what}: planted ties not found")
    scale = payload[:, :3][payload[:, :3] < 1e5].abs().max().item()
    tol = TIE_ULPS * 2.0 ** (np.floor(np.log2(scale)) - 23)
    err = (sel - sel_p).abs().max().item()
    if err > tol:
        raise AssertionError(f"{what}: sel differs by {err} > {tol}")
    # 9 FP32 operations per (query, target) pair of an active lane:
    # 3 subtracts, 3 multiplies, 2 adds, 1 compare
    n_active = int(active.sum().item())
    bound_ms, bound_by = bound(
        4 * (B * nq * 3 + B * 4 * nt + B + B * nq + B * 4 * nq), 9 * n_active * nq * nt
    )
    return {"max_abs_err": err, "tol": tol, "n_diff": (sel != sel_p).sum().item(),
            "n_active": n_active,
            "call_ms": time_cuda(torch, lambda: kernels.nn_select_batched(*args), reps=20),
            "ms": time_graph(torch, lambda: kernels.nn_select_batched(*args), reps=20),
            "many_ms": time_graph_many(torch, lambda: kernels.nn_select_batched(*args)),
            "plain_ms": time_graph(torch, lambda: kernels.nn_select_batched_plain(*args), reps=5),
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_k1(torch, kernels) -> dict:
    res = {}
    for B, nq, nt, label in ((32, 1024, 8192, "full"), (32, 256, 2048, "coarse")):
        r = k1_case(torch, kernels, B, nq, nt, seed=nq)
        log(f"[3] K1 {label} {B}x{nq}x{nt}: d2 bit-equal, sel max|diff| {r['max_abs_err']:.3g} "
            f"(tol {r['tol']:.3g}, {r['n_diff']} elements differ), kernel {r['ms']:.4f} ms "
            f"(20 to a graph {r['many_ms']:.4f} ms, eager call {r['call_ms']:.4f} ms), plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
        log(f"[3]   K1 {label} geometry: "
            f"{split_geometry(torch, kernels.k1_geometry(B, nq, nt), B, r['n_active'])}; "
            f"{versus_row('K1-mineq ' + label, r['ms'], r['bound_ms'])}")
        res[label] = r
    return res


# K2 at the shapes the main paths launch it: (label, B, N, scans, path and
# launches); dense: chip_smoke's dense_world scans (the live widths), bench:
# bench.py's random scans (every bin hit)
K2_SHAPES = (
    ("live_kitti", 1, 131072, "dense", "live-kitti, 260 launches"),
    ("add_frame", 1, 65536, "dense", "run_multi add_frame"),
    ("demo", 1, 32768, "dense", "demo, 120 launches"),
    ("fleet", 16, 65536, "bench", "fleet-bench, 4 launches"),
    ("replay", 32, 65536, "bench", "replay bench, 6 a chunk"),
)


def k2_inputs(torch, B, n, kind):
    """K2's inputs on the card as ``descriptors/scan_context.make`` hands
    them over (20 x 60 bins, 80 m, heights + 1.65 m): B dense_world scans
    of up to n points (padded, as the live path pads a scan) or B of
    bench.py's random scans, one of them partly padded."""
    from scl_slam_tpu_torch.io import kitti as kio
    from scl_slam_tpu_torch.ops import pointcloud as pc

    dev = torch.device("cuda")
    if kind == "dense":
        world = dense_world()
        gt = kio.loop_trajectory(n_frames=16, radius=45.0, laps=2.0)
        xyz = np.zeros((B, n, 3), np.float32)
        mask = np.zeros((B, n), bool)
        for b in range(B):
            scan = world.scan_at(gt[b], max_points=n, seed=b)
            xyz[b, : len(scan)] = scan
            mask[b, : len(scan)] = True
        xyz, mask = torch.from_numpy(xyz).to(dev), torch.from_numpy(mask).to(dev)
    else:
        xyz = torch.from_numpy(np.stack(bench_scans(B, n, seed=1))).to(dev)
        mask = torch.ones(xyz.shape[:2], dtype=torch.bool, device=dev)
        mask[min(5, B - 1), n * 5 // 8 :] = False  # one partly padded frame
    ring, sector, valid = pc.polar_bins(xyz, mask, 20, 60, 80.0)
    z = (xyz[..., 2] + 1.65).contiguous()
    return (z, ring.contiguous(), sector.contiguous(), valid.contiguous(), 20, 60)


def k2_case(torch, kernels, args, full: bool = True) -> dict:
    """K2 on ``args`` against its plain version (bit-equal, or raise), and
    its time by graph replays, alone and 20 to a graph; with ``full`` also the eager call's, the
    plain version's and the library call's (``scatter_reduce_`` "amax"
    over the flat bin index, prepared beforehand; it must equal too)."""
    img = kernels.max_image(*args)
    ref = kernels.max_image_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(img, ref):
        bad = (img != ref).sum().item()
        raise AssertionError(f"K2: image differs from the plain version in {bad} bins")
    res = {"max_abs_err": float((img - ref).abs().max().item()),
           "ms": time_graph(torch, lambda: kernels.max_image(*args), reps=50),
           "many_ms": time_graph_many(torch, lambda: kernels.max_image(*args))}
    if not full:
        return res
    z, ring, sector, valid, R, S = args
    B = z.shape[0]
    ok = valid & (z > 0)
    flat = torch.where(ok, ring.long() * S + sector.long(), R * S)
    vals = torch.where(ok, z, 0.0)
    lib_img = torch.zeros((B, R * S + 1), device=z.device)
    lib_img.scatter_reduce_(1, flat, vals, "amax", include_self=True)
    if not torch.equal(lib_img[:, : R * S].reshape(B, R, S), ref):
        raise AssertionError("K2: scatter_reduce_ amax disagrees with the plain version")
    res["call_ms"] = time_cuda(torch, lambda: kernels.max_image(*args), reps=50)
    res["plain_ms"] = time_graph(torch, lambda: kernels.max_image_plain(*args), reps=20)
    res["library_ms"] = time_graph(
        torch, lambda: lib_img.scatter_reduce_(1, flat, vals, "amax", include_self=True), reps=50
    )
    return res


def k2_bound(args) -> tuple[float, str]:
    """K2's bound on ``args`` from what this data needs: the 1-byte valid
    flag of every row, the value, ring and sector (12 bytes) of a valid row
    only (a padded row's are never used), the image written once; a
    compare and a max a valid row."""
    z, ring, sector, valid, R, S = args
    n_valid = int(valid.sum())
    return bound(valid.numel() + 12 * n_valid + z.shape[0] * R * S * 4, 2 * n_valid)


def launch_floor(torch) -> tuple[float, float]:
    """ms of a timed launch that does nothing, a one-element add, replayed
    as a CUDA graph as the kernels are timed: alone and 20 to a graph."""
    one = torch.zeros(1, device="cuda")
    return (time_graph(torch, lambda: one.add_(1), reps=50),
            time_graph_many(torch, lambda: one.add_(1)))


def phase_k2(torch, kernels) -> dict:
    floor, floor_many = launch_floor(torch)
    log(f"[4] the floor of a timed launch (a one-element add as a graph replay): {floor:.4f} ms "
        f"alone, {floor_many:.4f} ms 20 to a graph")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for label, B, n, kind, path in K2_SHAPES:
        args = k2_inputs(torch, B, n, kind)
        res = k2_case(torch, kernels, args)
        g = kernels.k2_geometry(B, n)
        vec = kernels._vector_ok(n, args[:3], args[3:4])
        bound_ms, bound_by = k2_bound(args)
        res.update(bound_ms=bound_ms, bound_by=bound_by)
        row = ROW_MS.get(f"K2 {label}")
        before = (f"row before the redesign {row:.4f} ms, now {row / res['ms']:.2f}x as fast"
                  if row else "no row before the redesign at this shape")
        log(f"[4] K2 {label} {B}x{n} ({kind} scans; {path}) -> 20x60: bit-equal, kernel "
            f"{res['ms']:.4f} ms (20 to a graph {res['many_ms']:.4f} ms, eager call "
            f"{res['call_ms']:.4f} ms), plain "
            f"{res['plain_ms']:.4f} ms, scatter_reduce_ {res['library_ms']:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / res['ms']:.1f}% of the bound")
        log(f"[4]   K2 {label} geometry: {B * g.chunks} blocks ({B * g.chunks / sms:.2f} per SM) "
            f"of {g.threads} threads, {g.chunks} chunks of {g.chunk_len} points a frame "
            f"({'atomics into a zeroed output' if g.chunks > 1 else 'stores'}), "
            f"{'16-byte' if vec else 'scalar'} loads; {before}")
        out[label] = res
    return out


def bench_cfg():
    from scl_slam_tpu_torch.config import (
        KeyframeConfig, LoopConfig, OptimizerConfig, ScanContextParams, SlamConfig,
    )

    # bench.py:427-445 (full size)
    return SlamConfig(
        keyframe=KeyframeConfig(
            max_keyframes=4096, points_per_keyframe=4096, raw_points_capacity=65536
        ),
        loop=LoopConfig(near_keyframes=25, submap_capacity=8192, icp_iterations=20),
        optimizer=OptimizerConfig(edge_capacity=2048, gn_iters=6, cg_iters=48),
        scan_context=ScanContextParams(),
    )


def kitti_velodyne_cfg():
    """``configs/kitti_velodyne.yaml`` (the Velodyne HDL-64 configuration)
    built in code, field for field: the card machine may lack PyYAML
    (``tests/test_torch_live.py`` holds it equal to the YAML)."""
    from scl_slam_tpu_torch.config import (
        DescriptorType, KeyframeConfig, LidarType, LoopConfig, OptimizerConfig,
        ScanContextParams, SlamConfig,
    )

    return SlamConfig(
        number_of_robots=1, robot_id=0, robot_name="a",
        lidar_type=LidarType.VELODYNE, n_scan=64,
        descriptor_type=DescriptorType.SCAN_CONTEXT,
        keyframe=KeyframeConfig(
            distance_threshold=1.0, angle_threshold=0.2, max_keyframes=4096,
            points_per_keyframe=4096, raw_points_capacity=131072,
            descript_leaf_size=0.2, map_leaf_size=0.4,
        ),
        loop=LoopConfig(
            history_fitness_score=0.3, icp_iterations=30, icp_max_corr_dist=10.0,
            near_keyframes=25, submap_capacity=16384, ransac_max_iter=256,
            ransac_outlier_threshold=0.25, ransac_inlier_ratio=0.45,
        ),
        optimizer=OptimizerConfig(gn_iters=8, cg_iters=64, mapping_process_interval=0.3),
        scan_context=ScanContextParams(
            num_rings=20, num_sectors=60, max_radius=80.0, lidar_height=1.65,
            num_candidates=10, exclude_recent=100, distance_threshold=0.14,
        ),
    )


class BenchReplay:
    """The bench workload of phase 5 (bench.py's pipeline workload), kept
    for phase 21: B = 32 lanes x R = 6 batches of 65,536-point scans."""

    B, R = 32, 6

    def __init__(self, torch):
        from scl_slam_tpu_torch.geometry import se3

        self.torch = torch
        self.cfg = bench_cfg()
        self.n = n = self.B * self.R
        self.n_pts = self.cfg.keyframe.raw_points_capacity
        t0 = time.perf_counter()
        self.scans = bench_scans(n, self.n_pts, seed=0)
        eye = np.eye(3, dtype=np.float32)
        self.poses = [se3.Pose(eye, np.float32([1.0 * k, 0.0, 0.0])) for k in range(n)]
        self.stamps = [0.0] * n
        self.gen_s = time.perf_counter() - t0

    def run(self, chunk_batches=None, **replay_kw):
        """One ``Mapper.replay`` of the workload on a fresh Mapper (B x R a
        chunk, or B x ``chunk_batches``; ``replay_kw``: the input mode),
        ended by a synchronize: (mapper, its output, seconds)."""
        from scl_slam_tpu_torch.runtime import mapper as M

        torch = self.torch
        m = M.Mapper(self.cfg)  # the card by default
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = m.replay(self.poses, self.scans, self.stamps, apply_gate=False,
                       batch=self.B, chunk_batches=chunk_batches or self.R, **replay_kw)
        torch.cuda.synchronize()
        return m, out, time.perf_counter() - t

    def timed(self, kernels):
        """A warm-up, an untimed counting run, then 5 timed runs. Returns
        (launches, mapper and output of the counting run, run seconds)."""
        self.run()
        kernels.reset_launch_counts()
        m, out, _ = self.run()
        launches = dict(kernels.LAUNCHES)
        return launches, m, out, [self.run()[2] for _ in range(5)]

    def check_state(self, m, out) -> int:
        """Phase 5's state checks; returns the loops closed."""
        torch, n = self.torch, self.n
        loops = sum(1 for x in out["loops"] if x)
        st = m.state
        traj = m.trajectory()
        checks = {
            "keyframes": int(st.counts[0]) == n == out["keyframes"],
            "edges": int(st.graph.num_edges) == n - 1,
            "queue": int(st.loop_queue.count) == loops,
            "finite": bool(np.isfinite(traj).all()) and traj.shape == (n, 4, 4),
            "poses": bool(np.allclose(traj[:, 0, 3], np.arange(n), atol=1e-3)),
            "db": bool(torch.isfinite(st.desc_db.descriptors[:n]).all())
            and int(st.desc_db.count) == n,
        }
        if not all(checks.values()):
            raise AssertionError(f"replay state checks failed: {checks}")
        return loops


def phase_slice(torch, kernels, bench: BenchReplay) -> dict:
    """Phase 5; returns the replay's frames/s (median of 5 runs) and the
    kernel launch counts of the untimed counting run."""
    from scl_slam_tpu_torch.geometry import se3
    from scl_slam_tpu_torch.runtime import mapper as M

    cfg, B, R, n, n_pts, scans = bench.cfg, bench.B, bench.R, bench.n, bench.n_pts, bench.scans
    log(f"[5] generated {n} bench scans in {bench.gen_s:.1f} s")
    launches, m, out, times = bench.timed(kernels)
    fps = n / float(np.median(times))
    if launches["max_image"] < R or launches["nn_select_batched"] < 1:
        raise AssertionError(f"replay did not go through both kernels: {launches}")
    loops = bench.check_state(m, out)
    log(f"[5] Mapper.replay {n} frames ({n_pts} pts, B={B} x {R}), 5 runs: "
        f"median {fps:.2f} frames/s "
        f"(run seconds {', '.join(f'{x:.4f}' for x in times)}); loops {loops}; "
        f"launches in the untimed counting run {launches}; state checks ok")

    # the same chunk with scans already on the card, as bench.py times it
    dev = torch.device("cuda")
    xyz = torch.from_numpy(np.stack(scans)).to(dev).reshape(R, B, n_pts, 3)
    mask = torch.ones((R, B, n_pts), dtype=torch.bool, device=dev)
    pose_b = se3.Pose(
        torch.eye(3, device=dev).expand(R, B, 3, 3).contiguous(),
        torch.tensor([[k, 0.0, 0.0] for k in range(n)], device=dev).reshape(R, B, 3),
    )
    st0 = torch.zeros((R, B), device=dev)
    dev_times = []
    for _ in range(3):
        state = M.make_state(cfg, dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, oks, _, fits = M._replay_batches(state, 0, pose_b, xyz, mask, st0, cfg)
        torch.cuda.synchronize()
        dev_times.append(time.perf_counter() - t)
    dev_fps = n / float(np.median(dev_times))
    log(f"[5] _replay_batches on card-resident scans, 3 runs: median {dev_fps:.2f} frames/s "
        f"(run seconds {', '.join(f'{x:.4f}' for x in dev_times)})")
    # ICP ran on the descriptor hits (fitness finite), and the gate is why
    # no loop closes on these independent random scans
    fits = fits.cpu().numpy()
    icp = fits[np.isfinite(fits)]
    if icp.size == 0 or int(oks.sum()) != loops:
        raise AssertionError(f"bench chunk: {icp.size} ICP lanes, {int(oks.sum())} vs {loops} loops")
    log(f"[5] ICP lanes {icp.size} of {n} frames, fitness {icp.min():.4f}-{icp.max():.4f} m^2 "
        f"against the gate {cfg.loop.history_fitness_score}")
    profile_replay(torch, M, cfg, (0, pose_b, xyz, mask, st0))
    return {"frames_per_s": fps, "launches": launches}


def profile_block(torch, tag, what, fn, table_name) -> None:
    """Run ``fn`` once under torch.profiler, the device's activity only
    (the host's op tree would multiply the events, whose averaging costs
    the host ~0.1 ms each): log the device's busy share, its top kernels
    and the seconds the averaging took; the whole table goes to
    chiprun_out/."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    # the device's own rows (kernels, memcpy, memset), not the runtime
    # calls that launched them
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in on_device) / 1e3
    n_launch = sum(e.count for e in on_device)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", table_name), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=60))
    log(f"{tag} profile of {what}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), {n_launch} device operations, under the profiler "
        f"(its averaging {time.perf_counter() - t:.1f} s)")
    for e in sorted(on_device, key=dev_us, reverse=True)[:8]:
        log(f"{tag}   {dev_us(e) / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}")


def profile_replay(torch, M, cfg, args) -> None:
    """One more card-resident chunk under torch.profiler (as
    ``profile_block``; the table goes to chiprun_out/profile_replay.txt)."""
    state = M.make_state(cfg, torch.device("cuda"))
    profile_block(torch, "[5]", "one card-resident replay chunk",
                  lambda: M._replay_batches(state, *args, cfg), "profile_replay.txt")


def phase_cross_device(torch) -> None:
    T, scans = revisit_world(64, 16384)
    world = (T.astype(np.float32), scans)
    runs = {device: revisit_replay(torch, revisit_cfg(), device, world)
            for device in ("cpu", "cuda")}
    (mc, oc, tc), (mg, og, tg) = runs["cpu"], runs["cuda"]
    ok_c = [x is not None for x in oc["loops"]]
    ok_g = [x is not None for x in og["loops"]]
    if ok_c != ok_g:
        raise AssertionError(f"loop decisions differ: cpu {ok_c} cuda {ok_g}")
    idx_c = [x["matched_index"] for x in oc["loops"] if x]
    idx_g = [x["matched_index"] for x in og["loops"] if x]
    if idx_c != idx_g:
        raise AssertionError(f"matched indices differ: cpu {idx_c} cuda {idx_g}")
    nq = int(mc.state.loop_queue.count)
    if nq == 0:
        raise AssertionError("the revisit workload closed no loop")
    qc = {k: v.cpu().numpy() for k, v in mc.state.loop_queue._asdict().items()}
    qg = {k: v.cpu().numpy() for k, v in mg.state.loop_queue._asdict().items()}
    if not all(np.array_equal(qc[k][:nq], qg[k][:nq]) for k in ("i", "j")):
        raise AssertionError("loop-queue endpoints differ between cpu and cuda")
    # stated tolerances: the two devices sum in other orders (cuBLAS vs CPU
    # BLAS, SVD libraries), so ICP converges to the same pose within its
    # tol-scale motion and the fitness within a relative 1e-3
    dz = float(np.abs(qc["z_t"][:nq] - qg["z_t"][:nq]).max())
    fit_c = np.array([x["fitness"] for x in oc["loops"] if x])
    fit_g = np.array([x["fitness"] for x in og["loops"] if x])
    dfit = float(np.max(np.abs(fit_c - fit_g) / fit_c))
    dopt = float(np.abs(mc.state.opt_t.numpy() - mg.state.opt_t.cpu().numpy()).max())
    if dz > 5e-3 or dfit > 1e-3 or dopt > 1e-3:
        raise AssertionError(f"cpu/cuda disagree: z_t {dz}, fitness rel {dfit}, opt_t {dopt}")
    log(f"[6] revisit 64 frames x 16384 pts: {nq} loops, decisions equal on cpu ({tc:.1f} s) and "
        f"cuda ({tg:.2f} s); max |dz_t| {dz:.2e} m, max rel dfitness {dfit:.2e}, "
        f"max |dopt_t| {dopt:.2e}")


def k4_inputs(torch, nq, nt, P, seed):
    """Queries are noisy copies of target points; every 4th target is
    duplicated at the next index (identical points: the lower index must
    win); a quarter of the queries sit on an integer grid at unit distance
    from two distinct targets (equidistant distinct points); ~5% of the
    targets are invalid pads at 1e6. Rows 4.. of the payload are random
    (normals and the like at P = 8)."""
    rng = np.random.RandomState(seed)
    t = rng.uniform(-40, 40, (nt, 3)).astype(np.float32)
    valid = rng.rand(nt) > 0.05
    q = (t[rng.randint(0, nt, nq)] + rng.normal(0, 0.3, (nq, 3))).astype(np.float32)
    t[1::4] = t[0::4][: len(t[1::4])]
    valid[1::4] = valid[0::4][: len(valid[1::4])]
    n_grid = min(nq // 4, nt // 8)
    c = rng.randint(-9, 9, (n_grid, 3)).astype(np.float32) * 4.0
    q[:n_grid] = c
    hi = nt - 2 * n_grid
    t[hi : hi + n_grid] = c - np.float32([1, 0, 0])
    t[hi + n_grid :] = c + np.float32([0, 1, 0])
    valid[hi:] = True
    t = np.where(valid[:, None], t, 1e6).astype(np.float32)
    extra = rng.normal(0, 1, (P - 3, nt)).astype(np.float32)
    extra[0] = valid
    payload = np.ascontiguousarray(np.concatenate([t.T, extra], axis=0))
    dev = torch.device("cuda")
    return torch.from_numpy(q).to(dev), torch.from_numpy(payload).to(dev), n_grid


def phase_k4(torch, kernels) -> dict:
    res = {}
    for nq, nt, P, label in ((1024, 16384, 4, "full"), (256, 4096, 4, "coarse"),
                             (1024, 16384, 8, "full_p8")):
        q, payload, n_grid = k4_inputs(torch, nq, nt, P, seed=nq + P)
        d, sel = kernels.nn_select(q, payload)
        d_p, sel_p = kernels.nn_select_plain(q, payload)
        torch.cuda.synchronize()
        if not torch.equal(d, d_p):
            raise AssertionError(f"K4 {label}: d2 differs from the plain version in "
                                 f"{(d != d_p).sum().item()} places")
        if not torch.equal(sel, sel_p):
            raise AssertionError(f"K4 {label}: selection differs in {(sel != sel_p).sum().item()} places")
        on_grid = d[:n_grid] == 1.0
        if int(on_grid.sum()) < 4 or not torch.equal(
            sel[0, :n_grid][on_grid], q[:n_grid, 0][on_grid] - 1.0
        ):
            raise AssertionError(f"K4 {label}: the planted equidistant ties did not take the lower index")
        call_ms = time_cuda(torch, lambda: kernels.nn_select(q, payload), reps=50)
        ms = time_graph(torch, lambda: kernels.nn_select(q, payload), reps=50)
        plain_ms = time_graph(torch, lambda: kernels.nn_select_plain(q, payload), reps=10)
        bound_ms, bound_by = bound(4 * (nq * 3 + P * nt + nq + P * nq), 9 * nq * nt)
        log(f"[7] K4 {label} {nq}x{nt} P={P}: d2 bit-equal, selection equal "
            f"({int(on_grid.sum())} planted equidistant ties), kernel {ms:.4f} ms "
            f"(eager call {call_ms:.4f} ms), plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by})")
        log(f"[7]   K4 {label} geometry: "
            f"{split_geometry(torch, kernels.k4_geometry(nq, nt), 1, 1)}; "
            f"{versus_row('K4 ' + label, ms, bound_ms)}")
        res[label] = {"max_abs_err": float((sel - sel_p).abs().max().item()), "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}
    return res


def phase_live_demo(torch, kernels) -> dict:
    """Phase 8: the runner's synthetic demo on the card with its defaults,
    then DEMO_CROSS_FRAMES frames on the CPU and on the card. Returns the
    kernel launch counts of the demo run."""
    import contextlib
    import io

    from scl_slam_tpu_torch import run as R
    from scl_slam_tpu_torch.io import trajectory as tio
    from scl_slam_tpu_torch.runtime import mapper as M

    out_dir = os.path.join(ROOT, "chiprun_out", "run_demo")
    buf = io.StringIO()
    kernels.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        rc = R.main(["--dataset", "synthetic", "--output", out_dir])
    launches = dict(kernels.LAUNCHES)
    report = json.loads(buf.getvalue().strip().splitlines()[-1])
    log(f"[8] run --dataset synthetic (defaults) -> {json.dumps(report)}")
    log(f"[8] launches in the demo run {launches}")
    if rc != 0 or report["loops_closed"] < 1:
        raise AssertionError(f"the demo closed no loop (rc {rc})")
    if not report["ate_rmse_m"] < report["ate_rmse_odom_only_m"]:
        raise AssertionError("the demo's optimized ATE is not below odometry-only")
    if launches["nn_select"] < 1 or launches["max_image"] < report["keyframes"]:
        raise AssertionError(f"the live path did not go through K4 and K2: {launches}")

    n, get_scan, get_odom, gt_of = R.synthetic_sequence(DEMO_CROSS_FRAMES, 0, 0.05)
    runs = {}
    for device in ("cpu", "cuda"):
        m = M.Mapper(R.demo_config(0.05), device)
        t = time.perf_counter()
        kfs, loops = R.run_live(m, n, get_scan, get_odom)
        if device == "cuda":
            torch.cuda.synchronize()
        runs[device] = (kfs, loops, m.trajectory(), time.perf_counter() - t)
    (kc, lc, tc, sc), (kg, lg, tg, sg) = runs["cpu"], runs["cuda"]
    if kc != kg:
        raise AssertionError("cpu and cuda took different keyframes")
    dec_c = [(k, x["matched_index"]) for k, x in lc]
    dec_g = [(k, x["matched_index"]) for k, x in lg]
    if dec_c != dec_g:
        raise AssertionError(f"loop decisions differ: cpu {dec_c} cuda {dec_g}")
    # stated tolerances: the devices sum in other orders (BLAS, SVD, and
    # atomics in index_add_, which also vary from run to run on the card),
    # so each solve ends a few mm apart, the next ICPs start from submaps
    # that far apart and stop within their tol-scale motion (fitness
    # relative 5e-2), and the weak prior leaves a near-gauge freedom, so
    # the trajectories are compared after a rigid alignment (2e-2 m; ATE
    # 5e-3 m). Measured: 8.4e-3, 3.5e-3 m and 1e-4 m (PERF.md, section 6)
    fit_c = np.array([x["fitness"] for _, x in lc])
    fit_g = np.array([x["fitness"] for _, x in lg])
    dfit = float(np.max(np.abs(fit_c - fit_g) / fit_c)) if len(fit_c) else 0.0
    _, Ra, ta = tio.umeyama_align(tg[:, :3, 3], tc[:, :3, 3])
    dtraj = float(np.abs((Ra @ tg[:, :3, 3].T).T + ta - tc[:, :3, 3]).max())
    gt = np.stack([gt_of(k) for k in kc])
    ate_c, ate_g = tio.ate_rmse(tc, gt), tio.ate_rmse(tg, gt)
    if not dec_c or dfit > 5e-2 or dtraj > 2e-2 or abs(ate_c - ate_g) > 5e-3:
        raise AssertionError(f"cpu/cuda disagree: {len(dec_c)} loops, fitness rel {dfit}, "
                             f"aligned trajectory {dtraj} m, ATE {ate_c} vs {ate_g}")
    log(f"[8] {n} frames: {len(dec_c)} loops, decisions and matched "
        f"keyframes equal on cpu ({sc:.1f} s) and cuda ({sg:.2f} s); max rel dfitness "
        f"{dfit:.2e}, aligned trajectories within {dtraj:.2e} m, ATE {ate_c:.4f} (cpu) vs "
        f"{ate_g:.4f} (cuda) m")
    return launches


def dense_world(seed: int = 7):
    """A denser ``SyntheticWorld`` whose scans hold more than 131,072 points
    within 60 m (the HDL-64 capacity of configs/kitti_velodyne.yaml)."""
    from scl_slam_tpu_torch.io import kitti as kio

    return kio.SyntheticWorld(
        seed=seed, extent=100.0, n_clusters=150, pts_per_cluster=4000, max_range=60.0
    )


def phase_live_kitti(torch, kernels) -> dict:
    """Phase 9: per-keyframe latency of the live path at the KITTI widths,
    then one ``Mapper.optimize()`` at the full capacity. Returns the
    latency's p50 and p99, the solve's ms and the drive's launch counts."""
    from scl_slam_tpu_torch.geometry import se3
    from scl_slam_tpu_torch.io import kitti as kio
    from scl_slam_tpu_torch.runtime import mapper as M

    cfg = kitti_velodyne_cfg()
    n, warm = 260, 10
    t0 = time.perf_counter()
    world = dense_world()
    gt = kio.loop_trajectory(n_frames=n, radius=45.0, laps=2.0)
    scans = [world.scan_at(gt[k], max_points=cfg.keyframe.raw_points_capacity, seed=k)
             for k in range(n)]
    sizes = np.array([len(x) for x in scans])
    log(f"[9] {n} scans of {sizes.min()}-{sizes.max()} points "
        f"(median {int(np.median(sizes))}) generated in {time.perf_counter() - t0:.1f} s")

    # random-walk odometry drift at the configuration's own odometry
    # sigmas (1e-3 rad, 1e-2 m per keyframe), so that the solve has work
    rng = np.random.RandomState(11)
    odom = [gt[0]]
    for k in range(1, n):
        w = rng.normal(0, 1e-3, 3)
        th = np.linalg.norm(w)
        K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
        drift = np.eye(4)
        drift[:3, :3] = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
        drift[:3, 3] = rng.normal(0, 1e-2, 3)
        odom.append(odom[-1] @ np.linalg.inv(gt[k - 1]) @ gt[k] @ drift)

    m = M.Mapper(cfg)
    kernels.reset_launch_counts()
    lat = []

    def step(k):
        T = odom[k].astype(np.float32)
        if m.add_frame(se3.Pose(T[:3, :3], T[:3, 3]), scans[k], stamp=0.1 * k) is None:
            raise AssertionError(f"frame {k} was not a keyframe")
        m.spin_once()

    n_prof = 10  # the last keyframes run under the profiler, untimed
    for k in range(n - n_prof):
        t = time.perf_counter()
        step(k)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
    attempts0 = m.icp_attempts
    profile_block(torch, "[9]", f"{n_prof} keyframes of the KITTI-width drive",
                  lambda: [step(k) for k in range(n - n_prof, n)], "profile_live.txt")
    log(f"[9]   (ICP attempts among them: {m.icp_attempts - attempts0})")
    launches = dict(kernels.LAUNCHES)
    lat = np.array(lat[warm:])
    loops = int(m.state.graph.num_edges) - (n - 1) + int(m.state.loop_queue.count)
    if launches["nn_select"] < 1 or launches["max_image"] < n or m.icp_attempts < 1:
        raise AssertionError(f"the KITTI-width live run launched no K4, or K2 less than once "
                             f"a keyframe: {launches}")
    log(f"[9] add_frame + spin_once per keyframe at the kitti_velodyne widths, "
        f"{len(lat)} keyframes after {warm} of warm-up (unprofiled): p50 {np.percentile(lat, 50):.2f} ms, "
        f"p99 {np.percentile(lat, 99):.2f} ms, max {lat.max():.2f} ms; "
        f"ICP attempts {m.icp_attempts}, loops accepted {loops} (fitness gate "
        f"{cfg.loop.history_fitness_score}); launches {launches}; K4 per attempt "
        f"{launches['nn_select'] / m.icp_attempts:.1f}")

    # 32 loop factors from ground truth, then one drain + solve
    m.optimize()  # drains whatever the drive left queued
    edges = int(m.state.graph.num_edges)

    def queue_gt_loops(first):
        pairs = [(a, a + n // 2) for a in range(first, first + 3 * 32, 3)]
        q = m.state.loop_queue
        dev = q.i.device
        Z = np.stack([np.linalg.inv(gt[a]) @ gt[b] for a, b in pairs]).astype(np.float32)
        q.i[:32] = M.encode_kf(0, torch.tensor([a for a, _ in pairs], dtype=torch.int32)).to(dev)
        q.j[:32] = M.encode_kf(0, torch.tensor([b for _, b in pairs], dtype=torch.int32)).to(dev)
        q.z_R[:32] = torch.from_numpy(Z[:, :3, :3]).to(dev)
        q.z_t[:32] = torch.from_numpy(Z[:, :3, 3]).to(dev)
        q.noise[:32] = 0.1
        q.count.fill_(32)
        torch.cuda.synchronize()

    queue_gt_loops(4)
    t = time.perf_counter()
    chi2 = m.optimize()
    torch.cuda.synchronize()
    solve_ms = (time.perf_counter() - t) * 1e3
    g = m.state.graph
    if not np.isfinite(chi2).all() or int(g.num_edges) != edges + 32:
        raise AssertionError(f"the solve failed: chi2 {chi2}, edges {int(g.num_edges)}")
    interval = cfg.optimizer.mapping_process_interval
    log(f"[9] Mapper.optimize() with 32 ground-truth loop factors at {cfg.keyframe.max_keyframes} "
        f"poses / {cfg.optimizer.edge_capacity} edges (two GN solves of {cfg.optimizer.gn_iters} x "
        f"{cfg.optimizer.cg_iters} PCG): {solve_ms:.1f} ms, chi2 {chi2[0]:.4g} -> {chi2[-1]:.4g}; "
        f"{'fits' if solve_ms < interval * 1e3 else 'does not fit'} in the "
        f"{interval} s mapping_process_interval")
    queue_gt_loops(5)
    profile_block(torch, "[9]", "one more Mapper.optimize() with 32 loop factors",
                  m.optimize, "profile_solve.txt")
    return {"p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
            "solve_ms": solve_ms, "launches": launches,
            # the session and its drive, which phase 28 goes on from
            "drive": {"mapper": m, "cfg": cfg, "world": world, "odom": odom}}


def k3_inputs(torch, nq, nt, seed):
    """Queries are noisy copies of target points; every 4th target is
    duplicated at the next index (the lower index must win); a quarter of
    the queries sit on an integer grid at unit distance from two distinct
    targets; ~5% of the targets are pads at 1e6."""
    rng = np.random.RandomState(seed)
    t = rng.uniform(-40, 40, (nt, 3)).astype(np.float32)
    q = (t[rng.randint(0, nt, nq)] + rng.normal(0, 0.3, (nq, 3))).astype(np.float32)
    t[1::4] = t[0::4][: len(t[1::4])]
    n_grid = min(nq // 4, nt // 8)
    c = rng.randint(-9, 9, (n_grid, 3)).astype(np.float32) * 4.0
    q[:n_grid] = c
    hi = nt - 2 * n_grid
    t[hi : hi + n_grid] = c - np.float32([1, 0, 0])
    t[hi + n_grid :] = c + np.float32([0, 1, 0])
    pad = rng.rand(nt) < 0.05
    pad[hi:] = False
    t[pad] = 1e6
    dev = torch.device("cuda")
    return torch.from_numpy(q).to(dev), torch.from_numpy(t).to(dev), n_grid, hi


def phase_k3(torch, kernels) -> dict:
    res = {}
    for nq, nt, label in ((4096, 8192, "full"), (256, 4096, "small"), (4096, 16384, "kitti")):
        q, t, n_grid, hi = k3_inputs(torch, nq, nt, seed=nq + nt)
        d, idx = kernels.nearest_neighbors(q, t)
        d_p, idx_p = kernels.nearest_neighbors_plain(q, t)
        torch.cuda.synchronize()
        if not torch.equal(d, d_p):
            raise AssertionError(f"K3 {label}: d2 differs from the plain version in "
                                 f"{(d != d_p).sum().item()} places")
        if not torch.equal(idx, idx_p):
            raise AssertionError(f"K3 {label}: index differs in {(idx != idx_p).sum().item()} places")
        on_grid = d[:n_grid] == 1.0
        if int(on_grid.sum()) < 4 or not bool((idx[:n_grid][on_grid] < hi + n_grid).all()):
            raise AssertionError(f"K3 {label}: the planted equidistant ties did not take the lower index")
        if bool((t[idx.long(), 0] == 1e6).any()):
            raise AssertionError(f"K3 {label}: a pad target was nearest")
        call_ms = time_cuda(torch, lambda: kernels.nearest_neighbors(q, t), reps=50)
        ms = time_graph(torch, lambda: kernels.nearest_neighbors(q, t), reps=50)
        plain_ms = time_graph(torch, lambda: kernels.nearest_neighbors_plain(q, t), reps=5)
        bound_ms, bound_by = bound(4 * (nq * 3 + nt * 3 + nq + nq), 9 * nq * nt)
        log(f"[10] K3 {label} {nq}x{nt}: d2 bit-equal, index equal ({int(on_grid.sum())} planted "
            f"equidistant ties), kernel {ms:.4f} ms (eager call {call_ms:.4f} ms), "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        log(f"[10]   K3 {label} geometry: "
            f"{split_geometry(torch, kernels.k4_geometry(nq, nt), 1, 1)}; "
            f"{versus_row('K3 ' + label, ms, bound_ms)}")
        res[label] = {"max_abs_err": float((d - d_p).abs().max().item()), "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}
    return res


def run_multi_report(argv) -> tuple[int, dict]:
    """``run_multi.main(argv)``; returns (exit code, its JSON report)."""
    import contextlib
    import io

    from scl_slam_tpu_torch import run_multi

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run_multi.main(argv)
    lines = buf.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 and lines else {})


def patched(obj, name, wrap):
    """Replace ``obj.name`` by ``wrap(original)``; returns the undo."""
    orig = getattr(obj, name)
    setattr(obj, name, wrap(orig))
    return lambda: setattr(obj, name, orig)


def timing(torch, acc, key):
    """A wrapper maker that records each call's milliseconds under ``key``,
    a synchronize before and after (so each layer is timed alone)."""
    def wrap(fn):
        def timed(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            acc.setdefault(key, []).append((time.perf_counter() - t) * 1e3)
            return out
        return timed
    return wrap


def reduced_multi_cfg(r: int, kind: str = "scan_context"):
    """The reduced two-robot configuration (tests/test_torch_inter.py's
    session: tests/test_multi_robot.py's widths) under the descriptor family
    ``kind``."""
    from scl_slam_tpu_torch.config import (
        DescriptorType, KeyframeConfig, LidarIrisParams, LoopConfig, OptimizerConfig,
        ScanContextParams, SlamConfig,
    )

    return SlamConfig(
        number_of_robots=2, robot_id=r, robot_name=chr(ord("a") + r),
        descriptor_type=DescriptorType(kind),
        keyframe=KeyframeConfig(max_keyframes=64, points_per_keyframe=2048,
                                raw_points_capacity=4096, distance_threshold=2.0,
                                descript_leaf_size=0.3),
        loop=LoopConfig(near_keyframes=4, submap_capacity=8192, icp_iterations=20,
                        history_fitness_score=8.0, ransac_inlier_ratio=0.3,
                        ransac_outlier_threshold=1.0),
        optimizer=OptimizerConfig(edge_capacity=512, gn_iters=6, cg_iters=48,
                                  odometry_sigmas=(0.005,) * 3 + (0.05,) * 3,
                                  loop_noise_scale=0.05),
        scan_context=ScanContextParams(exclude_recent=10, num_candidates=6),
        lidar_iris=LidarIrisParams(exclude_recent=10, num_candidates=6),
    )


def reduced_multi_session(torch, device: str, kind: str = "scan_context"):
    """Two robots over the in-process bus: robot a at frames 16-39 of a
    35 m circle with ground-truth odometry, robot b at 32-47 drifting 5 cm
    and 1 mrad a frame, under the descriptor family ``kind``. Returns
    (retrieval hits, verified loops, robot a's view of both trajectories,
    seconds)."""
    from scl_slam_tpu_torch.geometry import se3
    from scl_slam_tpu_torch.io import kitti as kio
    from scl_slam_tpu_torch.runtime import mapper as M
    from scl_slam_tpu_torch.runtime.transport import LocalBus

    world = kio.SyntheticWorld(seed=5, extent=100.0, n_clusters=70, pts_per_cluster=800)
    gt = kio.loop_trajectory(n_frames=80, radius=35.0, revisit=False)
    split = [list(range(16, 40)), list(range(32, 48))]
    drift = se3.to_matrix(se3.exp(torch.tensor([0, 0, 0.001, 0.05, 0, 0]))).numpy()
    odom = {0: {k: gt[k] for k in split[0]}, 1: {split[1][0]: gt[split[1][0]]}}
    for k in split[1][1:]:
        odom[1][k] = odom[1][k - 1] @ np.linalg.inv(gt[k - 1]) @ gt[k] @ drift
    hits = []

    def recording(fn):
        def detect(state, robot, cfg):
            out = fn(state, robot, cfg)
            if bool(out[0]):
                hits.append((robot, int(out[1].robot), int(out[1].index)))
            return out
        return detect

    undo = patched(M, "_detect_inter", recording)
    try:
        bus = LocalBus()
        ms = [M.Mapper(reduced_multi_cfg(r, kind), device) for r in range(2)]
        for m in ms:
            m.attach_bus(bus)
        inter = []
        t = time.perf_counter()
        for step in range(max(len(s) for s in split)):
            for r, frames in enumerate(split):
                if step >= len(frames):
                    continue
                k = frames[step]
                T = odom[r][k].astype(np.float32)
                wire = ms[r].add_frame(se3.Pose(T[:3, :3], T[:3, 3]),
                                       world.scan_at(gt[k], max_points=4096, seed=k), stamp=0.1 * k)
                if wire is not None:
                    ms[r].broadcast_latest(wire)
                    x = ms[r].spin_once(now=0.1 * k).get("inter_loop")
                    if x:
                        inter.append((r, k, x["robot"], x["matched_index"], x["inlier_ratio"]))
        for m in ms:
            m.optimize()
        if device == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t
    finally:
        undo()
    return hits, inter, [ms[0].trajectory(robot=r) for r in range(2)], secs


def phase_multi(torch, kernels) -> dict:
    """Phase 11; returns the kernel launch counts of the default two-robot
    run."""
    from scl_slam_tpu_torch.io import trajectory as tio
    from scl_slam_tpu_torch.runtime import mapper as M

    from scl_slam_tpu_torch.runtime.transport import LocalBus

    out_dir = os.path.join(ROOT, "chiprun_out", "run_multi")
    # every inter-robot layer timed alone (a synchronize before and after)
    acc: dict = {}
    last = []  # the last (mapper, request) served, replayed under the profiler

    def timed_serve(fn):
        timed = timing(torch, acc, "serve_verification")(fn)

        def serve(self, req):
            last[:] = [self, req]
            return timed(self, req)
        return serve

    undos = [patched(M, name, timing(torch, acc, name)) for name in (
        "_ingest_peer", "_detect_inter", "_verify_inputs", "_verify_align", "_queue_loop",
        "_drain_queue_and_optimize")]
    undos += [patched(M.Mapper, name, timing(torch, acc, name)) for name in (
        "add_frame", "broadcast_latest")]
    undos.append(patched(M.Mapper, "serve_verification", timed_serve))
    undos.append(patched(LocalBus, "verify", timing(torch, acc, "LocalBus.verify")))
    # K3's own wrapper is timed from the outside; its count moves only in
    # kernels.nearest_neighbors itself
    undos.append(patched(kernels, "nearest_neighbors", timing(torch, acc, "K3 nearest_neighbors")))
    try:
        kernels.reset_launch_counts()
        rc, rep = run_multi_report(["--robots", "2", "--output", out_dir])
        launches = dict(kernels.LAUNCHES)
    finally:
        for u in reversed(undos):
            u()
    serve_ms = acc.get("serve_verification", [])
    log(f"[11] run_multi --robots 2 (defaults) -> {json.dumps(rep)}")
    log(f"[11] launches {launches}; {len(serve_ms)} verifications served")
    if rc != 0 or rep["inter_loops"] < 1:
        raise AssertionError(f"the two-robot run verified no inter-robot loop (rc {rc})")
    if launches["nearest_neighbors"] != len(serve_ms) or not serve_ms:
        raise AssertionError(f"K3 launches {launches['nearest_neighbors']} != verifications {len(serve_ms)}")
    if not all(np.isfinite(v) and v < 1.0 for v in rep["ate_rmse_m"].values()):
        raise AssertionError(f"joint ATE out of bounds: {rep['ate_rmse_m']}")
    v = np.array(serve_ms)
    log(f"[11] inter {rep['inter_loops']}, intra {rep['intra_loops']} loops; wall {rep['wall_s']} s "
        f"(with the layers' synchronizes); per verification (serve side) p50 "
        f"{np.percentile(v, 50):.2f} ms, p99 {np.percentile(v, 99):.2f} ms, max {v.max():.2f} ms; "
        f"joint ATE {rep['ate_rmse_m']} m")
    log("[11] layers of the two-robot run, each timed alone (inclusive ms: calls, total, p50, p99):")
    for name, vals in sorted(acc.items(), key=lambda kv: -sum(kv[1])):
        a = np.array(vals)
        log(f"[11]   {name:28s} {len(a):5d} calls  {a.sum():9.1f} ms  p50 {np.percentile(a, 50):7.3f}  "
            f"p99 {np.percentile(a, 99):7.3f}")

    mapper, req = last
    profile_block(torch, "[11]", "10 verification RPCs of the run (serve side) replayed",
                  lambda: [mapper.serve_verification(req) for _ in range(10)], "profile_verify.txt")
    del mapper, req, last[:]

    inter2 = rep["inter_loops"]
    rc3, rep3 = run_multi_report(["--robots", "3", "--frames", str(MULTI3_FRAMES),
                                  "--output", out_dir + "3"])
    log(f"[11] run_multi --robots 3 --frames {MULTI3_FRAMES} -> {json.dumps(rep3)}")
    if rc3 != 0 or rep3["inter_loops"] < 1 or len(rep3["ate_rmse_m"]) != 3:
        raise AssertionError(f"the three-robot run failed (rc {rc3})")

    runs = {d: reduced_multi_session(torch, d) for d in ("cpu", "cuda")}
    (hc, ic, tc, sc), (hg, ig, tg, sg) = runs["cpu"], runs["cuda"]
    if hc != hg:
        raise AssertionError(f"retrieval hits differ: cpu {hc} cuda {hg}")
    if [x[:4] for x in ic] != [x[:4] for x in ig] or not ic:
        raise AssertionError(f"inter-loop decisions differ: cpu {ic} cuda {ig}")
    # stated tolerances: the same RANSAC draws on both devices, so the
    # inlier ratios agree to a few inliers (the devices' SVD and sums
    # differ in the last bits: 5e-3); the trajectories after a rigid
    # alignment to 2e-2 m (phase 8's, for the same reasons)
    dratio = float(np.max(np.abs(np.array([x[4] for x in ic]) - np.array([x[4] for x in ig]))))
    dtraj = 0.0
    for a, b in zip(tc, tg):
        _, Ra, ta = tio.umeyama_align(b[:, :3, 3], a[:, :3, 3])
        dtraj = max(dtraj, float(np.abs((Ra @ b[:, :3, 3].T).T + ta - a[:, :3, 3]).max()))
    if dratio > 5e-3 or dtraj > 2e-2:
        raise AssertionError(f"cpu/cuda disagree: inlier ratio {dratio}, aligned trajectory {dtraj} m")
    log(f"[11] reduced two-robot session (40 frames): {len(hc)} retrieval hits and {len(ic)} verified "
        f"inter loops, equal on cpu ({sc:.1f} s) and cuda ({sg:.2f} s); max |d inlier ratio| "
        f"{dratio:.2e}, aligned trajectories within {dtraj:.2e} m")
    return launches, inter2


def ransac_inputs(torch, B, H, N, seed, thr=0.25):
    """K6 inputs on the card: each lane's matched points are its source
    points under a random pose plus noise, its hypotheses that pose
    perturbed; ~10% of the points not good, lane 1 without a good point.
    Lane 0's source is an integer grid and its hypothesis 0 the identity: a
    quarter of its matched points sit exactly ``thr`` away (res2 == thr2:
    out), a quarter just inside."""
    rng = np.random.RandomState(seed)

    def rot(w):
        th = np.linalg.norm(w)
        k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
        return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k

    src = rng.uniform(-30, 30, (B, N, 3)).astype(np.float32)
    src[0] = np.round(src[0])
    R = np.empty((B, H, 3, 3), np.float32)
    t = np.empty((B, H, 3), np.float32)
    matched = np.empty_like(src)
    for b in range(B):
        Rb, tb = rot(rng.normal(0, 0.3, 3)), rng.uniform(-5, 5, 3)
        matched[b] = src[b] @ Rb.T + tb + rng.normal(0, 0.2, (N, 3))
        R[b] = [rot(rng.normal(0, 0.01, 3)) @ Rb for _ in range(H)]
        t[b] = tb + rng.normal(0, 0.1, (H, 3))
    R[0, 0], t[0, 0] = np.eye(3), 0.0
    q = N // 4
    matched[0, :q] = src[0, :q] + np.float32([thr, 0, 0])
    matched[0, q : 2 * q] = src[0, q : 2 * q] + np.float32([thr * (1 - 2.0**-10), 0, 0])
    good = rng.rand(B, N) > 0.1
    good[1] = False
    dev = torch.device("cuda")
    return [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for x in (src, matched.astype(np.float32), good, R, t)], thr * thr


# K6 at the shapes the main paths launch it: (label, B, H, N, path)
K6_SHAPES = (
    ("fleet_run", 2, 256, 1024, "fleet-run, 35 launches"),
    ("fleet", 16, 256, 1024, "fleet-bench, 4 launches"),
    ("keyframe", 16, 256, 4096, "a full keyframe"),
    ("ragged", 3, 37, 1000, "ragged"),
)


def k6_case(torch, kernels, args, thr2, full: bool = True) -> dict:
    """K6 on ``args`` against its plain version (counts equal, the lane
    without a good point at 0, the points planted on the threshold out; or
    raise), and its time by graph replays, alone and 20 to a graph; with
    ``full`` also the eager call's and the plain version's."""
    counts = kernels.ransac_counts_batched(*args, thr2)
    ref = kernels.ransac_counts_batched_plain(*args, thr2)
    torch.cuda.synchronize()
    if not torch.equal(counts, ref):
        raise AssertionError(f"K6: counts differ from the plain version in "
                             f"{(counts != ref).sum().item()} places")
    if not (counts[1] == 0).all():
        raise AssertionError("K6: the lane without a good point has inliers")
    q = args[0].shape[1] // 4
    half = kernels.ransac_counts_batched(
        *(a[:1, : 2 * q].contiguous() for a in args[:3]),
        args[3][:1, :1].contiguous(), args[4][:1, :1].contiguous(), thr2,
    )
    if int(half[0, 0]) != int(args[2][0, q : 2 * q].sum()):
        raise AssertionError("K6: the points planted on the threshold were miscounted")
    res = {"max_abs_err": float((counts - ref).abs().max().item()),
           "ms": time_graph(torch, lambda: kernels.ransac_counts_batched(*args, thr2), reps=50),
           "many_ms": time_graph_many(torch, lambda: kernels.ransac_counts_batched(*args, thr2))}
    if full:
        res["call_ms"] = time_cuda(torch, lambda: kernels.ransac_counts_batched(*args, thr2),
                                   reps=50)
        res["plain_ms"] = time_graph(
            torch, lambda: kernels.ransac_counts_batched_plain(*args, thr2), reps=10)
    return res


def phase_k6(torch, kernels) -> dict:
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res = {}
    for label, B, H, N, path in K6_SHAPES:
        args, thr2 = ransac_inputs(torch, B, H, N, seed=B + H + N)
        r = k6_case(torch, kernels, args, thr2)
        # 27 FP32 operations per (hypothesis, point): 18 for the transform,
        # 3 subtracts, 3 multiplies, 2 adds and the compare; bytes: the
        # points once, the poses once, the counts written once
        bound_ms, bound_by = bound(B * N * (12 + 12 + 1) + B * H * (36 + 12 + 4), 27 * B * H * N)
        r.update(bound_ms=bound_ms, bound_by=bound_by)
        g = kernels.k6_geometry(B, H, N)
        vec = kernels._vector_ok(N, args[:2], args[2:3])
        row = ROW_MS.get(f"K6 {label}")
        before = (f"row before the redesign {row:.4f} ms, now {row / r['ms']:.2f}x as fast"
                  if row else "no row before the redesign at this shape")
        log(f"[13] K6 {label} {B}x{H}x{N} ({path}): counts equal (the planted on-threshold "
            f"points out), kernel {r['ms']:.4f} ms (20 to a graph {r['many_ms']:.4f} ms, eager "
            f"call {r['call_ms']:.4f} ms), plain "
            f"{r['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
            f"{100 * bound_ms / r['ms']:.1f}% of the bound (issue ceiling 50%)")
        log(f"[13]   K6 {label} geometry: {B * g.groups * g.chunks} blocks "
            f"({B * g.groups * g.chunks / sms:.2f} per SM) of {g.threads} threads, "
            f"{kernels.K6_PTS} points a thread, {g.groups} groups of {g.hyps} hypotheses x "
            f"{g.chunks} chunks a lane ({'atomics into a zeroed output' if g.chunks > 1 else 'stores'}), "
            f"{'16-byte' if vec else 'scalar'} loads; {before}")
        res[label] = r
    return res


def fleet_bench_cfg():
    from scl_slam_tpu_torch.config import (
        KeyframeConfig, LoopConfig, OptimizerConfig, SlamConfig,
    )

    # bench.py:320-345 (bench_fleet, full size)
    return SlamConfig(
        number_of_robots=2,
        keyframe=KeyframeConfig(max_keyframes=2048, points_per_keyframe=4096,
                                raw_points_capacity=65536),
        loop=LoopConfig(near_keyframes=25, submap_capacity=8192, icp_iterations=20),
        optimizer=OptimizerConfig(edge_capacity=2048, gn_iters=4, cg_iters=32),
    )


class FleetBench:
    """bench.py's fleet workload (bench.py:346-414): one staged batch of 16
    scans (robots alternating) reused over 4 steps with shifted poses, on a
    fresh state per run."""

    B, n_steps = 16, 4

    def __init__(self, torch):
        self.torch = torch
        self.cfg = cfg = fleet_bench_cfg()
        B = self.B
        self.n_pts = n_pts = cfg.keyframe.raw_points_capacity
        self.dev = dev = torch.device("cuda")
        rng = np.random.RandomState(1)
        scans = []
        for k in range(B):
            theta = rng.uniform(-np.pi, np.pi, n_pts)
            r = rng.uniform(2, 75, n_pts)
            z = np.sin(theta * 3 + k * 0.1) * 2 + rng.normal(0, 0.4, n_pts) - 1.0
            scans.append(np.stack([r * np.cos(theta), r * np.sin(theta), z], -1).astype(np.float32))
        self.xs = torch.from_numpy(np.stack(scans)).to(dev)
        self.masks = torch.ones((B, n_pts), dtype=torch.bool, device=dev)
        self.robots = torch.tensor([k % 2 for k in range(B)], dtype=torch.int32, device=dev)
        self.pose_R = torch.eye(3, device=dev).expand(B, 3, 3).contiguous()
        self.pose_ts = [torch.tensor([[2.0 * (s * B + k), 4.0 * (k % 2), 0.0] for k in range(B)],
                                     device=dev) for s in range(self.n_steps)]
        self.stamps = torch.zeros((B,), device=dev)

    def step(self, state, s):
        from scl_slam_tpu_torch.runtime import fleet as F

        return F._fleet_step(state, 0, s, self.robots, self.pose_R, self.pose_ts[s], self.xs,
                             self.masks, self.stamps, self.cfg)

    def run(self, n_steps=None):
        """(state, per-step outputs, seconds ended by a synchronize)."""
        from scl_slam_tpu_torch.runtime import mapper as M

        state = M.make_state(self.cfg, self.dev)
        self.torch.cuda.synchronize()
        t = time.perf_counter()
        outs = []
        for s in range(self.n_steps if n_steps is None else n_steps):
            state, out = self.step(state, s)
            outs.append(out)
        self.torch.cuda.synchronize()
        return state, outs, time.perf_counter() - t

    def ransac_verdicts(self) -> list:
        """One run; per RANSAC call (active lanes, success flags, inlier
        counts)."""
        from scl_slam_tpu_torch.ops import registration as reg

        records = []

        def recording(fn):
            def ransac(*a, **k):
                res = fn(*a, **k)
                records.append((a[4].tolist(), res.success.tolist(), res.num_inliers.tolist()))
                return res
            return ransac

        undo = patched(reg, "ransac_align_batched", recording)
        try:
            self.run()
        finally:
            undo()
        return records


def phase_fleet_bench(torch, kernels) -> dict:
    """Phase 14: :class:`FleetBench`, timed."""
    from scl_slam_tpu_torch.ops import registration as reg

    bench = FleetBench(torch)
    cfg, B, n_steps, n_pts = bench.cfg, bench.B, bench.n_steps, bench.n_pts
    attempts = {"intra": 0, "inter": 0}

    def counting(name):
        def wrap(fn):
            def counted(*a, **k):
                attempts[name] += int(a[3].sum()) if name == "intra" else int(a[4].sum())
                return fn(*a, **k)
            return counted
        return wrap

    # the warm-up run counts launches and attempts; the counting wrappers
    # read the card, so the 5 timed runs go without them
    undos = [patched(reg, "icp_batched", counting("intra")),
             patched(reg, "ransac_align_batched", counting("inter"))]
    try:
        kernels.reset_launch_counts()
        state, outs, _ = bench.run()
        launches = dict(kernels.LAUNCHES)
    finally:
        for u in undos:
            u()
    times = [bench.run()[2] for _ in range(5)]
    fps = B * n_steps / float(np.median(times))
    ok_i = sum(int(o[0].sum()) for o in outs)
    ok_x = sum(int(o[3].sum()) for o in outs)
    n = B * n_steps
    K = cfg.keyframe.max_keyframes
    checks = {
        "counts": state.counts.tolist() == [n // 2, n // 2],
        "finite": bool(torch.isfinite(state.opt_t).all()),
        "indices": state.desc_db.index[: n // 2].tolist() == list(range(n // 2))
        and state.desc_db.index[K : K + n // 2].tolist() == list(range(n // 2)),
        "edges": int(state.graph.num_edges) == n - 2 and int(state.graph.num_priors) == 2,
        "queue": int(state.loop_queue.count) == ok_i + ok_x,
    }
    if not all(checks.values()):
        raise AssertionError(f"fleet bench state checks failed: {checks}")
    if launches["max_image"] < n_steps:
        raise AssertionError(f"the fleet bench did not go through K2: {launches}")
    log(f"[14] fleet bench {n_steps} x {B} keyframes (2 robots, {n_pts}-point scans, "
        f"{K} keyframes a robot), 5 runs: fleet_frames_per_s median {fps:.2f} "
        f"(run seconds {', '.join(f'{x:.4f}' for x in times)}); launches in the untimed counted run "
        f"{launches}; attempts intra {attempts['intra']}, inter {attempts['inter']}; loops "
        f"intra {ok_i}, inter {ok_x}; state checks ok")
    state, _, _ = bench.run(n_steps - 1)
    profile_block(torch, "[14]", "the last fleet step of a run",
                  lambda: bench.step(state, n_steps - 1), "profile_fleet.txt")
    return {"fleet_frames_per_s": fps, "launches": launches}


def phase_fleet_run(torch, kernels, decentralized_inter: int) -> dict:
    """Phase 15: ``run_multi --robots 2 --fleet`` at its defaults; returns
    its kernel launch counts."""
    out_dir = os.path.join(ROOT, "chiprun_out", "run_multi_fleet")
    kernels.reset_launch_counts()
    rc, rep = run_multi_report(["--robots", "2", "--fleet", "--output", out_dir])
    launches = dict(kernels.LAUNCHES)
    log(f"[15] run_multi --robots 2 --fleet (defaults) -> {json.dumps(rep)}")
    log(f"[15] launches {launches}")
    if rc != 0 or rep["inter_loops"] < 1 or launches["ransac_counts_batched"] < 1:
        raise AssertionError(f"the fleet run verified no inter-robot loop through K6 (rc {rc})")
    if rep["device"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"the fleet run did not run on the card: {rep['device']}")
    if not all(np.isfinite(v) and v < 1.0 for v in rep["ate_rmse_m"].values()):
        raise AssertionError(f"joint ATE out of bounds: {rep['ate_rmse_m']}")
    log(f"[15] inter loops: fleet {rep['inter_loops']}, decentralized (phase 11) "
        f"{decentralized_inter}; wall {rep['wall_s']} s; ATE {rep['ate_rmse_m']} m; "
        f"K6 launches {launches['ransac_counts_batched']}")
    return launches


def reduced_fleet_cfg(max_keyframes: int = 64):
    """tests/test_fleet.py::fleet_cfg."""
    from scl_slam_tpu_torch.config import (
        KeyframeConfig, LoopConfig, OptimizerConfig, ScanContextParams, SlamConfig,
    )

    return SlamConfig(
        number_of_robots=2, robot_id=0,
        keyframe=KeyframeConfig(max_keyframes=max_keyframes, points_per_keyframe=2048,
                                raw_points_capacity=4096, distance_threshold=2.0,
                                descript_leaf_size=0.3),
        loop=LoopConfig(near_keyframes=4, submap_capacity=8192, icp_iterations=20,
                        history_fitness_score=8.0, ransac_inlier_ratio=0.3,
                        ransac_outlier_threshold=1.0),
        optimizer=OptimizerConfig(edge_capacity=512, gn_iters=6, cg_iters=48,
                                  odometry_sigmas=(0.005,) * 3 + (0.05,) * 3,
                                  loop_noise_scale=0.05),
        scan_context=ScanContextParams(exclude_recent=10, num_candidates=6,
                                       distance_threshold=0.25),
    )


def reduced_fleet_run(torch, device: str):
    """tests/test_fleet.py::fleet_run in the port's code: two robots on
    overlapping arcs of a 32 m circle, robot b's odometry drifting 5 cm and
    1 mrad a frame. Returns (retrieval hits per step, events, counts,
    trajectories, seconds)."""
    from scl_slam_tpu_torch.geometry import se3
    from scl_slam_tpu_torch.io import kitti as kio
    from scl_slam_tpu_torch.ops import registration as reg
    from scl_slam_tpu_torch.runtime import FleetMapper

    world = kio.SyntheticWorld(seed=9, extent=100.0, n_clusters=70, pts_per_cluster=800)
    gt = kio.loop_trajectory(n_frames=64, radius=32.0, revisit=False)
    split = [list(range(0, 40)), list(range(28, 64))]
    drift = se3.to_matrix(se3.exp(torch.tensor([0, 0, 0.001, 0.05, 0, 0]))).numpy()
    odom = {split[1][0]: gt[split[1][0]]}
    for k in split[1][1:]:
        odom[k] = odom[k - 1] @ np.linalg.inv(gt[k - 1]) @ gt[k] @ drift
    hits = []

    def recording(fn):
        def ransac(*a, **k):
            hits.append(a[4].nonzero().flatten().tolist())
            return fn(*a, **k)
        return ransac

    undo = patched(reg, "ransac_align_batched", recording)
    try:
        fm = FleetMapper(reduced_fleet_cfg(), device)
        events = []
        t = time.perf_counter()
        for step in range(max(len(s) for s in split)):
            for rid, frames in enumerate(split):
                if step < len(frames):
                    k = frames[step]
                    T = (gt[k] if rid == 0 else odom[k]).astype(np.float32)
                    fm.add_robot_frame(rid, se3.Pose(T[:3, :3], T[:3, 3]),
                                       world.scan_at(gt[k], max_points=4096, seed=k), stamp=0.1 * k)
            events.extend(fm.step())
        fm.optimize()
        if device == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t
    finally:
        undo()
    return hits, events, fm.state.counts.tolist(), [fm.trajectory(robot=r) for r in range(2)], secs


def phase_reduced_fleet(torch) -> None:
    from scl_slam_tpu_torch.io import trajectory as tio

    runs = {d: reduced_fleet_run(torch, d) for d in ("cpu", "cuda")}
    (hc, ec, cc, tc, sc), (hg, eg, cg, tg, sg) = runs["cpu"], runs["cuda"]
    if hc != hg:
        raise AssertionError(f"retrieval hits differ: cpu {hc} cuda {hg}")
    if cc != cg or cc != [40, 36]:
        raise AssertionError(f"keyframes per robot block differ: cpu {cc} cuda {cg}")

    def decisions(evs):
        return [(b, e["robot"], "loop" in e,
                 (e["inter_loop"]["robot"], e["inter_loop"]["matched_index"]) if "inter_loop" in e else None)
                for b, e in enumerate(evs)]

    if decisions(ec) != decisions(eg):
        raise AssertionError("intra/inter decisions differ between cpu and cuda")
    inter_c = [e["inter_loop"]["inlier_ratio"] for e in ec if "inter_loop" in e]
    inter_g = [e["inter_loop"]["inlier_ratio"] for e in eg if "inter_loop" in e]
    if not inter_c:
        raise AssertionError("the reduced fleet verified no inter-robot loop")
    # stated tolerances: the same RANSAC draws on both devices (a counter
    # hash), so the inlier ratios agree to a few inliers (the devices' SVD
    # and sums differ in the last bits: 5e-3); the trajectories after a
    # rigid alignment to 2e-2 m (phases 8 and 11, for the same reasons)
    dratio = float(np.max(np.abs(np.array(inter_c) - np.array(inter_g))))
    dtraj = 0.0
    for a, b in zip(tc, tg):
        _, Ra, ta = tio.umeyama_align(b[:, :3, 3], a[:, :3, 3])
        dtraj = max(dtraj, float(np.abs((Ra @ b[:, :3, 3].T).T + ta - a[:, :3, 3]).max()))
    if dratio > 5e-3 or dtraj > 2e-2:
        raise AssertionError(f"cpu/cuda disagree: inlier ratio {dratio}, aligned trajectory {dtraj} m")
    log(f"[16] reduced fleet (tests/test_fleet.py's scenario, 76 keyframes): "
        f"{sum(len(h) for h in hc)} retrieval hits, {len(inter_c)} inter and "
        f"{sum('loop' in e for e in ec)} intra loops, equal on cpu ({sc:.1f} s) and cuda "
        f"({sg:.2f} s); max |d inlier ratio| {dratio:.2e}, aligned trajectories within {dtraj:.2e} m")


def phase_eviction(torch) -> None:
    import dataclasses

    from scl_slam_tpu_torch.config import (
        KeyframeConfig, LoopConfig, OptimizerConfig, ScanContextParams, SlamConfig,
    )
    from scl_slam_tpu_torch.geometry import se3
    from scl_slam_tpu_torch.io import kitti as kio
    from scl_slam_tpu_torch.runtime import FleetMapper
    from scl_slam_tpu_torch.runtime import mapper as M

    # the fleet at 8 keyframes a robot (tests/test_fleet.py's eviction test)
    world = kio.SyntheticWorld(seed=4)
    gt = kio.loop_trajectory(n_frames=40, radius=25.0, revisit=False).astype(np.float32)
    cfg = reduced_fleet_cfg(max_keyframes=8)
    cfg = dataclasses.replace(cfg, loop=dataclasses.replace(
        cfg.loop, intra_enabled=False, inter_enabled=False))
    fm = FleetMapper(cfg)
    for k in range(0, 40, 2):
        fm.add_robot_frame(0, se3.Pose(gt[k][:3, :3], gt[k][:3, 3]),
                           world.scan_at(gt[k], 4096, seed=k), stamp=0.1 * k)
        fm.step()
    n = int(fm.state.counts[0])
    idx = fm.state.desc_db.index[:n].cpu()
    poses, stamps = fm.full_trajectory(robot=0)
    if not (n <= 8 and len(fm._evicted.get(0, [])) == 20 - n and bool((idx.diff() > 0).all())
            and len(poses) == 20 and np.all(np.diff(stamps) > 0)):
        raise AssertionError(f"fleet eviction: {n} resident, {len(poses)} exported")

    # a replay past capacity: tests/test_eviction.py's configuration, on
    # the card and on the CPU
    ecfg = SlamConfig(
        keyframe=KeyframeConfig(max_keyframes=24, points_per_keyframe=256,
                                raw_points_capacity=512, evict_keep_recent=4,
                                evict_stride=2, distance_threshold=0.5),
        loop=LoopConfig(near_keyframes=2, submap_capacity=512, queue_capacity=8,
                        intra_enabled=False, inter_enabled=False),
        optimizer=OptimizerConfig(edge_capacity=96, gn_iters=2, cg_iters=8),
        scan_context=ScanContextParams(exclude_recent=2),
    )
    rng = np.random.RandomState(7)
    scans = [rng.uniform(-20, 20, (256, 3)).astype(np.float32) for _ in range(60)]
    eye = np.eye(3, dtype=np.float32)
    poses_in = [se3.Pose(eye, np.float32([2.0 * k, 0, 0])) for k in range(60)]
    out = {}
    for device in ("cpu", "cuda"):
        m = M.Mapper(ecfg, device)
        m.replay(poses_in, scans, [float(k) for k in range(60)], batch=8, chunk_batches=1)
        out[device] = (m.state.desc_db.index[:24].cpu().numpy(), *m.full_trajectory(0),
                       len(m._evicted.get(0, [])))
    (ic, pc_, sc_, ec), (ig, pg, sg, eg) = out["cpu"], out["cuda"]
    if not (np.array_equal(ic, ig) and ec == eg > 0 and len(pg) == 60
            and np.array_equal(sg, np.arange(60.0)) and float(np.abs(pc_ - pg).max()) < 1e-4):
        raise AssertionError("replay eviction differs between cpu and cuda, or lost keyframes")
    log(f"[17] eviction on the card: the fleet at 8 keyframes a robot holds {n} of 20 and "
        f"exports 20 in order; a 60-keyframe replay into 24 slots evicted {eg} keyframes, "
        f"the same indices as on the cpu, full_trajectory 60 poses within "
        f"{float(np.abs(pc_ - pg).max()):.2e} m of the cpu's")


def phase_tcp(torch) -> dict:
    rc, rep = run_multi_report(["--robots", "2", "--transport", "tcp",
                                "--output", os.path.join(ROOT, "chiprun_out", "run_multi_tcp")])
    log(f"[12] run_multi --robots 2 --transport tcp -> {json.dumps(rep)}")
    if rc != 0 or rep["inter_loops"] < 1 or rep["device"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"the tcp run on the card verified no inter-robot loop (rc {rc})")
    if any(rep["broken_drains"]):
        raise AssertionError(f"the tcp run: a drain's solve broke down {rep['solve_breakdowns']}")
    log(f"[12] inter loops {rep['inter_loops']}; per robot the drains whose solve broke down "
        f"{rep['broken_drains']} {rep['solve_breakdowns']}, the inter-robot path "
        f"{rep['inter_log']}")
    return rep


@contextlib.contextmanager
def switched(obj, values: dict):
    """Set module switches (``reg.FUSED_ICP`` and the like) for a block."""
    old = {k: getattr(obj, k) for k in values}
    for k, v in values.items():
        setattr(obj, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(obj, k, v)


# the batched-ICP configurations of phases 21 and 22: the JAX package's
# switches (ops/registration.py), each flipped alone
SWITCH_CONFIGS = (
    ("default", {}),
    ("FUSED_ICP", {"FUSED_ICP": True}),
    ("NN_INDEX", {"NN_INDEX": True}),
    ("MXU_NN", {"MXU_NN": True}),
    ("argmin", {"SELECT_VARIANT": "argmin"}),
)


def rot(w):
    th = np.linalg.norm(w)
    if th == 0:
        return np.eye(3)
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k


def tie_free_inputs(torch, B, nq, nt, seed, half=60.0, recentre=False):
    """ICP-like lanes without planted ties: targets uniform in a box of
    half-width ``half`` (5% invalid pads at 1e6), queries noisy copies of
    targets; every 4th lane inactive. ``recentre`` moves each lane to its
    valid-target centroid, as the MXU_NN caller does."""
    rng = np.random.RandomState(seed)
    t = rng.uniform(-half, half, (B, nt, 3)).astype(np.float32)
    valid = rng.rand(B, nt) > 0.05
    pick = rng.randint(0, nt, (B, nq))
    q = np.take_along_axis(t, pick[..., None], 1) + rng.normal(0, 0.3, (B, nq, 3))
    if recentre:
        c = (t * valid[..., None]).sum(1) / valid.sum(1)[:, None]
        t, q = t - c[:, None], q - c[:, None]
    t = np.where(valid[..., None], t, 1e6).astype(np.float32)
    payload = np.concatenate([np.swapaxes(t, -1, -2), valid[:, None].astype(np.float32)], 1)
    active = (np.arange(B) % 4 != 3).astype(np.int32)
    dev = torch.device("cuda")
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                 for x in (q.astype(np.float32), payload, active))


def k5_inputs(torch, B, nq, nt, seed):
    """K5 inputs: tie_free_inputs' lanes (half-width 30 m, about the
    recentred submaps the fused path passes); each lane's queries are put
    in a local frame by a random pose (rotation ~0.25 rad, up to 5 m), which
    R, t map back; ~10% of the source points invalid."""
    q, payload, active = tie_free_inputs(torch, B, nq, nt, seed, half=30.0)
    rng = np.random.RandomState(seed + 1)
    dev = q.device
    R = torch.tensor(np.stack([rot(rng.normal(0, 0.15, 3)) for _ in range(B)]),
                     dtype=torch.float32, device=dev)
    t = torch.tensor(rng.uniform(-5, 5, (B, 3)), dtype=torch.float32, device=dev)
    local = torch.einsum("bji,bnj->bni", R, q - t[:, None])          # R^T (q - t)
    valid = torch.from_numpy(rng.rand(B, nq) > 0.1).to(dev)
    src4 = torch.cat([local.transpose(1, 2), valid[:, None].float()], 1).contiguous()
    return src4, payload, R.contiguous(), t.contiguous(), active


def nn_bound(B_active, nq, nt, n_bytes):
    """9 FP32 operations a (query, target) pair of an active lane: 3
    subtracts, 3 multiplies, 2 adds, 1 compare (K8: 3 multiplies and 2
    adds of the cross term, the doubling, a subtract, an add, a compare)."""
    return bound(n_bytes, 9 * B_active * nq * nt)


def kernel_times(torch, call, plain, graph_reps=20, plain_reps=5):
    """(kernel ms by CUDA-graph replays, eager ms, plain ms)."""
    eager = time_cuda(torch, call, reps=graph_reps)
    ms = time_graph(torch, call, reps=graph_reps)
    plain_ms = time_graph(torch, plain, reps=plain_reps)
    return ms, eager, plain_ms


# K5 against its plain version: the counts exactly; every sum within 2e-6
# of its terms' absolute mass (sum of |term|) of their exact (float64) sum.
# A float32 sum whose every term passes through at most d roundings is
# within d * 2**-24 of that mass. The kernel's order
# (kernels.k5_sum_roundings) at 32 x 1,024 x 8,192 has d <= 24, 1.4e-6:
# the term's product 1, the 2 queries of a lane 1, the 32-lane shuffle
# tree 5, the warps 0 (they merge nearest neighbours, not sums), the
# mineq tie sums across ranges 2, then the 16 query groups in sequence 15.
# The moment sums cancel (signed coordinates), so a bound relative to the
# sum itself would not hold.
K5_MASS_TOL = 2e-6


def k5_error(kernels, m, args, variant) -> float:
    """max |m - exact| / mass over the slots with mass (exactly 0 required
    where the mass is 0: inactive lanes)."""
    terms = kernels.icp_moments_terms_plain(*args, 3.0, variant=variant).double()
    exact, mass = terms.sum(dim=1), terms.abs().sum(dim=1)
    err = (m.double() - exact).abs()
    if bool((err[mass == 0] != 0).any()):
        raise AssertionError("K5: a sum without terms is not zero")
    return float((err / mass.clamp(min=1e-300)).max().item())


def k5_tie_inputs(torch, B, nq, nt, seed):
    """K5 inputs with planted exact ties: k1_inputs' lanes (lane 1's
    targets in triplicate, lane 2's integer queries at unit distance from
    three distinct targets, every 4th lane inactive), the source in a
    random local frame per lane as k5_inputs, but lane 2 at the identity
    pose, which moves its grid points exactly onto themselves."""
    q, payload, active = k1_inputs(torch, B, nq, nt, seed)
    rng = np.random.RandomState(seed + 1)
    dev = q.device
    R = torch.tensor(np.stack([rot(rng.normal(0, 0.15, 3)) for _ in range(B)]),
                     dtype=torch.float32, device=dev)
    t = torch.tensor(rng.uniform(-5, 5, (B, 3)), dtype=torch.float32, device=dev)
    R[2], t[2] = torch.eye(3, device=dev), 0.0
    local = torch.einsum("bji,bnj->bni", R, q - t[:, None])          # R^T (q - t)
    local[2] = q[2]
    valid = torch.from_numpy(rng.rand(B, nq) > 0.1).to(dev)
    src4 = torch.cat([local.transpose(1, 2), valid[:, None].float()], 1).contiguous()
    return src4, payload, R.contiguous(), t.contiguous(), active


def k5_check(torch, kernels, args, variant, what) -> tuple:
    """(kernel sums, plain sums, error of the terms' mass); raises unless
    the counts are equal, the error is within K5_MASS_TOL and inactive
    lanes are zero."""
    m = kernels.icp_moments_batched(*args, 3.0, variant=variant)
    ref = kernels.icp_moments_batched_plain(*args, 3.0, variant=variant)
    torch.cuda.synchronize()
    for k in (kernels.M_W, kernels.M_NSRC):
        if not torch.equal(m[:, k], ref[:, k]):
            raise AssertionError(f"K5 {what} {variant}: slot {k} differs: "
                                 f"{m[:, k].tolist()} vs {ref[:, k].tolist()}")
    rel, rel_p = k5_error(kernels, m, args, variant), k5_error(kernels, ref, args, variant)
    if max(rel, rel_p) > K5_MASS_TOL:
        raise AssertionError(f"K5 {what} {variant}: error {rel} (plain {rel_p}) of the "
                             f"terms' mass > {K5_MASS_TOL}")
    if not (m[~args[4].bool()] == 0).all():
        raise AssertionError(f"K5 {what} {variant}: an inactive lane is not zero")
    return m, ref, rel


def phase_k5(torch, kernels) -> dict:
    res = {}
    for B, nq, nt, label in ((32, 1024, 8192, "full"), (32, 256, 2048, "coarse")):
        args = k5_inputs(torch, B, nq, nt, seed=nq + 5)
        src4, payload, R, t, active = args
        out = {}
        for variant in ("mineq", "argmin"):
            m, ref, rel = k5_check(torch, kernels, args, variant, label)
            if int(m[0, kernels.M_W]) < nq // 2:
                raise AssertionError(f"K5 {label}: too few correspondences {m[0, kernels.M_W]}")
            ms, eager, plain_ms = kernel_times(
                torch, lambda v=variant: kernels.icp_moments_batched(*args, 3.0, variant=v),
                lambda v=variant: kernels.icp_moments_batched_plain(*args, 3.0, variant=v),
            )
            out[variant] = (m, ref, rel, ms, eager, plain_ms)
        if not torch.equal(out["mineq"][0], out["argmin"][0]):
            raise AssertionError(f"K5 {label}: mineq and argmin differ on tie-free inputs")
        ties = k5_tie_inputs(torch, B, nq, nt, seed=nq + 6)
        _, _, rel_tie = k5_check(torch, kernels, ties, "mineq", f"{label} planted ties")
        n_active = int(active.sum().item())
        bound_ms, bound_by = nn_bound(
            n_active, nq, nt, 4 * (B * 4 * nq + B * 4 * nt + B * 12 + B + B * 18)
        )
        m, ref, rel, ms, eager, plain_ms = out["mineq"]
        a_ms = out["argmin"][3]
        g, g_a = (kernels.k5_geometry(B, nq, nt, v) for v in ("mineq", "argmin"))
        log(f"[18] K5 {label} {B}x{nq}x{nt} ({n_active} lanes active): counts equal, error of "
            f"the terms' mass {rel:.3g} (mineq), {out['argmin'][2]:.3g} (argmin), "
            f"{rel_tie:.3g} (mineq, planted ties), mineq == argmin; "
            f"mineq kernel {ms:.4f} ms (eager call {eager:.4f} ms), plain {plain_ms:.4f} ms; "
            f"argmin kernel {a_ms:.4f} ms (eager {out['argmin'][4]:.4f} ms), "
            f"plain {out['argmin'][5]:.4f} ms; bound {bound_ms:.4f} ms ({bound_by})")
        log(f"[18]   K5-mineq {label} geometry: {split_geometry(torch, g, B, n_active)}; at most "
            f"{kernels.k5_sum_roundings(g)} roundings a term; "
            f"{versus_row('K5-mineq ' + label, ms, bound_ms)}")
        log(f"[18]   K5-argmin {label} geometry: {split_geometry(torch, g_a, B, n_active)}; at "
            f"most {kernels.k5_sum_roundings(g_a, 'argmin')} roundings a term; "
            f"{versus_row('K5-argmin ' + label, a_ms, bound_ms)}")
        res[label] = {"max_abs_err": float((m - ref).abs().max().item()), "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}
    return res


def phase_k7(torch, kernels) -> dict:
    """K7 and K1's argmin body against their plain versions, on the planted
    ties of phase 3's inputs."""
    res = {}
    for B, nq, nt, label in ((32, 1024, 8192, "replay"), (16, 1024, 8192, "fleet_ransac")):
        args = k1_inputs(torch, B, nq, nt, seed=nq + B)
        q, payload, active = args
        d7, idx = kernels.nn_index_batched(*args)
        d7_p, idx_p = kernels.nn_index_batched_plain(*args)
        d1, sel = kernels.nn_select_batched(*args, variant="argmin")
        d1_p, sel_p = kernels.nn_select_batched_plain(*args, variant="argmin")
        torch.cuda.synchronize()
        for what, a, b in (("K7 d2", d7, d7_p), ("K7 index", idx, idx_p),
                           ("K1-argmin d2", d1, d1_p), ("K1-argmin sel", sel, sel_p)):
            if not torch.equal(a, b):
                raise AssertionError(f"{what} {label}: differs from the plain version in "
                                     f"{(a != b).sum().item()} places")
        gathered = payload.gather(2, idx.long()[:, None].expand(-1, 4, -1))
        gathered = torch.where(active.bool()[:, None, None], gathered, 0.0)
        if not (torch.equal(d7, d1) and torch.equal(gathered, sel)):
            raise AssertionError(f"K7 + gather {label}: differs from K1-argmin")
        # query k of lane 2 ties at d2 = 1 with targets k, n_tie + k and
        # 2 n_tie + k (and with a lower index where two queries share a
        # grid point): the lowest index wins
        n_tie = min(nt // 3, nq)
        k = torch.arange(n_tie, device=idx.device)
        if not ((d7[2, :n_tie] == 1.0).all() and (idx[2, :n_tie] <= k).all()):
            raise AssertionError(f"K7 {label}: the planted ties did not take the lowest index")
        n_active = int(active.sum().item())
        k7 = kernel_times(torch, lambda: kernels.nn_index_batched(*args),
                          lambda: kernels.nn_index_batched_plain(*args))
        k1a = kernel_times(torch, lambda: kernels.nn_select_batched(*args, variant="argmin"),
                           lambda: kernels.nn_select_batched_plain(*args, variant="argmin"))
        # bytes: queries, the 3 target rows (K7) or 4 payload rows (K1) once,
        # active, and the outputs once
        b7 = nn_bound(n_active, nq, nt, 4 * (B * nq * 3 + B * 3 * nt + B + 2 * B * nq))
        b1 = nn_bound(n_active, nq, nt, 4 * (B * nq * 3 + B * 4 * nt + B + 5 * B * nq))
        log(f"[19] K7 {label} {B}x{nq}x{nt}: d2 and index bit-equal, K7 + gather == K1-argmin; "
            f"K7 kernel {k7[0]:.4f} ms (eager {k7[1]:.4f} ms), plain {k7[2]:.4f} ms, bound "
            f"{b7[0]:.4f} ms ({b7[1]}); K1-argmin kernel {k1a[0]:.4f} ms (eager {k1a[1]:.4f} "
            f"ms), plain {k1a[2]:.4f} ms, bound {b1[0]:.4f} ms ({b1[1]})")
        log(f"[19]   geometry: {split_geometry(torch, kernels.k1_geometry(B, nq, nt), B, n_active)}; "
            f"K7 {versus_row('K7 ' + label, k7[0], b7[0])}; "
            f"K1-argmin {versus_row('K1-argmin ' + label, k1a[0], b1[0])}")
        res[label] = {
            "k7": {"max_abs_err": float((idx - idx_p).abs().max().item()), "ms": k7[0],
                   "plain_ms": k7[2], "bound_ms": b7[0], "bound_by": b7[1]},
            "k1_argmin": {"max_abs_err": float((sel - sel_p).abs().max().item()), "ms": k1a[0],
                          "plain_ms": k1a[2], "bound_ms": b1[0], "bound_by": b1[1]},
        }
    return res


def phase_k8(torch, kernels) -> dict:
    B, nq, nt = 32, 1024, 8192
    args = tie_free_inputs(torch, B, nq, nt, seed=8, recentre=True)
    q, payload, active = args
    d8, sel8 = kernels.nn_select_batched_mxu(*args)
    d8_p, sel8_p = kernels.nn_select_batched_mxu_plain(*args)
    _, sel1 = kernels.nn_select_batched(*args, variant="argmin")
    torch.cuda.synchronize()
    if not (torch.equal(d8, d8_p) and torch.equal(sel8, sel8_p)):
        raise AssertionError(f"K8: differs from the plain version in "
                             f"{(d8 != d8_p).sum().item()} d2 and {(sel8 != sel8_p).sum().item()} "
                             f"sel places")
    on = active.bool()
    m8, m1 = sel8[on, :3].transpose(1, 2), sel1[on, :3].transpose(1, 2)
    same = (m8 == m1).all(-1).float().mean().item()
    dd = (((q[on] - m8) ** 2).sum(-1) - ((q[on] - m1) ** 2).sum(-1)).max().item()
    if same < 0.99 or dd > 5e-3:
        raise AssertionError(f"K8 vs K1: {same:.4f} identical winners, exact d2 {dd} above")
    if not (torch.isinf(d8[~on]).all() and (sel8[~on] == 0).all()):
        raise AssertionError("K8: an inactive lane was written")
    n_active = int(on.sum().item())
    ms, eager, plain_ms = kernel_times(torch, lambda: kernels.nn_select_batched_mxu(*args),
                                       lambda: kernels.nn_select_batched_mxu_plain(*args))
    bound_ms, bound_by = nn_bound(n_active, nq, nt, 4 * (B * nq * 3 + B * 4 * nt + B + 5 * B * nq))
    log(f"[20] K8 {B}x{nq}x{nt} (recentred): bit-equal to the plain version; against K1: "
        f"{100 * same:.3f}% identical winners, exact d2 at most {dd:.3g} above; kernel {ms:.4f} "
        f"ms (eager {eager:.4f} ms), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    log(f"[20]   K8 geometry: {split_geometry(torch, kernels.k1_geometry(B, nq, nt), B, n_active)}; "
        f"{versus_row('K8 replay', ms, bound_ms)}")
    return {"max_abs_err": float((sel8 - sel8_p).abs().max().item()), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def phase_replay_switches(torch, kernels, bench: BenchReplay) -> dict:
    """Phase 21: phase 5's workload under each switch, compared within this
    phase only (host-bound numbers move between calls)."""
    from scl_slam_tpu_torch.ops import registration as reg

    res = {}
    for name, values in SWITCH_CONFIGS:
        with switched(reg, values):
            launches, m, out, times = bench.timed(kernels)
        loops = bench.check_state(m, out)
        k1 = launches["nn_select_batched"] + launches["nn_select_batched_argmin"]
        required = {
            "default": launches["nn_select_batched"] > 0,
            "FUSED_ICP": launches["icp_moments_batched"] > 0 and k1 == 0,
            "NN_INDEX": launches["nn_index_batched"] > 0 and k1 == 0,
            "MXU_NN": launches["nn_select_batched_mxu"] > 0 and k1 > 0,
            "argmin": launches["nn_select_batched_argmin"] > 0
            and launches["nn_select_batched"] == 0,
        }[name]
        if not required:
            raise AssertionError(f"replay under {name} did not launch its kernels: {launches}")
        fps = [bench.n / x for x in times]
        batched = {k: v for k, v in launches.items() if v and k != "max_image"}
        log(f"[21] replay under {name}: median {float(np.median(fps)):.2f} frames/s (runs "
            f"{', '.join(f'{x:.2f}' for x in fps)}), loops {loops}, ICP launches {batched}; "
            f"state checks ok")
        res[name] = {"fps": float(np.median(fps)), "launches": launches}
    return res


def revisit_cfg(submap_capacity: int = 2048):
    from scl_slam_tpu_torch.config import (
        KeyframeConfig, LoopConfig, OptimizerConfig, ScanContextParams, SlamConfig,
    )

    return SlamConfig(
        keyframe=KeyframeConfig(
            max_keyframes=256, points_per_keyframe=1024, raw_points_capacity=16384
        ),
        # sparse surface-sampled synthetic scans: the looser gates that
        # tests/test_pipeline.py uses for them
        loop=LoopConfig(near_keyframes=6, submap_capacity=submap_capacity, icp_iterations=20,
                        history_fitness_score=8.0),
        optimizer=OptimizerConfig(edge_capacity=512),
        scan_context=ScanContextParams(
            exclude_recent=16, num_candidates=6, distance_threshold=0.25
        ),
    )


def revisit_replay(torch, cfg, device, world):
    """The revisit workload through ``Mapper.replay``: (mapper, output,
    seconds)."""
    from scl_slam_tpu_torch.geometry import se3
    from scl_slam_tpu_torch.runtime import mapper as M

    T, scans = world
    poses = [se3.Pose(T[k, :3, :3], T[k, :3, 3]) for k in range(len(T))]
    stamps = [0.1 * k for k in range(len(T))]
    m = M.Mapper(cfg, device)
    t = time.perf_counter()
    out = m.replay(poses, scans, stamps, apply_gate=False, batch=16, chunk_batches=2)
    if device == "cuda":
        torch.cuda.synchronize()
    return m, out, time.perf_counter() - t


def phase_switch_decisions(torch, kernels) -> None:
    """Phase 22: the revisit workload at 4,096-point submaps (so that the
    path rule holds on both ICP stages) under each switch on the card, the
    fused path also on the CPU, then the fleet bench under NN_INDEX."""
    from scl_slam_tpu_torch.ops import registration as reg

    T, scans = revisit_world(64, 16384)
    world = (T.astype(np.float32), scans)
    cfg = revisit_cfg(4096)
    # a lane that ends at the stall exit (no 10% gain in 3 updates, once an
    # update is below STALL_ABS_FACTOR * icp_tol) stops anywhere in a basin
    # of about that size: the JAX package's own bound for such lanes
    stall_bound = reg.STALL_ABS_FACTOR * cfg.loop.icp_tol

    def revisit(name, values, device="cuda"):
        stalled = [0]

        def counting(fn):
            def icp(*a, **k):
                r = fn(*a, **k)
                gate = r.fitness < k["gate_fitness"]
                stalled[0] += int((a[3] & ~r.converged & gate).sum())
                return r
            return icp

        undo = patched(reg, "icp_batched", counting)
        try:
            with switched(reg, values):
                kernels.reset_launch_counts()
                m, out, secs = revisit_replay(torch, cfg, device, world)
                launches = {k: v for k, v in kernels.LAUNCHES.items() if v and k != "max_image"}
        finally:
            undo()
        nq = int(m.state.loop_queue.count)
        lq = m.state.loop_queue
        return {
            "ok": [x is not None for x in out["loops"]],
            "idx": [x["matched_index"] for x in out["loops"] if x],
            "q": {k: getattr(lq, k)[:nq].cpu().numpy() for k in ("i", "j", "z_t")},
            "nq": nq, "secs": secs, "launches": launches, "stalled": stalled[0],
        }

    def compare(r, ref, what):
        """The same decisions, matched indices and queue endpoints; z_t
        within 5e-3 m, but for as many loops as ended at the stall exit in
        either run, which stay within the stall bound. Returns max |dz|."""
        if r["ok"] != ref["ok"] or r["idx"] != ref["idx"]:
            raise AssertionError(f"revisit {what}: loop decisions differ")
        if not all(np.array_equal(r["q"][k], ref["q"][k]) for k in ("i", "j")):
            raise AssertionError(f"revisit {what}: loop-queue endpoints differ")
        dz = np.abs(r["q"]["z_t"] - ref["q"]["z_t"]).max(axis=1)
        n_far = int((dz > 5e-3).sum())
        if n_far > r["stalled"] + ref["stalled"] or dz.max(initial=0.0) > stall_bound:
            raise AssertionError(f"revisit {what}: z_t differs by {dz.max()} m on {n_far} loops "
                                 f"({r['stalled']} + {ref['stalled']} stall exits)")
        return float(dz.max(initial=0.0)), n_far

    runs = {name: revisit(name, values) for name, values in SWITCH_CONFIGS}
    ref = runs["default"]
    if ref["nq"] == 0:
        raise AssertionError("the revisit workload closed no loop at 4,096-point submaps")
    for name in ("FUSED_ICP", "NN_INDEX", "argmin"):
        runs[name]["dz"] = compare(runs[name], ref, f"under {name}")
    for name, r in runs.items():
        same = r["ok"] == ref["ok"] and r["idx"] == ref["idx"]
        verdict = "the same decisions as the default" if same else "decisions differ"
        if "dz" in r:
            verdict += f", max |dz_t| {r['dz'][0]:.2e} m, {r['dz'][1]} above 5e-3 m"
        log(f"[22] revisit 64 frames, 4,096-point submaps, under {name}: {r['nq']} loops "
            f"({verdict}; {r['stalled']} stall exits), {r['secs']:.2f} s, launches {r['launches']}")
    mxu = runs["MXU_NN"]
    log(f"[22] MXU_NN (not required equal): loops {mxu['nq']} vs default {ref['nq']}; "
        f"decisions {'equal' if mxu['ok'] == ref['ok'] else 'differ'}, matched indices "
        f"{'equal' if mxu['idx'] == ref['idx'] else 'differ'}")
    # the fused path end to end against its plain version: the CPU run
    cpu = revisit("FUSED_ICP", {"FUSED_ICP": True}, "cpu")
    dz, n_far = compare(cpu, runs["FUSED_ICP"], "under FUSED_ICP, cpu against cuda")
    log(f"[22] FUSED_ICP on the cpu ({cpu['secs']:.1f} s): the same {cpu['nq']} loops as on the "
        f"card, max |dz_t| {dz:.2e} m")

    # the fleet bench's RANSAC 1-NN under NN_INDEX (K7 + one gather). Its
    # submaps repeat a keyframe while a robot has few, so exact d2 ties
    # between identical points occur: K7 takes the lowest index, as K1's
    # argmin body does, while the default mineq body averages the tied
    # copies, which can move the matched point by an ulp and a residual
    # across the inlier threshold. So NN_INDEX must equal the argmin run
    # exactly, and the default run in attempts and success flags.
    fleet = FleetBench(torch)
    verdicts, fleet_launches = {}, {}
    for name, values in (("default", {}), ("argmin", {"SELECT_VARIANT": "argmin"}),
                         ("NN_INDEX", {"NN_INDEX": True})):
        with switched(reg, values):
            kernels.reset_launch_counts()
            verdicts[name] = fleet.ransac_verdicts()
            fleet_launches[name] = dict(kernels.LAUNCHES)
    la = fleet_launches["NN_INDEX"]
    if la["nn_index_batched"] < 1 or la["nn_select_batched"] + la["nn_select_batched_argmin"] > 0:
        raise AssertionError(f"the fleet bench's RANSAC 1-NN did not go through K7: {la}")
    if verdicts["NN_INDEX"] != verdicts["argmin"]:
        raise AssertionError("fleet bench under NN_INDEX: RANSAC verdicts differ from argmin's")
    ref = verdicts["default"]
    if [(a, s) for a, s, _ in verdicts["NN_INDEX"]] != [(a, s) for a, s, _ in ref]:
        raise AssertionError("fleet bench under NN_INDEX: attempts or successes differ")
    d_inl = [abs(x - y) for (_, _, n1), (_, _, n2) in zip(verdicts["NN_INDEX"], ref)
             for x, y in zip(n1, n2)]
    att = sum(sum(a) for a, _, _ in ref)
    succ = sum(sum(s) for _, s, _ in ref)
    log(f"[22] fleet bench under NN_INDEX: RANSAC verdicts equal to the argmin run's; the same "
        f"{att} inter attempts and {succ} successes as the default, inlier counts differing on "
        f"{sum(1 for x in d_inl if x)} lanes by at most {max(d_inl, default=0)}; K7 launches "
        f"{la['nn_index_batched']}, K1 0")


# ---------------------------------------------------------------------------
# the quality anchor's slice (phases 23-27)
# ---------------------------------------------------------------------------

# the simulator on the card against the CPU: rays whose valid flag may
# differ (the direction table is built on the host for both, so none), and
# the coordinates' tolerance (the world-frame rotation is a cuBLAS matmul)
SIM_FLIPPED_RAYS = 0
SIM_ATOL = 1e-4
# the depths of the run_multi sessions that repeat a path phase 11 drives
# at run_multi's default 120 frames: frames of its synthetic sequence for
# the three-robot run (phase 11) and the four-robot city-scale run (phase
# 27), halved (the city-scale run to a third since phase 44 came) to keep
# the script well inside its time limit (at 120: ~37 s and ~59 s on an
# H100; the city-scale run 51.8 s at 60), widths untouched
MULTI3_FRAMES = 60
CITYSCALE_FRAMES = 40
# phase 8's CPU-against-card run: frames of the demo's sequence (9 loops
# at 40; its CPU side took ~34 s at 60)
DEMO_CROSS_FRAMES = 40
# phase 29's checkpoint cadence: a save at the default widths costs ~3 s
# on the feed's critical path (~72 s of the run's ~110 s at every 5
# frames, 81 s of the run at every 10, 65.0 s at every 20); at every 40
# the crash after frame 45 resumes from the checkpoint at frame 40
RESPAWN_CKPT_EVERY = 40
RESPAWN_CRASH_AFTER = 45
# phase 44: host Scan Context images against K2's, bins > 1e-5 apart in
# any 4 frames (tests/test_torch_native_loader.py's bound on its 4 frames:
# a point within ~2e-7 rad of a sector boundary may land one sector over)
HOST_IMAGE_BINS = 2
# how far the anchor's loop counts of two runs of one input part on the
# card (its solves' atomics): 590-594 under f32 and host images, 576-581
# under int16 and f32 on the same int16 scans (this script's runs on an H100)
ANCHOR_LOOP_SPREAD = 6


def anchor_world(n_azimuth: int, device):
    """The anchor's world: (scene, simulator on ``device``, lap poses)."""
    from scl_slam_tpu_torch import bench_quality as bq
    from scl_slam_tpu_torch.io import lidar_sim

    scene = lidar_sim.UrbanScene(seed=7, blocks=1, block_size=40.0)
    return scene, lidar_sim.LidarSim(scene, n_azimuth, device), bq.build_gt(scene, bq.LAPS)


def phase_sim(torch) -> None:
    """Phase 23: the simulator on the card against the CPU."""
    from scl_slam_tpu_torch.io import lidar_sim

    scene, card, gt = anchor_world(1024, "cuda")
    cpu = lidar_sim.LidarSim(scene, 1024, "cpu")
    flipped, err = 0, 0.0
    for k in (0, 100, 200):
        noise = torch.randn(card.points_per_scan, generator=torch.Generator().manual_seed(k))
        xc, mc = lidar_sim._render(cpu.boxes, *cpu._pose(gt[k]), k, 1024, noise=noise)
        xg, mg = lidar_sim._render(card.boxes, *card._pose(gt[k]), k, 1024, noise=noise.cuda())
        xg, mg = xg.cpu(), mg.cpu()
        flipped += int((mc != mg).sum())
        both = mc & mg
        err = max(err, float((xc[both] - xg[both]).abs().max()))
    if flipped > SIM_FLIPPED_RAYS or err > SIM_ATOL:
        raise AssertionError(f"simulator card vs cpu: {flipped} rays flipped, points {err} m apart")
    for k in range(3):
        card.scan_at(gt[k], seed=k)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for k in range(50):
        card.scan_at(gt[k], seed=k)
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t) / 50 * 1e3
    t = time.perf_counter()
    for k in range(3):
        cpu.scan_at(gt[k], seed=k)
    cpu_ms = (time.perf_counter() - t) / 3 * 1e3
    log(f"[23] simulator at 1,024 azimuths (65,536 rays, {len(scene.boxes)} boxes), card against "
        f"cpu at 3 anchor poses with the same noise: {flipped} rays flipped, points within "
        f"{err:.2e} m; {card_ms:.2f} ms a scan on the card (render + copy to the host), "
        f"{cpu_ms:.1f} ms on the cpu")


def phase_anchor(torch, kernels) -> dict:
    """Phase 24: the quality anchor at full width and depth through the
    port's bench_quality.run_session, held to the golden gate; then K1 and
    K2 against their plain versions at the shapes it launched them."""
    from scl_slam_tpu_torch import bench_quality as bq
    from scl_slam_tpu_torch.ops import pointcloud as pc

    scene, sim, gt = anchor_world(1024, "cuda")
    odom = bq.drift_odometry(gt)
    cfg = bq.quality_config(False)
    shapes: dict = {}

    def recording(name):
        def wrap(fn):
            def call(*a, **k):
                key = (name,) + tuple(a[0].shape[:2]) + (a[1].shape[-1],)
                shapes[key] = shapes.get(key, 0) + 1
                return fn(*a, **k)
            return call
        return wrap

    # the session's layers, each timed alone (a synchronize before and after)
    from scl_slam_tpu_torch.runtime import mapper as M

    acc: dict = {}
    scans: dict = {}  # kept for phase 44's replays under the input modes

    def render(k):
        scans[k] = sim.scan_at(gt[k], seed=k)
        return scans[k]

    scan = timing(torch, acc, "render (LidarSim.scan_at)")(render)
    undos = [patched(kernels, "nn_select_batched", recording("K1")),
             patched(kernels, "max_image", recording("K2")),
             patched(M.Mapper, "_compact", timing(torch, acc, "eviction (Mapper._compact)")),
             patched(M, "_replay_batches", timing(torch, acc, "replay chunk (_replay_batches)")),
             patched(M.Mapper, "add_frames", timing(torch, acc, "last 72 (add_frames, with its eviction)")),
             patched(M, "_drain_queue_and_optimize", timing(torch, acc, "drain + solve"))]
    try:
        kernels.reset_launch_counts()
        rec, m, _ = bq.run_session(cfg, gt, odom, scan, "cuda", 32, 6)
        launches = dict(kernels.LAUNCHES)
    finally:
        for u in reversed(undos):
            u()
    with open(bq.GOLDEN) as f:
        rc = bq.gate(rec, json.load(f))
    log(f"[24] quality anchor -> {json.dumps(rec)}")
    log(f"[24] launches {launches}; shapes (kernel, lanes, queries or points, targets): "
        f"{ {str(k): v for k, v in sorted(shapes.items())} }")
    if rc != 0 or rec["keyframes"] != len(gt) or rec["evicted"] < 1:
        raise AssertionError(f"the anchor missed its golden gate or its depth: {rec}")
    if launches["nn_select_batched"] < 1 or launches["max_image"] < 1:
        raise AssertionError(f"the anchor did not go through K1 and K2: {launches}")
    log(f"[24] ATE {rec['value']:.4f} m (dead reckoning {rec['ate_odom_m']:.4f} m, ratio "
        f"{rec['ratio']:.4f}; bounds 3.272 m, 0.9), {rec['keyframes']} keyframes, {rec['evicted']} "
        f"evicted, {rec['loops']} loops, wall {rec['wall_s']:.2f} s; K1 launches "
        f"{launches['nn_select_batched']}, K2 {launches['max_image']}")
    log("[24] the session's layers, each timed alone (calls, total ms, share of the wall):")
    for name, vals in sorted(acc.items(), key=lambda kv: -sum(kv[1])):
        log(f"[24]   {name:34s} {len(vals):5d} calls {sum(vals):10.1f} ms "
            f"{100 * sum(vals) / (1e3 * rec['wall_s']):5.1f}%")

    res = {"launches": launches, "record": rec}
    # K1 at its two most launched shapes (the fine and coarse ICP stages of
    # a 32-frame batch)
    top = sorted((k for k in shapes if k[0] == "K1"), key=lambda k: -shapes[k])[:2]
    for _, B, nq, nt in top:
        r = k1_case(torch, kernels, B, nq, nt, seed=nq + nt)
        log(f"[24] K1 {B}x{nq}x{nt} ({shapes[('K1', B, nq, nt)]} launches in the anchor): d2 "
            f"bit-equal, sel within {r['max_abs_err']:.3g} (tol {r['tol']:.3g}), kernel {r['ms']:.4f} ms (20 to a graph "
            f"{r['many_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}), {100 * r['bound_ms'] / r['ms']:.1f}% of the bound")
        res[f"K1 {B}x{nq}x{nt}"] = r
    # K2 on 32 of the anchor's own scans, padded to its raw capacity
    n = cfg.keyframe.raw_points_capacity
    xyz = np.full((32, n, 3), pc.PAD_VALUE, np.float32)
    mask = np.zeros((32, n), bool)
    for b in range(32):
        s = sim.scan_at(gt[6 * b], seed=6 * b)
        xyz[b, : len(s)], mask[b, : len(s)] = s, True
    xyz, mask = torch.from_numpy(xyz).cuda(), torch.from_numpy(mask).cuda()
    ring, sector, valid = pc.polar_bins(xyz, mask, 20, 60, 80.0)
    args = ((xyz[..., 2] + cfg.scan_context.lidar_height).contiguous(), ring.contiguous(),
            sector.contiguous(), valid.contiguous(), 20, 60)
    r = k2_case(torch, kernels, args)
    r.update(zip(("bound_ms", "bound_by"), k2_bound(args)))
    r["valid_rows"] = int(args[3].sum())
    log(f"[24] K2 32x{n} (the anchor's scans, {r['valid_rows']} of {32 * n} rows valid; "
        f"{shapes.get(('K2', 32, n, n), 0)} launches): "
        f"bit-equal, kernel {r['ms']:.4f} ms (20 to a graph {r['many_ms']:.4f} ms), plain "
        f"{r['plain_ms']:.4f} ms, scatter_reduce_ {r['library_ms']:.4f} ms, bound "
        f"{r['bound_ms']:.4f} ms ({r['bound_by']}), {100 * r['bound_ms'] / r['ms']:.1f}% of the bound")
    res["K2"] = r
    res.update(scans=scans, gt=gt, odom=odom)
    return res


def phase_anchor_cross(torch) -> None:
    """Phase 25: the anchor's first two 6 x 32 chunks (384 frames, past its
    first revisit) at its widths, on the CPU (plain versions) and on the
    card, on the same scans rendered once on the card; the capacity is cut
    to 256 so that the second chunk also evicts. Stated tolerances: every
    frame's Scan Context candidate (found, matched index) equal and the
    descriptors within 1e-4 (f32 atan2 and sums); the same non-empty set of
    loops and the same evicted frames. The witness: the card's last drain
    and solve, repeated on the CPU from the card's own state, lands within
    1e-3 m of the card's (the f32 solves of one graph on two devices); the
    two runs' loop measurements differ where their ICP took another path
    (it does not converge in 30 iterations), and the trajectories are held
    within 1e-2 m. Both hold raw where every drain kept the same start in
    both runs; where one kept another (``hold_drains``: a chi2 tie), each
    start's solution is held raw against the other run's up to that drain,
    and the trajectories after a rotation about z and a translation. No
    drain's solve may break down (``Mapper.broken_drains``) on either
    device, nor the witness's."""
    from scl_slam_tpu_torch import bench_quality as bq
    from scl_slam_tpu_torch.runtime import mapper as M
    from scl_slam_tpu_torch.runtime.state import state_from_numpy, state_to_numpy

    scene, sim, gt = anchor_world(1024, "cuda")
    n = 384
    scans = [sim.scan_at(gt[k], seed=k) for k in range(n)]
    odom = bq.drift_odometry(gt[:n])
    cfg = bq.quality_config(False, max_keyframes=256)
    out, drained, drains = {}, [], {}
    for device in ("cpu", "cuda"):
        frames: list = []

        def keep(fn):
            def call(*a, **k):
                res = fn(*a, **k)
                frames.append([x.cpu().numpy() for x in res[1:]])
                return res
            return call

        def keep_input(fn):
            def call(state, cfg_):
                if state.opt_t.is_cuda:
                    drained.append(state_to_numpy(state))
                return fn(state, cfg_)
            return call

        undos = [patched(M, "_replay_batches", keep),
                 patched(M, "_drain_queue_and_optimize", keep_input)]
        drains[device], undo = record_drains(M)
        undos.append(undo)
        t = time.perf_counter()
        try:
            rec, m, loops = bq.run_session(cfg, gt, odom, lambda k: scans[k], device, 32, 6,
                                           n_frames=n)
        finally:
            for u in reversed(undos):
                u()
        ok, idx, fit = (np.concatenate([f[i] for f in frames]) for i in range(3))
        out[device] = (rec, m, ok, idx, fit, time.perf_counter() - t)
    (rc, mc, okc, idxc, fitc, sc), (rg, mg, okg, idxg, fitg, sg) = out["cpu"], out["cuda"]
    att = (idxc >= 0) & np.isfinite(fitc) & np.isfinite(fitg)
    gap = np.abs(fitc[att] - fitg[att])
    moved = gap > 1e-3 * np.minimum(fitc[att], fitg[att])
    log(f"[25] anchor prefix, {n} frames (6 x 32 chunks, capacity 256): {int(att.sum())} frames "
        f"attempted a loop; per attempted frame (frame, candidate, cpu fitness, cuda fitness): "
        f"{[(int(k), int(idxc[k]), round(float(fitc[k]), 6), round(float(fitg[k]), 6)) for k in np.flatnonzero(att)]}")
    if not np.array_equal(idxc, idxg) or not np.array_equal(okc, okg) or not okc.any():
        flips = np.flatnonzero(okc != okg)
        raise AssertionError(f"anchor prefix: candidates or loop decisions differ between cpu and "
                             f"cuda (decisions differ at frames {flips.tolist()}), or no loop closed")
    dd = float((mc.state.desc_db.descriptors - mg.state.desc_db.descriptors.cpu()).abs().max())
    ev_c = {r: [e["index"] for e in v] for r, v in mc._evicted.items()}
    ev_g = {r: [e["index"] for e in v] for r, v in mg._evicted.items()}
    # the witness: the card's last drain and solve again on the CPU
    witness, undo = record_drains(M)
    try:
        solved, _, w_broken = M._drain_queue_and_optimize(state_from_numpy(drained[-1], "cpu"), cfg)
    finally:
        undo()
    live = int(mg.state.counts[0])
    w_flip, w_gap = hold_drains(drains["cuda"][-1:], witness, live, 1e-3)
    dsolve = w_gap if w_flip is not None else float((solved.opt_t - mg.state.opt_t.cpu()).abs().max())
    gc, gg = mc.state.graph, mg.state.graph
    E = int(gc.num_edges)
    dz_t = float((gc.z.t[:E] - gg.z.t[:E].cpu()).abs().max())
    dz_R = float((gc.z.R[:E] - gg.z.R[:E].cpu()).abs().max())
    (ec, tc), (eg, tg) = mc.full_trajectory(), mg.full_trajectory()
    flip, start_gap = hold_drains(drains["cpu"], drains["cuda"], live, 1e-2)
    dt = float(np.abs(ec - eg).max()) if flip is None else yaw_aligned_gap(ec[:, :3, 3], eg[:, :3, 3])
    starts = ("every drain kept the same start on both" if flip is None else
              f"drain {flip} kept another start (a chi2 tie), the starts' solutions within "
              f"{start_gap:.2e} m, so the trajectories after a yaw and translation alignment")
    same = "the same start" if w_flip is None else "each start against its own, a chi2 tie"
    broken = {"cpu": (mc.broken_drains, mc.solve_breakdowns),
              "cuda": (mg.broken_drains, mg.solve_breakdowns), "witness": w_broken.tolist()}
    log(f"[25] anchor prefix: {len(drained)} drains on the card; its last drain and solve again "
        f"on the cpu within {dsolve:.2e} m ({same}); drains whose solve broke down (cpu, "
        f"cuda) {mc.broken_drains}, {mg.broken_drains}; "
        f"the {E} factors' measurements within {dz_t:.2e} m and {dz_R:.2e} (rotation entries) "
        f"between the runs; {starts}; trajectories within {dt:.2e} m")
    if (dd > 1e-4 or ev_c != ev_g or rc["evicted"] < 1 or int(gg.num_edges) != E
            or not np.array_equal(gc.i[:E].numpy(), gg.i[:E].cpu().numpy())
            or not np.array_equal(gc.j[:E].numpy(), gg.j[:E].cpu().numpy())
            or not np.array_equal(tc, tg) or dsolve > 1e-3 or dt > 1e-2
            or mc.broken_drains or mg.broken_drains or any(w_broken.tolist())):
        raise AssertionError(f"anchor prefix: descriptors {dd}, evicted {rc['evicted']} / "
                             f"{rg['evicted']}, the solve {dsolve} m, trajectories {dt} m apart, "
                             f"broken solves {broken}")
    log(f"[25] anchor prefix: {int(okc.sum())} loops on both, every candidate and decision equal "
        f"({int(moved.sum())} attempted frames whose fitness moved by more than 1e-3 relative, "
        f"the largest {float(gap.max()) if gap.size else 0.0:.3g}); {rc['evicted']} evicted on "
        f"both; descriptors within {dd:.2e}; ATE cpu {rc['value']:.4f} m, cuda "
        f"{rg['value']:.4f} m; cpu {sc:.1f} s, cuda {sg:.2f} s")


def pcm_queue(torch, device, M=256, good=40, bad=12):
    """A loop queue of M slots: ``good`` consistent loops between two
    robots' frames, ``bad`` gross outliers, the rest invalid. Returns the
    pcm_filter arguments on ``device``."""
    from scl_slam_tpu_torch.geometry import se3

    rng = np.random.RandomState(0)
    R_ab, t_ab = rot(np.array([0.0, 0.0, 0.4])), np.array([5.0, -2.0, 0.3])
    ai = [(rot(np.array([0, 0, 0.05 * k])), np.array([1.5 * k, 0.2 * k, 0])) for k in range(M)]
    bj = [(R_ab @ R, R_ab @ t + t_ab) for R, t in ai]
    z = []
    for k, ((Ra, ta), (Rb, tb)) in enumerate(zip(ai, bj)):
        s_rot, s_t = (0.002, 0.02) if k < good else (0.5, 10.0)
        z.append((Ra.T @ Rb @ rot(rng.normal(0, s_rot, 3)),
                  Ra.T @ Rb @ rng.normal(0, s_t, 3) + Ra.T @ (tb - ta)))

    def poses(ps):
        return se3.Pose(torch.tensor(np.stack([p[0] for p in ps]), dtype=torch.float32, device=device),
                        torch.tensor(np.stack([p[1] for p in ps]), dtype=torch.float32, device=device))

    return [poses(ps) for ps in (ai, bj, z)] + [torch.from_numpy(np.arange(M) < good + bad).to(device)]


def circle_graph(torch, device, n=512, laps=2, n_loops=16):
    """A pose graph of ``laps`` laps of a 40 m circle with noisy odometry
    (a prior on pose 0) and ``n_loops`` loop factors from the later laps to
    the first; returns (graph, dead-reckoned poses) on ``device``."""
    from scl_slam_tpu_torch.geometry import se3
    from scl_slam_tpu_torch.graph import factors as F

    rng = np.random.RandomState(2)
    per = n // laps
    gt = []
    for k in range(n):
        a = 2 * np.pi * k / per
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = rot(np.array([0, 0, a + np.pi / 2])), [40 * np.cos(a), 40 * np.sin(a), 0]
        gt.append(T)
    g = F.make_graph(2 * n, device=device)
    F.add_prior(g, 0, se3.Pose(torch.tensor(gt[0][:3, :3], dtype=torch.float32, device=device),
                               torch.tensor(gt[0][:3, 3], dtype=torch.float32, device=device)),
                [1e3] * 6)
    Z, ii, jj, si = [], [], [], []
    for k in range(n - 1):
        noise = np.eye(4)
        noise[:3, :3], noise[:3, 3] = rot(rng.normal(0, 0.002, 3)), rng.normal(0, 0.02, 3)
        Z.append(np.linalg.inv(gt[k]) @ gt[k + 1] @ noise)
        ii.append(k), jj.append(k + 1), si.append([500.0] * 3 + [50.0] * 3)
    for a in np.linspace(0, per - 1, n_loops).astype(int):
        b = a + per * int(rng.randint(1, laps))
        Z.append(np.linalg.inv(gt[a]) @ gt[b])
        ii.append(int(a)), jj.append(int(b)), si.append([100.0] * 6)
    Z = np.stack(Z).astype(np.float32)
    F.add_between_block(g, torch.tensor(ii, device=device), torch.tensor(jj, device=device),
                        se3.Pose(torch.from_numpy(Z[:, :3, :3]).to(device),
                                 torch.from_numpy(Z[:, :3, 3]).to(device)),
                        torch.tensor(si, dtype=torch.float32, device=device))
    X = [gt[0]]
    for k in range(n - 1):
        X.append(X[-1] @ Z[k])
    X = np.stack(X).astype(np.float32)
    return g, se3.Pose(torch.from_numpy(X[:, :3, :3]).to(device), torch.from_numpy(X[:, :3, 3]).to(device))


def as_f64(g, poses):
    """A factor graph and poses with their float tensors in f64."""
    from scl_slam_tpu_torch.geometry import se3

    def p64(q):
        return se3.Pose(q.R.double(), q.t.double())

    return g._replace(z=p64(g.z), sqrt_info=g.sqrt_info.double(), prior_z=p64(g.prior_z),
                      prior_sqrt_info=g.prior_sqrt_info.double()), p64(poses)


def phase_modes_cross(torch) -> None:
    """Phase 26: the storage modes and PCM, CPU against card (no drain's
    solve may break down on either)."""
    import dataclasses

    from scl_slam_tpu_torch.graph import chain_solver, pcm, solver
    from scl_slam_tpu_torch.runtime import mapper as M

    T, scans = revisit_world(64, 16384)
    world = (T.astype(np.float32), scans)
    base = revisit_cfg()
    for what, kf, opt in (
        ("storage_downsample='voxel_hash' (16,384 raw points: the hash path)",
         {"storage_downsample": "voxel_hash"}, {}),
        ("storage_downsample='voxel'", {"storage_downsample": "voxel"}, {}),
        ("use_pcm=True", {}, {"use_pcm": True}),
    ):
        cfg = dataclasses.replace(base, keyframe=dataclasses.replace(base.keyframe, **kf),
                                  optimizer=dataclasses.replace(base.optimizer, **opt))
        runs, drains = {}, {}
        for device in ("cpu", "cuda"):
            drains[device], undo = record_drains(M)
            try:
                m, out, secs = revisit_replay(torch, cfg, device, world)
                nq = int(m.state.loop_queue.count)
                q = {k: getattr(m.state.loop_queue, k)[:nq].cpu().numpy() for k in ("i", "j")}
                m.optimize()
            finally:
                undo()
            g = m.state.graph
            E = int(g.num_edges)
            runs[device] = ([x is not None for x in out["loops"]],
                            [x["matched_index"] for x in out["loops"] if x], q,
                            (E, g.i[:E].cpu().numpy(), g.j[:E].cpu().numpy()),
                            m.state.opt_t.cpu().numpy(), secs,
                            (m.broken_drains, m.solve_breakdowns))
        c, d = runs["cpu"], runs["cuda"]
        same = (c[0] == d[0] and c[1] == d[1] and all(np.array_equal(c[2][k], d[2][k]) for k in "ij")
                and c[3][0] == d[3][0] and np.array_equal(c[3][1], d[3][1])
                and np.array_equal(c[3][2], d[3][2]))
        flip, dopt = hold_drains(drains["cpu"], drains["cuda"], len(c[0]), 1e-3)
        if flip is None:
            dopt = float(np.abs(c[4] - d[4]).max())
        if not same or not any(c[0]) or dopt > 1e-3 or c[6][0] or d[6][0]:
            raise AssertionError(f"revisit under {what}: cpu and cuda differ (opt_t {dopt} m), "
                                 f"no loop closed, or a drain's solve broke down (cpu, cuda: "
                                 f"{c[6]}, {d[6]})")
        starts = ("every drain kept the same start on both" if flip is None else
                  f"drain {flip} kept another start (a chi2 tie), each start's solution held "
                  f"against its own")
        log(f"[26] revisit 64 frames under {what}: {sum(c[0])} loops, the same decisions, matched "
            f"indices, queue and drained edges ({c[3][0]}) on cpu ({c[5]:.1f} s) and cuda "
            f"({d[5]:.2f} s); {starts}; max |dopt_t| {dopt:.2e} m; drains whose solve broke "
            f"down {c[6][0]}, {d[6][0]}")

    cpu_args, card_args = pcm_queue(torch, "cpu"), pcm_queue(torch, "cuda")
    acc_c, acc_g = pcm.pcm_filter(*cpu_args).numpy(), pcm.pcm_filter(*card_args).cpu().numpy()
    if not (np.array_equal(acc_c, acc_g) and acc_c[:40].all() and not acc_c[40:].any()):
        raise AssertionError("pcm_filter: the accept masks differ or the outliers got in")
    torch.cuda.synchronize()
    t = time.perf_counter()
    pcm.pcm_filter(*card_args)
    torch.cuda.synchronize()
    log(f"[26] pcm_filter on a 256-slot queue (40 consistent loops, 12 outliers): the same accept "
        f"mask on cpu and cuda, every outlier rejected; {1e3 * (time.perf_counter() - t):.2f} ms "
        f"on the card")

    # the exact chain solver against one PCG solve of the same graph
    res, res64 = {}, {}
    for device in ("cpu", "cuda"):
        g, init = circle_graph(torch, device)
        res64[device] = chain_solver.chain_solve(*as_f64(g, init), gn_iters=6, loop_capacity=32)
        r = chain_solver.chain_solve(g, init, gn_iters=6, loop_capacity=32)
        if device == "cuda":
            torch.cuda.synchronize()
            t = time.perf_counter()
            again = chain_solver.chain_solve(g, init, gn_iters=6, loop_capacity=32)
            torch.cuda.synchronize()
            chain_ms = (time.perf_counter() - t) * 1e3
            solver.solve(g, init, gn_iters=6, cg_iters=64)
            torch.cuda.synchronize()
            t = time.perf_counter()
            p = solver.solve(g, init, gn_iters=6, cg_iters=64)
            torch.cuda.synchronize()
            pcg_ms = (time.perf_counter() - t) * 1e3
        res[device] = r
    # the witness: the same solve in f64 on both devices, its whole chi2
    # history within 1e-6 relative and its poses within 1e-5 m. Where it
    # holds, the two devices run the same algorithm, and the f32 runs'
    # gap in the steps between is the rounding of an ill-conditioned step
    c64, g64 = res64["cpu"], res64["cuda"]
    chi64_c, chi64_g = c64.chi2_history.numpy(), g64.chi2_history.cpu().numpy()
    rel64 = float((np.abs(chi64_c - chi64_g) / chi64_c).max())
    dt64 = float((c64.poses.t - g64.poses.t.cpu()).abs().max())
    log(f"[26] chain_solve in f64: chi2 history cuda {', '.join(f'{x:.10g}' for x in chi64_g)}, "
        f"cpu {', '.join(f'{x:.10g}' for x in chi64_c)}; within {rel64:.2e} relative, poses "
        f"within {dt64:.2e} m")
    if bool(c64.loop_overflow) or bool(g64.loop_overflow) or rel64 > 1e-6 or dt64 > 1e-5:
        raise AssertionError(f"chain_solve f64: cpu and cuda chi2 {rel64} relative, poses "
                             f"{dt64} m apart: a fault, not f32 rounding")
    rc, rg = res["cpu"], res["cuda"]
    dt = float((rc.poses.t - rg.poses.t.cpu()).abs().max())
    chi_c, chi_g = rc.chi2_history.numpy(), rg.chi2_history.cpu().numpy()
    d0, dlast = (float(abs(chi_c[i] - chi_g[i]) / chi_c[i]) for i in (0, -1))
    # stated tolerances in f32: the two devices agree to 1e-3 m and in the
    # final chi2 to 5e-3 (the f32 chi2 carries arccos rounding of up to
    # 3.9e-3 of its value, tests/test_torch_chain_solver.py), the first
    # chi2 (the same inputs) to 1e-5. The f32 steps between are held by the
    # f64 witness above, not here
    if (bool(rc.loop_overflow) or bool(rg.loop_overflow) or dt > 1e-3 or d0 > 1e-5
            or dlast > 5e-3):
        raise AssertionError(f"chain_solve: cpu and cuda {dt} m, first chi2 {d0}, last {dlast} apart")
    log(f"[26] chain_solve on a 2-lap circle (512 poses, 16 loops, 6 GN steps) in f32: cpu and "
        f"cuda within {dt:.2e} m, final chi2 within {dlast:.2e}; chi2 history cuda "
        f"{', '.join(f'{x:.6g}' for x in chi_g)} (a second run: "
        f"{', '.join(f'{x:.6g}' for x in again.chi2_history.cpu().numpy())}), cpu "
        f"{', '.join(f'{x:.6g}' for x in chi_c)}; its steps (m) cuda "
        f"{', '.join(f'{x:.3g}' for x in rg.delta_norms.cpu().numpy())}, cpu "
        f"{', '.join(f'{x:.3g}' for x in rc.delta_norms.numpy())}; "
        f"{chain_ms:.1f} ms on the card, one solver.solve of the same graph (6 x 64 PCG) "
        f"{pcg_ms:.1f} ms (chi2 -> {float(p.chi2_history[-1]):.6g})")


def phase_cityscale(torch, kernels, frames: int) -> None:
    """Phase 27: run_multi --robots 4 with configs/four_robot_cityscale.yaml
    on the card (PCM on), ``frames`` frames of the synthetic sequence."""
    from scl_slam_tpu_torch.graph import pcm

    rejected = [0, 0]

    def counting(fn):
        def filt(loops_i, loops_j, loops_z, valid, threshold=0.75):
            acc = fn(loops_i, loops_j, loops_z, valid, threshold=threshold)
            rejected[0] += int((valid & ~acc).sum())
            rejected[1] += int(valid.sum())
            return acc
        return filt

    undo = patched(pcm, "pcm_filter", counting)
    try:
        kernels.reset_launch_counts()
        rc, rep = run_multi_report(["--robots", "4", "--config",
                                    os.path.join(ROOT, "configs", "four_robot_cityscale.yaml"),
                                    "--frames", str(frames), "--output",
                                    os.path.join(ROOT, "chiprun_out", "run_multi_cityscale")])
        launches = dict(kernels.LAUNCHES)
    finally:
        undo()
    log(f"[27] run_multi --robots 4 --config configs/four_robot_cityscale.yaml --frames {frames} "
        f"-> {json.dumps(rep)}")
    if rc != 0 or rep["device"] != torch.cuda.get_device_name(0) or launches["max_image"] < 1:
        raise AssertionError(f"the city-scale run failed on the card (rc {rc}): {launches}")
    log(f"[27] inter loops {rep['inter_loops']}, intra {rep['intra_loops']}; PCM rejected "
        f"{rejected[0]} of {rejected[1]} ready loops over the drains; wall {rep['wall_s']} s; "
        f"launches {launches}")


def record_drains(M):
    """Keep each drain's two solves in this process: returns (drains,
    undo), where ``drains`` gets one entry a drain that solved, {"t": the
    warm and the chordal start's solved opt_t (numpy), "chi": their final
    chi2}. The drain keeps the lower chi2 (as in the JAX package), so where
    the two tie, a run on another device may keep the other: with the
    prior's loose yaw and translation (sigmas 3.14 rad, 1e4 m) the two may
    end a rigid motion apart."""
    drains, open_ = [], []

    def wrap_solve(fn):
        def call(*a, **k):
            r = fn(*a, **k)
            if open_:
                open_[-1].append(r)
            return r
        return call

    def wrap_drain(fn):
        def call(*a, **k):
            open_.append([])
            try:
                return fn(*a, **k)
            finally:
                runs = open_.pop()
                if runs:
                    drains.append({"t": [r.poses.t.cpu().numpy() for r in runs],
                                   "chi": [float(r.chi2_history[-1]) for r in runs]})
        return call

    undos = [patched(M.solver, "solve", wrap_solve), patched(M, "_drain_queue_and_optimize", wrap_drain)]
    return drains, lambda: [u() for u in reversed(undos)]


def kept_start(drain) -> str:
    """Which start a recorded drain kept (its device's own f32 test)."""
    return "chordal" if drain["chi"][1] < drain["chi"][0] else "warm"


def tied(drain, rel: float = 5e-3) -> bool:
    """The two starts' final chi2 within ``rel`` of each other: the f32
    chi2 carries arccos rounding up to 3.9e-3 of its value
    (tests/test_torch_chain_solver.py)."""
    lo, hi = sorted(drain["chi"])
    return hi - lo <= rel * hi


def hold_drains(da, db, n: int, bound: float) -> tuple:
    """Two runs of one session, drain by drain: (index of the first drain
    that kept another start in each run or None, the largest gap (m) of
    each start's solution against the same start's in the other run up to
    that drain, over the first ``n`` slots). A differing drain must be a
    tie in both runs, or the runs differ."""
    if len(da) != len(db):
        raise AssertionError(f"{len(da)} drains against {len(db)}")
    gap = 0.0
    for k, (a, b) in enumerate(zip(da, db)):
        gap = max(gap, *(float(np.abs(x[:n] - y[:n]).max()) for x, y in zip(a["t"], b["t"])))
        if kept_start(a) != kept_start(b):
            if not (tied(a) and tied(b)) or gap > bound:
                raise AssertionError(f"drain {k} kept the {kept_start(a)} start against the "
                                     f"{kept_start(b)} one: chi2 {a['chi']} vs {b['chi']}, the "
                                     f"starts' solutions {gap} m apart")
            return k, gap
    return None, gap


def yaw_aligned_gap(a, b) -> float:
    """The largest position gap (m) of ``a`` onto ``b`` ([N, 3]) after the
    best rotation about z and translation: the freedom the prior leaves
    loose, which two tied starts may end apart by."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ca, cb = a.mean(0), b.mean(0)
    x, y = a[:, :2] - ca[:2], b[:, :2] - cb[:2]
    psi = np.arctan2(np.sum(x[:, 0] * y[:, 1] - x[:, 1] * y[:, 0]), np.sum(x * y))
    R = np.array([[np.cos(psi), -np.sin(psi), 0.0], [np.sin(psi), np.cos(psi), 0.0], [0.0, 0.0, 1.0]])
    return float(np.abs((a - ca) @ R.T + cb - b).max())


def drive_on(m, frames, poses, scans, stamp0: int) -> list:
    """Feed ``frames`` to a Mapper (``add_frame`` + ``spin_once`` on the
    frame's stamp); returns (keyframe?, matched index or None) a frame."""
    from scl_slam_tpu_torch.geometry import se3

    out = []
    for j, k in enumerate(frames):
        T = poses[k].astype(np.float32)
        stamp = 0.1 * (stamp0 + j)
        wire = m.add_frame(se3.Pose(T[:3, :3], T[:3, 3]), scans[k], stamp=stamp)
        loop = None if wire is None else m.spin_once(now=stamp)["loop"]
        out.append((wire is not None, loop and loop["matched_index"]))
    return out


# phase 28's depth on the CPU: the first frames of the card's 30 (the CPU's
# frames cost ~2 s each at these widths; the card's side is not cut)
CKPT_CPU_FRAMES = 10


def phase_checkpoint(torch, kernels, drive) -> dict:
    """Phase 28: phase 9's live-kitti session (260 keyframes at the
    kitti_velodyne widths) saved on the card, loaded onto the CPU and the
    card; the resumed card mapper and the original (uninterrupted) go on
    30 frames of a third lap, the CPU's on the first CKPT_CPU_FRAMES of
    them: the same keyframes and loop decisions; the card's resume within
    1e-4 m of the uninterrupted run and the CPU's within 1e-3 m of it at
    the same frame (no solve runs in these frames: their spin_once clock
    starts behind phase 9's)."""
    import shutil
    import tempfile

    from scl_slam_tpu_torch.io import kitti as kio
    from scl_slam_tpu_torch.runtime import checkpoint
    from scl_slam_tpu_torch.runtime import mapper as M
    from scl_slam_tpu_torch.runtime.state import state_to_numpy

    m, cfg, world, odom = drive["mapper"], drive["cfg"], drive["world"], list(drive["odom"])
    n0, extra = len(odom), 30
    if m._keyframes < 200:
        raise AssertionError(f"phase 9's session holds {m._keyframes} keyframes, not 200 or more")
    gt = kio.loop_trajectory(n_frames=n0 + extra, radius=45.0, laps=2.0 * (n0 + extra) / n0)
    rng = np.random.RandomState(12)
    for k in range(n0, n0 + extra):  # phase 9's odometry drift, continued
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = rot(rng.normal(0, 1e-3, 3)), rng.normal(0, 1e-2, 3)
        odom.append(odom[-1] @ np.linalg.inv(gt[k - 1]) @ gt[k] @ T)
    scans = {k: world.scan_at(gt[k], max_points=cfg.keyframe.raw_points_capacity, seed=k)
             for k in range(n0, n0 + extra)}
    tmp = tempfile.mkdtemp(prefix="ckpt_")
    try:
        path = os.path.join(tmp, "live_kitti.npz")
        torch.cuda.synchronize()
        info = checkpoint.save(m, path)
        t = time.perf_counter()
        cpu = checkpoint.load(M.Mapper(cfg, device="cpu"), path)
        load_cpu = time.perf_counter() - t
        t = time.perf_counter()
        card = checkpoint.load(M.Mapper(cfg), path)
        torch.cuda.synchronize()
        load_card = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ref = state_to_numpy(m.state)
    for other in (cpu, card):
        for key, v in state_to_numpy(other.state).items():
            if not np.array_equal(v, ref[key]):
                raise AssertionError(f"the checkpoint's {key} differs from the saved state")
    log(f"[28] checkpoint of the live-kitti session ({m._keyframes} keyframes, "
        f"{m.cfg.keyframe.max_keyframes} x {m.cfg.keyframe.points_per_keyframe} slots): "
        f"{info['bytes']} bytes, save {info['save_s']:.3f} s with the locks held "
        f"{1e3 * info['lock_s']:.2f} ms (the device clone and the cursors), load onto the CPU "
        f"{load_cpu:.3f} s, onto the card {load_card:.3f} s; both bit-equal to the saved state")
    frames = list(range(n0, n0 + extra))
    attempts0 = m.icp_attempts
    kernels.reset_launch_counts()
    t = time.perf_counter()
    resumed = drive_on(card, frames, odom, scans, n0)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t
    launches = dict(kernels.LAUNCHES)
    # the uninterrupted run, with its state where the CPU's shorter run ends
    whole = drive_on(m, frames[:CKPT_CPU_FRAMES], odom, scans, n0)
    attempts_cpu_end, traj_cpu_end = m.icp_attempts, m.trajectory()
    whole += drive_on(m, frames[CKPT_CPU_FRAMES:], odom, scans, n0 + CKPT_CPU_FRAMES)
    t = time.perf_counter()
    on_cpu = drive_on(cpu, frames[:CKPT_CPU_FRAMES], odom, scans, n0)
    t_cpu = time.perf_counter() - t
    loops = sum(x[1] is not None for x in whole)
    if not (resumed == whole and on_cpu == whole[:CKPT_CPU_FRAMES]
            and card.icp_attempts == m.icp_attempts and cpu.icp_attempts == attempts_cpu_end):
        raise AssertionError(f"after the checkpoint: decisions differ: card {resumed}, "
                             f"uninterrupted {whole}, cpu {on_cpu}")
    if launches["max_image"] < extra or launches["nn_select"] < 1:
        raise AssertionError(f"the resumed drive launched K2 {launches['max_image']} and K4 "
                             f"{launches['nn_select']} times")
    d_card = float(np.abs(card.trajectory() - m.trajectory()).max())
    d_cpu = float(np.abs(cpu.trajectory() - traj_cpu_end).max())
    if not (d_card <= 1e-4 and d_cpu <= 1e-3):
        raise AssertionError(f"trajectories after the resume: card {d_card} m, cpu {d_cpu} m")
    log(f"[28] {extra} more frames from the checkpoint: the same {sum(x[0] for x in whole)} "
        f"keyframes and {loops} loops after {m.icp_attempts - attempts0} ICP attempts on the "
        f"resumed card mapper and the uninterrupted one, the same for the CPU's first "
        f"{CKPT_CPU_FRAMES} ({cpu.icp_attempts - attempts0} attempts); trajectories within "
        f"{d_card:.2e} m (card) and {d_cpu:.2e} m (cpu); {t_card:.2f} s on the card, "
        f"{t_cpu:.1f} s on the CPU; the resumed drive's launches {launches}")
    return {"bytes": info["bytes"], "save_s": info["save_s"], "lock_s": info["lock_s"],
            "load_cpu_s": load_cpu, "load_card_s": load_card, "launches": launches}


def phase_respawn(torch, tcp: dict) -> dict:
    """Phase 29: ``run_multi --robots 2 --transport tcp --respawn 2
    --checkpoint-every RESPAWN_CKPT_EVERY --crash-robot 0 --crash-after
    RESPAWN_CRASH_AFTER`` (the worker resumes from the frame-40 checkpoint)
    on the card at its default 120 frames: exit 0, one respawn on stderr, inter loops, both robots'
    ATE under 1 m (the JAX package's test bound), K2 and K3 launched."""
    import contextlib
    import io

    from scl_slam_tpu_torch import run_multi

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run_multi.main(["--robots", "2", "--transport", "tcp", "--respawn", "2",
                             "--checkpoint-every", str(RESPAWN_CKPT_EVERY), "--crash-robot", "0",
                             "--crash-after", str(RESPAWN_CRASH_AFTER),
                             "--output", os.path.join(ROOT, "chiprun_out", "run_multi_respawn")])
    lines = out.getvalue().strip().splitlines()
    rep = json.loads(lines[-1]) if rc == 0 and lines else {}
    log(f"[29] run_multi --robots 2 --transport tcp --respawn 2 --checkpoint-every "
        f"{RESPAWN_CKPT_EVERY} --crash-robot 0 --crash-after {RESPAWN_CRASH_AFTER} -> "
        f"{json.dumps(rep)}")
    ates = rep.get("ate_rmse_m", {})
    if (rc != 0 or "respawn 1/2" not in err.getvalue() or rep["respawns"] != 1
            or rep["inter_loops"] < 1 or set(ates) != {"a", "b"} or max(ates.values()) >= 1.0
            or rep["launches"]["max_image"] < 1 or rep["launches"]["nearest_neighbors"] < 1):
        raise AssertionError(f"the respawn run failed (rc {rc}): {err.getvalue()[-2000:]}")
    log(f"[29] crashed and respawned: {rep['inter_loops']} inter loops, ATE {ates}, "
        f"{rep['wall_s']} s; phase 12 uncrashed: {tcp['inter_loops']} inter loops, ATE "
        f"{tcp['ate_rmse_m']}, {tcp['wall_s']} s")
    return rep


def phase_serve(torch) -> dict:
    """Phase 30: ``python -m scl_slam_tpu_torch.serve --config
    configs/kitti_velodyne.yaml`` on the card, on a free port, with a map
    export every second. A client sends a revisiting drive of the
    simulator's urban world (the anchor's scene, 2,048 azimuths: scans of
    up to 131,072 points) with its poses: every other frame of a lap, then
    36 frames of the same lane again, which revisit it (the dense world of
    phases 9 and 28 passes no candidate through the 0.3 fitness gate at
    these widths); then ``trajectory``, ``save`` and ``shutdown``. It must
    close loops, launch K2 a keyframe and K4, write the exports and exit
    0; an in-process Mapper on the card fed the same frames must make the
    same keyframe and loop decisions, its trajectory within 1e-3 m of the
    daemon's. The daemon's drains cannot be seen from here: where the gap
    is larger, a drain of the in-process run must have tied its two starts
    (``tied``), and the trajectories are then held after a rotation about
    z and a translation. No drain's solve may break down in either run
    (``broken_drains``; before PCG stopped on r.z <= 0, a few starts in a
    hundred did on the card, ROADMAP queue 3 item 4)."""
    import shutil
    import tempfile

    from scl_slam_tpu_torch import bench_quality as bq
    from scl_slam_tpu_torch.config import load_config
    from scl_slam_tpu_torch.runtime import mapper as M
    from scl_slam_tpu_torch.serve import SlamClient

    scene, sim, _ = anchor_world(2048, "cuda")
    gt = bq.build_gt(scene, (0.0, 0.0))
    lap = len(gt) // 2
    frames = list(range(0, lap, 2)) + list(range(lap, lap + 72, 2))
    poses = {k: np.asarray(gt[k], np.float32) for k in frames}
    scans = {k: sim.scan_at(gt[k], seed=k) for k in frames}
    config = os.path.join(ROOT, "configs", "kitti_velodyne.yaml")
    tmp = tempfile.mkdtemp(prefix="serve_")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        x for x in (ROOT, os.environ.get("PYTHONPATH")) if x))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "scl_slam_tpu_torch.serve", "--port", "0", "--config", config,
         "--map-every", "1", "--map-dir", os.path.join(tmp, "map")],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        if "serving on :" not in line:
            raise AssertionError(f"the daemon did not start: {line!r}")
        start_s = time.perf_counter() - t0
        client = SlamClient(port=int(line.rsplit(":", 1)[1]))
        lat, served = [], []
        for j, k in enumerate(frames):
            t = time.perf_counter()
            r = client.frame(scans[k], poses[k], stamp=0.1 * j)
            lat.append((time.perf_counter() - t) * 1e3)
            served.append((bool(r["keyframe"]), r["loop"] and r["loop"]["matched_index"]))
        stats = client.stats()
        traj = client.trajectory()["poses"]
        assert client.save(os.path.join(tmp, "save")) == {"ok": True}
        saved = sorted(os.listdir(os.path.join(tmp, "save")))
        published = sorted(os.listdir(os.path.join(tmp, "map"))) if os.path.isdir(
            os.path.join(tmp, "map")) else []
        if "global_map.ply" not in saved:  # a diagnostic for the failure below
            client.save(os.path.join(tmp, "again"))
            log(f"[30] the save wrote no global map; the daemon's trajectory finite: "
                f"{bool(np.isfinite(traj).all())}; a second save wrote "
                f"{sorted(os.listdir(os.path.join(tmp, 'again')))}")
        client.shutdown()
        client.close()
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    lat = np.array(lat)
    want = ["a_keyposes.pcd", "a_kitti.txt", "a_tum.txt", "global_map.ply", "loop_constraints.json"]
    launches = stats["launches"]
    if (rc != 0 or stats["loops"] < 1 or saved != want or "global_map.ply" not in published
            or launches["max_image"] < stats["keyframes"] or launches["nn_select"] < 1
            or stats["broken_drains"]):
        raise AssertionError(f"the daemon: rc {rc}, stats {stats}, saved {saved}, published "
                             f"{published}")
    sizes = [len(scans[k]) for k in frames]
    log(f"[30] serve --config configs/kitti_velodyne.yaml on the card: up in {start_s:.1f} s; "
        f"{len(frames)} frames of {min(sizes)}-{max(sizes)} points, {stats['keyframes']} "
        f"keyframes, {stats['loops']} loops; a request p50 {np.percentile(lat, 50):.2f} ms, p99 "
        f"{np.percentile(lat, 99):.2f} ms, max {lat.max():.2f} ms against the 100 ms sensor "
        f"period; save wrote {saved}, the 1 s publisher {published}; shutdown exit {rc}; "
        f"the daemon's launches {launches}; its drains whose solve broke down "
        f"{stats['broken_drains']} ({stats['solve_breakdowns'] or 'none'})")
    m = M.Mapper(load_config(config))
    drains, undo = record_drains(M)
    try:
        local = drive_on(m, frames, poses, scans, 0)
    finally:
        undo()
    d = float(np.abs(m.trajectory() - traj).max())
    ties = [k for k, x in enumerate(drains) if tied(x)]
    d_yaw = yaw_aligned_gap(m.trajectory()[:, :3, 3], traj[:, :3, 3]) if d > 1e-3 and ties else None
    if local != served or not (d <= 1e-3 or (d_yaw is not None and d_yaw <= 1e-3)) or m.broken_drains:
        raise AssertionError(f"the daemon against an in-process Mapper ({m.solve_breakdowns}): decisions "
                             f"{served} vs {local}, trajectories {d} m apart (after yaw and "
                             f"translation {d_yaw}; tied drains {ties})")
    log(f"[30] an in-process Mapper on the card fed the same frames: the same keyframes and "
        f"loop decisions, drains whose solve broke down {m.broken_drains} "
        f"({'; '.join(m.solve_breakdowns) or 'none'}), trajectories within {d:.2e} m"
        + ("" if d_yaw is None else f", {d_yaw:.2e} m after yaw and translation (tied drains "
                                    f"{ties} of {len(drains)})"))
    return {"p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
            "loops": stats["loops"], "launches": launches}


# ---------------------------------------------------------------------------
# the descriptor families' slice (phases 31-35)
# ---------------------------------------------------------------------------

# the vector families on the card against the CPU, on the same k-NN (the
# card's, checked against the CPU's exact ranking on sampled rows): the
# normals' eigensolver (cuSOLVER against LAPACK) may give another sign where
# the viewpoint rule ties; GRSD and M2DP held within these, FPFH and SHOT
# within the bins their tied-sign normals may move (tests/
# test_torch_descriptor_families.py states the same rules)
VECTOR_ATOL = {"grsd": 1e-3, "m2dp": 1e-4}


def iris_k2_inputs(torch, B, n, seed0=0):
    """K2's inputs for LiDAR-Iris as ``lidar_iris.make`` builds them: B of
    the simulator's scans at 2,048 azimuths (the anchor's scene; up to
    131,072 points, padded to n), 9 channels a frame: [9B, n] points into
    80 x 360 bins."""
    from scl_slam_tpu_torch.descriptors import lidar_iris as li
    from scl_slam_tpu_torch.ops import pointcloud as pc

    scene, sim, gt = anchor_world(2048, "cuda")
    xyz = torch.full((B, n, 3), pc.PAD_VALUE, device="cuda")
    mask = torch.zeros((B, n), dtype=torch.bool, device="cuda")
    for b in range(B):
        s = torch.from_numpy(sim.scan_at(gt[(seed0 + 37 * b) % len(gt)], seed=b)).cuda()
        xyz[b, : len(s)], mask[b, : len(s)] = s, True
    cfg = li.LidarIrisConfig()
    row, col, arc, valid = li.iris_bins(xyz, mask, cfg)
    hits = arc[:, None, :] == torch.arange(8, dtype=torch.int32, device="cuda")[:, None]
    chan_valid = torch.cat([hits & valid[:, None], valid[:, None]], 1).reshape(9 * B, n)
    values = torch.cat([torch.ones((B, 8, n), device="cuda"), xyz[:, None, :, 2]], 1)
    return (values.reshape(9 * B, n).contiguous(),
            row[:, None].expand(B, 9, n).reshape(9 * B, n).contiguous(),
            col[:, None].expand(B, 9, n).reshape(9 * B, n).contiguous(),
            chan_valid.contiguous(), 80, 360)


def phase_k2_iris(torch, kernels, k2_sc: dict) -> dict:
    """Phase 31: K2 at LiDAR-Iris's 80 x 360 bins (113 KB of shared memory
    a block, past the default 48 KB) against its plain version: one frame's
    9 channels (the live path) and a 32-frame replay batch's 288; then the
    Scan Context shapes of phase 4 timed again after the opt-in."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    max_bins = kernels.max_image_max_bins(torch.device("cuda"))
    if max_bins < 80 * 360:
        raise AssertionError(f"the card holds {max_bins} bins a block, fewer than Iris's 28,800")
    out = {}
    for label, B in (("iris_live", 1), ("iris_replay", 32)):
        args = iris_k2_inputs(torch, B, 131072)
        res = k2_case(torch, kernels, args)
        res.update(zip(("bound_ms", "bound_by"), k2_bound(args)))
        g = kernels.k2_geometry(9 * B, 131072, bins=80 * 360)
        log(f"[31] K2 {label} {9 * B}x131072 -> 80x360 (the simulator's scans at 2,048 "
            f"azimuths, {int(args[3].sum())} valid rows): bit-equal, kernel {res['ms']:.4f} ms "
            f"(20 to a graph {res['many_ms']:.4f} ms, eager call {res['call_ms']:.4f} ms), plain "
            f"{res['plain_ms']:.4f} ms, scatter_reduce_ {res['library_ms']:.4f} ms, bound "
            f"{res['bound_ms']:.4f} ms ({res['bound_by']}), {100 * res['bound_ms'] / res['ms']:.1f}% "
            f"of the bound; {9 * B * g.chunks} blocks ({9 * B * g.chunks / sms:.2f} per SM) of "
            f"{g.threads} threads, {g.chunks} chunks of {g.chunk_len} points a frame, "
            f"{4 * 80 * 360} bytes of shared memory a block (the card allows {4 * max_bins})")
        out[label] = res
    for label, B, n, kind, _ in K2_SHAPES:
        args = k2_inputs(torch, B, n, kind)
        res = k2_case(torch, kernels, args, full=False)
        before = k2_sc[label]
        log(f"[31] K2 {label} {B}x{n} -> 20x60 again after the Iris launches: {res['ms']:.4f} ms "
            f"(20 to a graph {res['many_ms']:.4f}) against phase 4's {before['ms']:.4f} "
            f"({before['many_ms']:.4f})")
        out[f"again {label}"] = res
    return out


def iris_pairs(images, cfg, device, torch):
    """tests/test_iris_realistic.py's margin workload on ``device``, on
    ``images`` (frame -> [80, 360] image): six frames of a lap, each
    against the nearest frame of the lap 0.5 m aside (true pairs), and five
    pairs of far frames of the lap (false pairs). Returns (true distances,
    false distances, ms a match after a warm-up)."""
    from scl_slam_tpu_torch.descriptors import lidar_iris as li

    def d(a, b):
        return float(li.match_pair(images[a].to(device), images[b].to(device), cfg)[0])

    d(IRIS_TRUE[0][0], IRIS_TRUE[0][1])  # warm-up (cuFFT's plans)
    if device == "cuda":
        torch.cuda.synchronize()
    t = time.perf_counter()
    true_d = [d(a, b) for a, b in IRIS_TRUE]
    false_d = [d(a, b) for a, b in IRIS_FALSE]
    return true_d, false_d, (time.perf_counter() - t) / 11 * 1e3


# tests/test_iris_realistic.py's pairs, as (query, candidate) keys: lap
# frame i against the frame of the lap 0.5 m aside nearest to it, and far
# frames of one lap
IRIS_FRAMES = (5, 30, 60, 100, 150, 200)
# a false pair's distance, card against CPU, where the two devices' sub-pixel
# shift estimates round apart (the best of shift +-2 then spans other shifts)
IRIS_APART_ATOL = 2e-3
IRIS_TRUE = tuple((("lap1", i), ("lap0", i)) for i in IRIS_FRAMES)
IRIS_FALSE = tuple((("lap0", a), ("lap0", b))
                   for a, b in ((5, 60), (30, 100), (60, 150), (100, 200), (5, 150)))


def iris_flip_bound(torch, images_g, images_c, a, b, cfg):
    """How far a pair's distance may move between the card's and the CPU's
    features of the same images at the same shift: every template bit that
    flipped moves the count of differing bits by at most 1, every mask bit
    by 2 and the valid count by 1; the distance is that count over twice
    the valid count, which is at least V, the fewest valid bits of the
    CPU's features over all 360 shifts. Returns (bound, flipped fraction
    of the pair's feature bits)."""
    from scl_slam_tpu_torch.descriptors import lidar_iris as li

    feats, fT, fM = [], 0, 0
    for key in (a, b):
        Tg, Mg = li.encode_features(images_g[key], cfg)
        Tc, Mc = li.encode_features(images_c[key], cfg)
        fT += int((Tg.cpu() != Tc).sum())
        fM += int((Mg.cpu() != Mc).sum())
        feats.append(Mc)
    Ma, Mb = feats
    V = min(int((~(torch.roll(Ma, s, dims=-1) | Mb)).sum()) for s in range(Ma.shape[-1]))
    V = max(V - fM, 1)
    return (fT + 2 * fM) / (2 * V) + fM / V, (fT + fM) / (6 * Ma.numel())


def phase_iris_sim(torch) -> None:
    """Phase 32: LiDAR-Iris at 80 x 360 bins on the simulator's scans at
    1,800 azimuths (up to 115,200 points in a 131,072-point cloud), on the
    card and on the CPU: each image's bins within the atan2 tolerance (two
    bins a point on a boundary, 0.1% of the points); on the same images,
    the reference's 0.32 gate separates the true pairs from the false ones
    with a 2x margin on the card, as tests/test_iris_realistic.py holds it
    in the JAX package, and each pair's distance on the card lies within
    the bound its flipped feature bits imply (``iris_flip_bound``: cuFFT
    against pocketfft) of the CPU's, at the same yaw."""
    from scl_slam_tpu_torch.descriptors import lidar_iris as li
    from scl_slam_tpu_torch.io import lidar_sim
    from scl_slam_tpu_torch.ops import pointcloud as pc

    scene = lidar_sim.UrbanScene(seed=7, blocks=1, block_size=40.0)
    sim = lidar_sim.LidarSim(scene, 1800, "cuda")
    laps = {"lap0": scene.circuit(lane_offset=0.0, step=1.0),
            "lap1": scene.circuit(lane_offset=0.5, step=1.0)}
    pos1 = np.stack([T[:3, 3] for T in laps["lap1"]])
    poses = {("lap0", i): laps["lap0"][i] for i in range(len(laps["lap0"]))}
    for i in IRIS_FRAMES:
        j = int(np.linalg.norm(pos1 - laps["lap0"][i][:3, 3], axis=1).argmin())
        poses[("lap1", i)] = laps["lap1"][j]
    keys = sorted({k for pair in IRIS_TRUE + IRIS_FALSE for k in pair})
    cfg = li.LidarIrisConfig()
    images_g, images_c, moved, points = {}, {}, 0, 0
    make_ms = []
    for key in keys:
        seed = key[1] + (1000 if key[0] == "lap1" else 0)
        xyz = torch.from_numpy(sim.scan_at(poses[key], seed=seed))
        for dev, out in (("cuda", images_g), ("cpu", images_c)):
            cloud = pc.from_points(xyz.to(dev), 131072)
            if dev == "cuda":
                torch.cuda.synchronize()
            t = time.perf_counter()
            out[key] = li.make(cloud, cfg).image
            if dev == "cuda":
                torch.cuda.synchronize()
                make_ms.append((time.perf_counter() - t) * 1e3)
        moved += int((images_g[key].cpu() != images_c[key]).sum())
        points += len(xyz)
    if moved > 2 * int(1e-3 * points):
        raise AssertionError(f"Iris images card against cpu: {moved} bins differ ({points} points)")
    same = {k: v.cpu() for k, v in images_g.items()}
    tg, fg, ms_g = iris_pairs(images_g, cfg, "cuda", torch)
    tc, fc, ms_c = iris_pairs(same, cfg, "cpu", torch)
    worst, flipped, apart = 0.0, 0.0, []
    for (a, b), dg, dc in zip(IRIS_TRUE + IRIS_FALSE, tg + fg, tc + fc):
        bnd, frac = iris_flip_bound(torch, images_g, same, a, b, cfg)
        flipped = max(flipped, frac)
        yg = float(li.match_pair(images_g[a], images_g[b], cfg)[1])
        yc = float(li.match_pair(same[a], same[b], cfg)[1])
        if yg == yc:
            worst = max(worst, abs(dg - dc) / max(bnd, 1e-12))
            ok = abs(dg - dc) <= bnd
        else:
            # the sub-pixel shift of a false pair rounded apart (a true
            # pair's yaw seeds ICP and must agree): its best of shift +-2
            # is taken over other shifts, held within IRIS_APART_ATOL
            apart.append((a, b, yg, yc, abs(dg - dc)))
            ok = (a, b) in IRIS_FALSE and abs(dg - dc) <= IRIS_APART_ATOL
        if not ok:
            raise AssertionError(f"Iris pair {a} {b}: card {dg} (yaw {yg}), cpu {dc} (yaw {yc}), "
                                 f"bound {bnd}")
    margin = min(fg) / float(np.median(tg))
    log(f"[32] Iris on the simulator (1,800 azimuths, {len(keys)} scans): {moved} image bins differ "
        f"card against cpu (bound {2 * int(1e-3 * points)}); true pairs "
        f"{[round(d, 4) for d in tg]}, false pairs {[round(d, 4) for d in fg]} on the card, margin "
        f"{margin:.3f}; on the same images the cpu's within {max(abs(x - y) for x, y in zip(tg + fg, tc + fc)):.2e} "
        f"(at most {worst:.2f} of each pair's flip bound; feature bits flipped by cuFFT against "
        f"pocketfft: at most {flipped:.2e} of a pair's); yaws equal but for false pairs whose "
        f"shift rounded apart: {apart}; a make "
        f"{np.median(make_ms[1:]):.2f} ms on the card, a match {ms_g:.2f} ms ({ms_c:.1f} on the cpu)")
    if not (all(d < 0.32 for d in tg) and all(d > 0.32 for d in fg) and margin >= 2.0):
        raise AssertionError(f"Iris on the card: the 0.32 gate does not separate the pairs: "
                             f"true {tg}, false {fg}")


def iris_live_cfg():
    """tests/test_iris_realistic.py's end-to-end configuration."""
    from scl_slam_tpu_torch.config import (
        DescriptorType, KeyframeConfig, LidarIrisParams, LoopConfig, OptimizerConfig, SlamConfig,
    )

    return SlamConfig(
        descriptor_type=DescriptorType.LIDAR_IRIS,
        keyframe=KeyframeConfig(max_keyframes=512, points_per_keyframe=8192,
                                raw_points_capacity=131072, distance_threshold=1.0),
        loop=LoopConfig(near_keyframes=6, submap_capacity=16384, history_fitness_score=0.3,
                        icp_iterations=30),
        optimizer=OptimizerConfig(edge_capacity=2048, gn_iters=5, cg_iters=32),
        lidar_iris=LidarIrisParams(),
    )


def phase_iris_live(torch, kernels) -> dict:
    """Phase 33: tests/test_iris_realistic.py's live Iris session on the
    card: a lap of the simulator's urban block at 1,024 azimuths and 80
    frames of the lap 0.5 m aside, drifting odometry, add_frame + spin_once
    a frame; it must close 5 loops or more and end below 0.85 of dead
    reckoning's ATE. Prints a keyframe's p50/p99 ms and the K2 and K4
    launches."""
    from scl_slam_tpu_torch.geometry import se3
    from scl_slam_tpu_torch.io import lidar_sim
    from scl_slam_tpu_torch.io import trajectory as tio
    from scl_slam_tpu_torch.runtime import mapper as M

    scene = lidar_sim.UrbanScene(seed=7, blocks=1, block_size=40.0)
    sim = lidar_sim.LidarSim(scene, 1024, "cuda")
    gt = scene.circuit(lane_offset=0.0, step=1.0) + scene.circuit(lane_offset=0.5, step=1.0)[:80]
    rng = np.random.RandomState(3)
    odom = [np.float32(gt[0])]
    for k in range(1, len(gt)):
        noise = np.eye(4)
        w, u = rng.randn(3) * 0.002, rng.randn(3) * 0.02
        noise[:3, :3] = rot(w)
        noise[:3, 3] = u
        odom.append(np.float32(odom[-1] @ (np.linalg.inv(gt[k - 1]) @ gt[k]) @ noise))
    scans = [sim.scan_at(T, seed=k) for k, T in enumerate(gt)]
    m = M.Mapper(iris_live_cfg())
    kernels.reset_launch_counts()
    lat, loops = [], 0
    for k in range(len(gt)):
        T = odom[k]
        t = time.perf_counter()
        wire = m.add_frame(se3.Pose(T[:3, :3], T[:3, 3]), scans[k], stamp=float(k))
        if wire is not None:
            loops += bool(m.spin_once(now=1.0 * k).get("loop"))
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t) * 1e3)
    m.optimize()
    launches = dict(kernels.LAUNCHES)
    est, stamps = m.trajectory(), m.keyframe_stamps()
    idx = [int(round(float(s))) for s in stamps]
    kf_gt = np.stack([gt[i] for i in idx])
    ate = tio.ate_rmse(est, kf_gt, align=False)
    dead = tio.ate_rmse(np.stack(odom)[idx].astype(np.float64), kf_gt, align=False)
    lat = np.array(lat[10:])
    log(f"[33] the live Iris session (test_iris_realistic.py's, {len(gt)} frames, "
        f"{m._keyframes} keyframes): {loops} loops, ATE {ate:.4f} m against dead reckoning "
        f"{dead:.4f} m (ratio {ate / dead:.4f}, bound 0.85); add_frame + spin_once a keyframe "
        f"p50 {np.percentile(lat, 50):.2f} ms, p99 {np.percentile(lat, 99):.2f} ms; ICP "
        f"attempts {m.icp_attempts}; launches {launches}")
    if loops < 5 or not ate < 0.85 * dead or dead <= 1.0:
        raise AssertionError(f"the live Iris session: {loops} loops, ATE {ate} vs {dead}")
    if launches["max_image"] != m._keyframes or launches["nn_select"] < 1:
        raise AssertionError(f"the live Iris session did not go through K2 a keyframe and K4: "
                             f"{launches}")
    return {"p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99)),
            "launches": launches, "loops": loops}


def phase_iris_multi(torch, kernels) -> dict:
    """Phase 34: ``run_multi --robots 2 --config configs/two_robot_iris.yaml``
    on the card (the configuration's widths: 131,072 raw points, 4,096 a
    keyframe, 80 x 360 Iris images, 16,384-point submaps): exit 0, inter
    loops, each robot's ATE under 1 m, one K3 launch a verification; then
    the reduced two-robot session of phase 11 under LiDAR-Iris on the CPU
    and on the card: the same retrieval hits and inter-loop decisions."""
    from scl_slam_tpu_torch.io import trajectory as tio
    from scl_slam_tpu_torch.runtime import mapper as M

    served = []

    def counting(fn):
        def serve(self, req):
            served.append(1)
            return fn(self, req)
        return serve

    undo = patched(M.Mapper, "serve_verification", counting)
    try:
        kernels.reset_launch_counts()
        t = time.perf_counter()
        rc, rep = run_multi_report(["--robots", "2", "--config",
                                    os.path.join(ROOT, "configs", "two_robot_iris.yaml"),
                                    "--output", os.path.join(ROOT, "chiprun_out", "run_multi_iris")])
        wall = time.perf_counter() - t
        launches = dict(kernels.LAUNCHES)
    finally:
        undo()
    log(f"[34] run_multi --robots 2 --config configs/two_robot_iris.yaml -> {json.dumps(rep)}; "
        f"launches {launches}; {len(served)} verifications; {wall:.1f} s")
    if rc != 0 or rep["inter_loops"] < 1:
        raise AssertionError(f"the Iris two-robot run verified no inter-robot loop (rc {rc})")
    if launches["nearest_neighbors"] != len(served) or launches["max_image"] < 1:
        raise AssertionError(f"K3 launches {launches['nearest_neighbors']} != verifications "
                             f"{len(served)}, or no K2")
    if not all(np.isfinite(v) and v < 1.0 for v in rep["ate_rmse_m"].values()):
        raise AssertionError(f"Iris two-robot ATE out of bounds: {rep['ate_rmse_m']}")

    runs = {d: reduced_multi_session(torch, d, "lidar_iris") for d in ("cpu", "cuda")}
    (hc, ic, tc, sc), (hg, ig, tg, sg) = runs["cpu"], runs["cuda"]
    if hc != hg or [x[:4] for x in ic] != [x[:4] for x in ig] or not hc:
        raise AssertionError(f"reduced Iris session: hits cpu {hc} cuda {hg}; inter loops cpu "
                             f"{ic} cuda {ig}")
    dtraj = 0.0
    for a, b in zip(tc, tg):
        _, Ra, ta = tio.umeyama_align(b[:, :3, 3], a[:, :3, 3])
        dtraj = max(dtraj, float(np.abs((Ra @ b[:, :3, 3].T).T + ta - a[:, :3, 3]).max()))
    if dtraj > 2e-2:
        raise AssertionError(f"reduced Iris session: aligned trajectories {dtraj} m apart")
    log(f"[34] reduced two-robot session under LiDAR-Iris: {len(hc)} retrieval hits and {len(ic)} "
        f"verified inter loops, equal on cpu ({sc:.1f} s) and cuda ({sg:.2f} s); aligned "
        f"trajectories within {dtraj:.2e} m")
    return {"launches": launches, "report": rep}


def tied_sign(normals, xyz, mask):
    """Points whose viewpoint rule cannot decide the normal's sign."""
    dot = np.abs((normals * xyz).sum(-1))
    return mask & (dot <= 1e-3 * np.linalg.norm(xyz, axis=-1))


def tied_sign_bound(kind, normals, xyz, mask, knn):
    """How far FPFH or SHOT may move through tied-sign normals (the test
    file's rule): SHOT, two counts of 100/valid a tied point; FPFH, four a
    tied neighbour of the centre point, all where the centre's is tied."""
    tied = tied_sign(normals, xyz, mask)
    if kind == "shot":
        return 2 * int(tied.sum()) * 100.0 / max(int(mask.sum()), 1) + 1e-3
    pts = np.where(mask[:, None], xyz, 1e6).astype(np.float64)
    centroid = pts[mask].mean(0)
    c = int(np.argmin(((pts - centroid) ** 2).sum(-1)))
    nbr = np.argsort(((pts - pts[c]) ** 2).sum(-1), kind="stable")[:knn]
    if tied[c]:
        return 600.0
    return 4 * int(tied[nbr].sum()) * 100.0 / max(int((mask[nbr] & (nbr != c)).sum()), 1) + 1e-3


def phase_vector_families(torch, kernels) -> dict:
    """Phase 35: M2DP, GRSD, FPFH and SHOT through ``Mapper.add_frame`` on
    the card at 131,072 raw points (phase 9's dense_world scans), 3
    keyframes each, the ms of a make beside them; then each family's make
    of one of those clouds on the CPU fed the card's k-NN (checked against
    the CPU's exact ranking on 2,048 sampled rows), held to the card's."""
    from scl_slam_tpu_torch import config as C
    from scl_slam_tpu_torch.descriptors import geometric, registry
    from scl_slam_tpu_torch.geometry import se3
    from scl_slam_tpu_torch.io import kitti as kio
    from scl_slam_tpu_torch.ops import pointcloud as pc
    from scl_slam_tpu_torch.runtime import mapper as M

    world = dense_world()
    gt = kio.loop_trajectory(n_frames=16, radius=45.0, laps=2.0)
    n = 131072
    scans = [world.scan_at(gt[k], max_points=n, seed=k) for k in range(3)]
    cloud = pc.from_points(torch.from_numpy(scans[0]).cuda(), n)
    # the card's k-NN of that cloud, checked on sampled rows against the
    # CPU's exact per-coordinate ranking
    pts = torch.where(cloud.mask[:, None], cloud.xyz, pc.PAD_VALUE)
    torch.cuda.synchronize()
    t = time.perf_counter()
    knn_card = pc.knn_indices(pts, 16)
    torch.cuda.synchronize()
    knn_ms = (time.perf_counter() - t) * 1e3
    rows = torch.from_numpy(np.random.RandomState(0).choice(int(cloud.mask.sum()), 2048, replace=False))
    pts_cpu = pts.cpu()
    d2 = ((pts_cpu[rows, None, :] - pts_cpu[None]) ** 2).sum(-1)
    ref = torch.sort(torch.topk(d2, 17, largest=False).indices[:, :16], dim=1).values
    got = torch.sort(knn_card.cpu()[rows], dim=1).values
    clear = (torch.topk(d2, 17, largest=False).values.diff(dim=1)[:, 15] > 0)
    if not torch.equal(got[clear], ref[clear]):
        raise AssertionError("the card's k-NN differs from the CPU's exact ranking")
    log(f"[35] k-NN of a {int(cloud.mask.sum())}-point cloud (131,072 slots, k = 16) on the card: "
        f"{knn_ms:.1f} ms; equal to the CPU's exact ranking on {int(clear.sum())} of 2,048 sampled "
        f"rows without a tie at the 16th")
    cached = {"cpu": knn_card.cpu()}
    out = {}
    for kind in ("m2dp", "grsd", "fpfh", "shot"):
        cfg = C.SlamConfig(descriptor_type=C.DescriptorType(kind),
                           keyframe=C.KeyframeConfig(max_keyframes=64, points_per_keyframe=4096,
                                                     raw_points_capacity=n))
        fam = registry.get_family(cfg)
        m = M.Mapper(cfg)
        kernels.reset_launch_counts()
        make_ms = []
        for k, s in enumerate(scans):
            c = pc.from_points(torch.from_numpy(s).cuda(), n)
            torch.cuda.synchronize()
            t = time.perf_counter()
            fam.make(c)
            torch.cuda.synchronize()
            make_ms.append((time.perf_counter() - t) * 1e3)
            T = gt[k].astype(np.float32)
            if m.add_frame(se3.Pose(T[:3, :3], T[:3, 3]), s, stamp=0.1 * k) is None:
                raise AssertionError(f"{kind}: frame {k} was not a keyframe")
            m.spin_once(now=0.1 * k)
        if int(m.state.desc_db.count) != 3:
            raise AssertionError(f"{kind}: {int(m.state.desc_db.count)} descriptors stored")
        card = m.state.desc_db.descriptors[0].cpu().numpy()
        # the same make on the CPU, fed the card's k-NN
        undos = [patched(mod, "knn_indices", lambda fn: (lambda p, k: cached["cpu"][:, :k]))
                 for mod in (pc, geometric)]
        try:
            t = time.perf_counter()
            cpu = fam.make(pc.Cloud(cloud.xyz.cpu(), cloud.mask.cpu())).descriptor.numpy()
            cpu_s = time.perf_counter() - t
        finally:
            for u in reversed(undos):
                u()
        err = float(np.abs(card - cpu).max())
        l1 = float(np.abs(card - cpu).sum())
        if kind in VECTOR_ATOL:
            bound = VECTOR_ATOL[kind]
            ok = err <= bound
        else:
            normals = pc.estimate_normals(cloud).cpu().numpy()
            bound = tied_sign_bound(kind, normals, cloud.xyz.cpu().numpy(),
                                    cloud.mask.cpu().numpy(), 64 if kind == "fpfh" else 16)
            ok = l1 <= bound
        log(f"[35] {kind}: 3 keyframes through Mapper.add_frame on the card at {n} raw points; a "
            f"make {np.median(make_ms):.1f} ms (median; {[round(x, 1) for x in make_ms]}); card "
            f"against the cpu (fed the card's k-NN, {cpu_s:.1f} s): max {err:.2e}, L1 {l1:.3g} "
            f"(bound {bound:.3g}); launches {dict(kernels.LAUNCHES)}")
        if not ok:
            raise AssertionError(f"{kind}: card and cpu descriptors differ: max {err}, L1 {l1}")
        out[kind] = {"make_ms": float(np.median(make_ms)), "err": err}
        del m
    return out


# ---------------------------------------------------------------------------
# the front end's slice (phases 36-40)
# ---------------------------------------------------------------------------

# the skewed sweeps of tests/test_deskew.py's ATE recovery (2 m a frame
# around a corner of UrbanScene(seed=4)), at the simulator's full 1,800
# azimuths
SWEEP_FRAMES = 18
# ICP odometry on the CPU and on the card from the same scans: K4 is exact,
# but the 6 x 6 normal equations sum in another order (cuBLAS against the
# CPU's BLAS), so a pose moves by f32 roundings a frame, and a frame whose
# update norm lands near tol = 1e-4 may take one more or one fewer
# iteration (a tol-scale step): poses within 1e-3 m and 1e-3 over
# FRONT_CROSS_FRAMES frames
FRONT_CROSS_FRAMES = 8
FRONT_CROSS_ATOL = 1e-3
# phase 40's drive: frames 1 m apart through phase 37's scene (60 before
# phase 44 came: 17.0 s)
SERVE_ODOM_FRAMES = 40


def phase_k4_odometry(torch, kernels) -> dict:
    """Phase 36: K4 at the point-to-plane odometry's shape, 4,096 scan
    points against the 32,768-row map, P = 8 (xyz, validity, normal, pad),
    the map's second half PAD_VALUE rows (a map still filling) and exact
    ties planted as in phase 7: d2 bit-equal, the selection equal; the
    time alone and 20 to a graph, the plain time, the bound and its share,
    the launch geometry and which split it took."""
    nq, nt, P = 4096, 32768, 8
    q, payload, n_grid = k4_inputs(torch, nq, nt, P, seed=36)
    payload[:3, 8192:24576] = 1e6
    payload[3, 8192:24576] = 0.0
    d, sel = kernels.nn_select(q, payload)
    d_p, sel_p = kernels.nn_select_plain(q, payload)
    torch.cuda.synchronize()
    if not torch.equal(d, d_p) or not torch.equal(sel, sel_p):
        raise AssertionError(f"K4 at the odometry shape: d2 differs in {(d != d_p).sum().item()}, "
                             f"the selection in {(sel != sel_p).sum().item()} places")
    on_grid = d[:n_grid] == 1.0
    if int(on_grid.sum()) < 4 or not torch.equal(sel[0, :n_grid][on_grid], q[:n_grid, 0][on_grid] - 1.0):
        raise AssertionError("K4 at the odometry shape: the planted ties did not take the lower index")
    call_ms = time_cuda(torch, lambda: kernels.nn_select(q, payload), reps=50)
    ms = time_graph(torch, lambda: kernels.nn_select(q, payload), reps=50)
    many_ms = time_graph_many(torch, lambda: kernels.nn_select(q, payload))
    plain_ms = time_graph(torch, lambda: kernels.nn_select_plain(q, payload), reps=5)
    bound_ms, bound_by = bound(4 * (nq * 3 + P * nt + nq + P * nq), 9 * nq * nt)
    split = "K4_SPLIT" if nq * nt >= kernels._K4_SMALL_PAIRS else "K4_SPLIT_SMALL"
    log(f"[36] K4 {nq}x{nt} P={P}, half the map pads: d2 bit-equal, selection equal "
        f"({int(on_grid.sum())} planted ties), kernel {ms:.4f} ms ({many_ms:.4f} ms 20 to a graph, "
        f"eager call {call_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}), {100 * bound_ms / ms:.1f}% of it ({100 * bound_ms / many_ms:.1f}% 20 to a "
        f"graph; issue ceiling 50%)")
    log(f"[36]   geometry ({split} = {getattr(kernels, split)}): "
        f"{split_geometry(torch, kernels.k4_geometry(nq, nt), 1, 1)}")
    if bound_ms / ms < 0.25:
        log(f"[36]   under a quarter of its bound at this shape (recorded; no redesign in this slice)")
    return {"max_abs_err": float((sel - sel_p).abs().max().item()), "ms": ms, "many_ms": many_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def skewed_sweeps(device: str = "cuda"):
    """(circuit [SWEEP_FRAMES] 4 x 4, scans): each scan swept from the last
    pose to its own, rendered on ``device`` at 1,800 azimuths."""
    from scl_slam_tpu_torch.io import lidar_sim

    scene = lidar_sim.UrbanScene(seed=4)
    sim = lidar_sim.LidarSim(scene, n_azimuth=1800, device=device)
    circuit = scene.circuit(step=2.0)[:SWEEP_FRAMES]
    return circuit, [sim.scan_at_skewed(circuit[max(k - 1, 0)], circuit[k], seed=100 + k)
                     for k in range(SWEEP_FRAMES)]


def drive_front_end(torch, step, circuit, scans, n=None):
    """Step a front end (``step(k, scan) -> (pose, info)``) over the scans;
    returns (position errors against the circuit in its first frame, ms a
    frame with the card synchronized, poses as 4 x 4)."""
    errs, ms, poses = [], [], []
    for k, scan in enumerate(scans[:n]):
        t = time.perf_counter()
        pose = step(k, scan)
        if pose.t.is_cuda:
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = pose.R.cpu().numpy(), pose.t.cpu().numpy()
        poses.append(T)
        gt_rel = np.linalg.inv(circuit[0]) @ circuit[k]
        errs.append(float(np.linalg.norm(T[:3, 3] - gt_rel[:3, 3])))
    return np.array(errs), np.array(ms), np.stack(poses)


def rms(x) -> float:
    return float(np.sqrt(np.mean(np.square(x))))


def phase_odometry(torch, kernels) -> dict:
    """Phase 37: the ICP odometry at full width (``OdometryConfig``'s
    defaults: map 32,768, scan 4,096, 12 iterations) on the simulator's
    skewed sweeps, tests/test_deskew.py's ATE recovery: ``deskew="const"``
    must beat ``"none"`` by the JAX test's factor 0.7 and land under its
    0.6 m; ms a frame p50/p99 against the 100 ms sensor period, K4
    launches a frame, one frame under torch.profiler (the device's busy
    share; the table goes to chiprun_out/profile_odometry.txt); then the
    first FRONT_CROSS_FRAMES frames on the CPU (plain versions) and on the
    card from the same scans, poses within FRONT_CROSS_ATOL."""
    from scl_slam_tpu_torch.runtime.odometry import Odometry, OdometryConfig

    circuit, scans = skewed_sweeps()
    res = {}
    for deskew in ("none", "const"):
        odo = Odometry(OdometryConfig(deskew=deskew))
        kernels.reset_launch_counts()
        errs, ms, _ = drive_front_end(torch, lambda k, s: odo.step(s)[0], circuit, scans)
        res[deskew] = (rms(errs), ms, kernels.LAUNCHES["nn_select"])
    (ate_raw, _, _), (ate_fix, ms, k4) = res["none"], res["const"]
    pts = [len(s) for s in scans]
    log(f"[37] ICP odometry at the defaults on {len(scans)} skewed sweeps of {min(pts)}-{max(pts)} "
        f"points: ATE {ate_raw:.4f} m (deskew none), {ate_fix:.4f} m (const); const a frame p50 "
        f"{np.percentile(ms, 50):.2f} ms, p99 {np.percentile(ms, 99):.2f} ms, max {ms.max():.2f} ms "
        f"against the 100 ms sensor period (none p50 {np.percentile(res['none'][1], 50):.2f} ms); "
        f"K4 {k4} launches, {k4 / len(scans):.2f} a frame")
    if not (ate_fix < 0.7 * ate_raw and ate_fix < 0.6) or k4 < len(scans):
        raise AssertionError(f"deskew did not recover the ATE ({ate_raw} -> {ate_fix}) or K4 "
                             f"was not launched ({k4})")
    profile_block(torch, "[37]", "one odometry frame (deskew const)",
                  lambda: odo.step(scans[-1]), "profile_odometry.txt")

    runs = {}
    for device in ("cpu", "cuda"):
        o = Odometry(OdometryConfig(deskew="const"), device=device)
        t = time.perf_counter()
        _, _, runs[device] = drive_front_end(torch, lambda k, s: o.step(s)[0], circuit, scans,
                                             FRONT_CROSS_FRAMES)
        runs[device + "_s"] = time.perf_counter() - t
    dt = float(np.abs(runs["cpu"][:, :3, 3] - runs["cuda"][:, :3, 3]).max())
    dR = float(np.abs(runs["cpu"][:, :3, :3] - runs["cuda"][:, :3, :3]).max())
    if dt > FRONT_CROSS_ATOL or dR > FRONT_CROSS_ATOL:
        raise AssertionError(f"odometry cpu/cuda: poses {dt} m, {dR} apart")
    log(f"[37] {FRONT_CROSS_FRAMES} frames on the CPU ({runs['cpu_s']:.1f} s) and the card "
        f"({runs['cuda_s']:.2f} s): poses within {dt:.2e} m, {dR:.2e} (bound {FRONT_CROSS_ATOL})")
    return {"launches": k4, "p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)), "circuit": circuit, "scans": scans}


def _so3_exp(w):
    th = np.linalg.norm(w)
    K = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])
    if th < 1e-12:
        return np.eye(3) + K
    return np.eye(3) + np.sin(th) / th * K + (1 - np.cos(th)) / th**2 * K @ K


def _so3_log(R):
    th = np.arccos(np.clip((np.trace(R) - 1) / 2, -1.0, 1.0))
    u = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return 0.5 * u if th < 1e-9 else th / (2 * np.sin(th)) * u


def consistent_imu(poses, m: int = 20, h: float = 0.005, g: float = 9.81):
    """IMU samples for each interval of ``poses`` (4 x 4, one a frame) that
    the preintegrator's Euler scheme integrates exactly through them, in the
    manner of tests/test_imu_factor.py's simulate: a constant body rate an
    interval; node velocities by central differences; a world acceleration
    linear in the sample index that meets the next position and the next
    velocity. Returns [(accel [m, 3], gyro [m, 3], dt [m])] f32."""
    T = m * h
    p = np.array([P[:3, 3] for P in poses])
    v = np.empty_like(p)
    v[0], v[-1] = (p[1] - p[0]) / T, (p[-1] - p[-2]) / T
    v[1:-1] = (p[2:] - p[:-2]) / (2 * T)
    G = np.array([0.0, 0.0, -g])
    k = np.arange(m)
    # v_m = v_0 + h sum a_k;  p_m = p_0 + T v_0 + h^2 sum a_k (m - k - 1/2)
    A = np.array([[h * m, h * k.sum()],
                  [h * h * np.sum(m - k - 0.5), h * h * np.sum(k * (m - k - 0.5))]])
    out = []
    for i in range(len(poses) - 1):
        R = poses[i][:3, :3].copy()
        w = _so3_log(R.T @ poses[i + 1][:3, :3]) / T
        c = np.linalg.solve(A, np.stack([v[i + 1] - v[i], p[i + 1] - p[i] - T * v[i]]))
        Rd, acc = _so3_exp(w * h), np.empty((m, 3))
        for j in range(m):
            acc[j] = R.T @ (c[0] + c[1] * j - G)
            R = R @ Rd
        out.append((acc.astype(np.float32), np.tile(w, (m, 1)).astype(np.float32),
                    np.full(m, h, np.float32)))
    return out


# phase 38's start from rest: 5 m/s^2 along UrbanScene(seed=4)'s circuit
FROM_REST_ACCEL = 5.0


def from_rest_sweeps():
    """(poses, scans): SWEEP_FRAMES frames 0.1 s apart of a start from rest
    at FROM_REST_ACCEL along the skewed sweeps' circuit (7.2 m, the last
    step 0.83 m), each scan swept from the last pose, 1,800 azimuths."""
    from scl_slam_tpu_torch.io import lidar_sim

    scene = lidar_sim.UrbanScene(seed=4)
    sim = lidar_sim.LidarSim(scene, n_azimuth=1800)
    fine = scene.circuit(step=0.05)
    s = 0.5 * FROM_REST_ACCEL * (0.1 * np.arange(SWEEP_FRAMES)) ** 2
    poses = [fine[int(round(x / 0.05))] for x in s]
    return poses, [sim.scan_at_skewed(poses[max(k - 1, 0)], poses[k], seed=200 + k)
                   for k in range(SWEEP_FRAMES)]


def fused_run(torch, poses, scans):
    """``ImuFusedOdometry(OdometryConfig(deskew="gyro"), window=6,
    max_samples=32)``, the runner's imu mode, over ``scans`` with
    :func:`consistent_imu` of ``poses``: (ATE, ms a frame, each frame's gap
    to its ICP pose, the solves' ms, the front end)."""
    from scl_slam_tpu_torch.runtime.odometry import ImuFusedOdometry, OdometryConfig

    imu = consistent_imu(poses)
    fused = ImuFusedOdometry(OdometryConfig(deskew="gyro"), window=6, max_samples=32)
    acc_ms, gaps = {}, []
    patched(fused.smoother, "solve", timing(torch, acc_ms, "solve"))

    def step(k, scan):
        if k == 0:
            a = g = np.zeros((1, 3), np.float32)
            dt = np.zeros(1, np.float32)
        else:
            a, g, dt = imu[k - 1]
        pose, _, info = fused.step(scan, a, g, dt)
        gaps.append(info.get("smooth_gap", 0.0))
        return pose

    errs, ms, _ = drive_front_end(torch, step, poses, scans)
    return rms(errs), ms, np.array(gaps), np.array(acc_ms["solve"]), fused


def phase_imu_odometry(torch, front: dict) -> None:
    """Phase 38: the IMU-fused front end (``ImuFusedOdometry``, deskew
    "gyro", window 6, 32 samples) at full width, its IMU exact under the
    preintegrator's scheme (:func:`consistent_imu`). On a start from rest
    (:func:`from_rest_sweeps`) the divergence gate must not fire; ms a
    frame p50/p99 and the smoother's solve ms (a synchronize around each).
    Then on phase 37's sweeps at a constant 20 m/s: there the window's
    cold start (its unfilled nodes at rest) pulls the smoothed pose metres
    from the ICP pose on the first frames, in the JAX package as well (on
    the CPU at 360 azimuths its gate fires on frames 1-4, as the port's),
    so the gate must keep the output's ATE under phase 37's 0.6 m; the
    frames where it fired are printed."""
    poses, scans = from_rest_sweeps()
    ate, ms, gaps, solve, fused = fused_run(torch, poses, scans)
    log(f"[38] ImuFusedOdometry (deskew gyro, window 6, 32 samples) from rest at "
        f"{FROM_REST_ACCEL} m/s^2, {len(scans)} sweeps: ATE {ate:.4f} m, largest gap to the ICP "
        f"pose {gaps.max():.4f} m (gate {fused.max_smooth_gap} m); a frame p50 "
        f"{np.percentile(ms, 50):.2f} ms, p99 {np.percentile(ms, 99):.2f} ms; the smoother's "
        f"solve ({len(solve)} solves of 4 GN steps) p50 {np.percentile(solve, 50):.2f} ms, p99 "
        f"{np.percentile(solve, 99):.2f} ms; velocity at the end "
        f"{np.round(fused.smoother.states.v[-1].cpu().numpy(), 3).tolist()}")
    if gaps.max() > fused.max_smooth_gap or not np.isfinite(ate):
        raise AssertionError(f"the divergence gate fired on clean data: gaps {gaps.tolist()}")
    ate2, ms2, gaps2, _, _ = fused_run(torch, front["circuit"], front["scans"])
    fired = [k for k, x in enumerate(gaps2) if x > fused.max_smooth_gap]
    log(f"[38] the same on phase 37's 20 m/s sweeps: ATE {ate2:.4f} m, a frame p50 "
        f"{np.percentile(ms2, 50):.2f} ms; the gate fired on frames {fired} (gaps "
        f"{np.round(gaps2, 3).tolist()})")
    if not ate2 < 0.6:
        raise AssertionError(f"the fused front end at 20 m/s: ATE {ate2}")


# 64 before phase 44 came (the two runs 35.7 s)
RUNNER_FRONT_FRAMES = 48


def phase_runner_front_ends(torch, kernels) -> None:
    """Phase 39: ``python -m scl_slam_tpu_torch.run --dataset synthetic
    --odometry icp`` and ``--odometry imu --deskew gyro`` at the demo's
    widths (32,768-point scans), ``RUNNER_FRONT_FRAMES`` frames (past the
    first lap: the depth cut from the default 120 to make room for phases
    41-44) on
    the card: exit 0, the loops and the ATE printed."""
    import contextlib
    import io

    from scl_slam_tpu_torch import run as R

    for argv in (["--odometry", "icp"], ["--odometry", "imu", "--deskew", "gyro"]):
        buf = io.StringIO()
        kernels.reset_launch_counts()
        with contextlib.redirect_stdout(buf):
            rc = R.main(["--dataset", "synthetic", *argv, "--frames", str(RUNNER_FRONT_FRAMES),
                         "--output",
                         os.path.join(ROOT, "chiprun_out", "run_" + argv[1])])
        report = json.loads(buf.getvalue().strip().splitlines()[-1]) if rc == 0 else {}
        log(f"[39] run --dataset synthetic {' '.join(argv)} -> rc {rc}, {json.dumps(report)}; "
            f"K4 {kernels.LAUNCHES['nn_select']}, K2 {kernels.LAUNCHES['max_image']} launches")
        if rc != 0 or not np.isfinite(report["ate_rmse_m"]) or kernels.LAUNCHES["nn_select"] < 120:
            raise AssertionError(f"run {argv}: rc {rc}, report {report}")


def phase_serve_odometry(torch) -> None:
    """Phase 40: the daemon with ``--odometry icp`` (``--config
    configs/kitti_velodyne.yaml``) answers SERVE_ODOM_FRAMES pose-less
    frames of the simulator at phase 30's 2,048 azimuths with finite
    poses: a drive 1 m a frame through phase 37's scene, its scans
    deskewed (phase 30's own lap turns 90 degrees between two frames,
    which no constant-velocity prediction follows: ATE 21 m on it, the
    daemon and the in-process front end alike). Its ATE against the truth stands
    beside an in-process ``Odometry`` + ``Mapper`` on the card fed the same
    scans, which must take the same keyframes and land within 1e-3 m (the
    solve's atomics); the ATE must be under 0.5 m."""
    from scl_slam_tpu_torch.config import load_config
    from scl_slam_tpu_torch.io import trajectory as tio
    from scl_slam_tpu_torch.runtime import mapper as M
    from scl_slam_tpu_torch.runtime.odometry import Odometry
    from scl_slam_tpu_torch.serve import SlamClient

    from scl_slam_tpu_torch.io import lidar_sim

    scene = lidar_sim.UrbanScene(seed=4)
    sim = lidar_sim.LidarSim(scene, n_azimuth=2048)
    gt = scene.circuit(step=1.0)[:SERVE_ODOM_FRAMES]
    frames = list(range(SERVE_ODOM_FRAMES))
    scans = [sim.scan_at(gt[k], seed=k) for k in frames]
    config = os.path.join(ROOT, "configs", "kitti_velodyne.yaml")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        x for x in (ROOT, os.environ.get("PYTHONPATH")) if x))
    proc = subprocess.Popen(
        [sys.executable, "-m", "scl_slam_tpu_torch.serve", "--port", "0", "--config", config,
         "--odometry", "icp"], cwd=ROOT, env=env, stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        if "serving on :" not in line:
            raise AssertionError(f"the daemon did not start: {line!r}")
        client = SlamClient(port=int(line.rsplit(":", 1)[1]))
        lat, kf, answered = [], [], []
        for j, s in enumerate(scans):
            t = time.perf_counter()
            r = client.frame(s, None, stamp=0.1 * j)
            lat.append((time.perf_counter() - t) * 1e3)
            if "error" in r:
                raise AssertionError(f"the daemon refused a pose-less frame: {r}")
            kf.append(bool(r["keyframe"]))
            answered.append(np.asarray(r["pose"]))
        traj = client.trajectory()["poses"]
        stats = client.stats()
        client.shutdown()
        client.close()
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lat = np.array(lat)
    if rc != 0 or not all(np.isfinite(p).all() for p in answered) or stats["launches"]["nn_select"] < 1:
        raise AssertionError(f"the daemon with --odometry icp: rc {rc}, stats {stats}")
    odo, m = Odometry(), M.Mapper(load_config(config))
    local_kf, odo_poses = [], []
    for j, s in enumerate(scans):
        pose, _ = odo.step(s)
        odo_poses.append(np.concatenate([pose.R.cpu().numpy(), pose.t.cpu().numpy()[:, None]], 1))
        wire = m.add_frame(pose, s, stamp=0.1 * j)
        local_kf.append(wire is not None)
        if wire is not None:
            m.spin_once(now=0.1 * j)
    kf_idx = [k for k, x in zip(frames, kf) if x]
    gt_kf = np.stack([gt[k] for k in kf_idx])
    d = float(np.abs(m.trajectory() - traj).max()) if local_kf == kf else float("inf")
    ate_d, ate_m = tio.ate_rmse(traj, gt_kf), tio.ate_rmse(m.trajectory(), gt_kf)
    log(f"[40] serve --odometry icp --config configs/kitti_velodyne.yaml: {len(scans)} pose-less "
        f"frames, {sum(kf)} keyframes, a request p50 {np.percentile(lat, 50):.2f} ms, p99 "
        f"{np.percentile(lat, 99):.2f} ms; ATE {ate_d:.4f} m (daemon) vs {ate_m:.4f} m (in-process "
        f"Odometry + Mapper), trajectories within {d:.2e} m; the daemon's launches "
        f"{stats['launches']}")
    if local_kf != kf or d > 1e-3 or not ate_d < 0.5:
        raise AssertionError(f"the daemon against in-process: keyframes {kf} vs {local_kf}, {d} m")


NATIVE_FRAMES = 24
NATIVE_TRAJ_ATOL = 1e-4
CONVERSION_ATOL = 2e-6
SHARDED_POSES = (4, 4096)     # robots x pose slots: four_robot_cityscale.yaml
SHARDED_SMALL = (1, 1024)
# timed solves of the 16,384-pose problem: NCCL world 1 (the first warms up), gloo-2
SHARDED_REPS = (2, 1)
FLEET_SHARDED_FRAMES = 16


def write_kitti_tree(root: str, scans, poses) -> list:
    """A KITTI odometry tree under ``root``: sequence 00's scans as float32
    x, y, z, r files, its cam0 poses through a non-trivial Tr calib (the
    layout tests/test_kitti_format.py writes). Returns the .bin paths."""
    seq = os.path.join(root, "sequences", "00")
    os.makedirs(os.path.join(seq, "velodyne"), exist_ok=True)
    os.makedirs(os.path.join(root, "poses"), exist_ok=True)
    Tr = np.eye(4)
    Tr[:3, :3] = [[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]]
    Tr[:3, 3] = [0.05, -0.1, 0.2]
    paths, lines = [], []
    for k, (scan, T) in enumerate(zip(scans, poses)):
        p = os.path.join(seq, "velodyne", f"{k:06d}.bin")
        xyzr = np.concatenate([scan.astype(np.float32), np.zeros((len(scan), 1), np.float32)], 1)
        xyzr.tofile(p)
        paths.append(p)
        cam = Tr @ T @ np.linalg.inv(Tr)
        lines.append(" ".join(f"{v:.9e}" for v in cam[:3, :4].ravel()))
    with open(os.path.join(root, "poses", "00.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(seq, "calib.txt"), "w") as f:
        f.write("Tr: " + " ".join(f"{v:.9e}" for v in Tr[:3, :4].ravel()) + "\n")
    return paths


def phase_native_loader(torch) -> dict:
    """Phase 41: the C++ prefetching loader (``io/native_loader.py``) at
    the KITTI widths: ``NATIVE_FRAMES`` scans of the simulator's urban world
    (2,048 azimuths, up to 131,072 points) written as a KITTI tree under
    chiprun_out/; the loader built from the checkout (build seconds), its
    scans/s at a 131,072-point capacity and each scan bit-equal to the
    Python reader's; ``run --dataset kitti --loader native`` and
    ``--loader python`` on the card: the same keyframes and loops, the
    trajectories within ``NATIVE_TRAJ_ATOL`` (the scans are deleted after,
    the runs' outputs kept); then the Euler and
    quaternion conversions on the card against the CPU within
    ``CONVERSION_ATOL``."""
    import io
    import shutil

    from scl_slam_tpu_torch import bench_quality as bq
    from scl_slam_tpu_torch import run as trun
    from scl_slam_tpu_torch.geometry import se3, so3
    from scl_slam_tpu_torch.io import kitti as kio
    from scl_slam_tpu_torch.io import native_loader

    scene, sim, _ = anchor_world(2048, "cuda")
    gt = bq.build_gt(scene, (0.0, 0.0))
    frames = list(range(0, 2 * NATIVE_FRAMES, 2))
    root = os.path.join(ROOT, "chiprun_out", "kitti_native")
    shutil.rmtree(root, ignore_errors=True)
    paths = write_kitti_tree(root, [sim.scan_at(gt[k], seed=k) for k in frames],
                             [np.asarray(gt[k], np.float64) for k in frames])
    t = time.perf_counter()
    lib = native_loader.build()
    build_s = time.perf_counter() - t
    loader = native_loader.NativeScanLoader(paths, capacity=131072)
    t = time.perf_counter()
    loaded = list(loader)
    read_s = time.perf_counter() - t
    loader.close()
    for (xyz, n), p in zip(loaded, paths):
        ref = kio.read_velodyne_bin(p)
        if n != len(ref) or not np.array_equal(xyz[:n], ref) or not (xyz[n:] == 1e6).all():
            raise AssertionError(f"the native loader's scan of {p} differs from the Python reader's")
    points = sum(n for _, n in loaded)
    log(f"[41] native loader {lib.name} built in {build_s:.2f} s; {len(paths)} scans "
        f"({points} points, up to {max(n for _, n in loaded)}) in {read_s * 1e3:.1f} ms: "
        f"{len(paths) / read_s:.1f} scans/s at capacity 131,072, each bit-equal to the Python reader")
    reports, trajs = {}, {}
    for which in ("native", "python"):
        out = os.path.join(root, f"run_{which}")
        buf = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = trun.main(["--dataset", "kitti", "--root", root, "--sequence", "00",
                            "--frames", str(len(frames)), "--output", out, "--loader", which,
                            "--no-figure"])
        wall = time.perf_counter() - t
        if rc != 0:
            raise AssertionError(f"run --loader {which} exited {rc}")
        reports[which] = json.loads(buf.getvalue().strip().splitlines()[-1])
        trajs[which] = np.loadtxt(os.path.join(out, "a_kitti.txt"))
        log(f"[41] run --dataset kitti --loader {which}: {json.dumps(reports[which])} "
            f"({wall:.1f} s in all)")
    nat, py = reports["native"], reports["python"]
    gap = float(np.abs(trajs["native"] - trajs["python"]).max())
    if (nat["keyframes"] != py["keyframes"] or nat["loops_closed"] != py["loops_closed"]
            or trajs["native"].shape != trajs["python"].shape or gap > NATIVE_TRAJ_ATOL
            or nat["device"] != torch.cuda.get_device_name(0)):
        raise AssertionError(f"--loader native and python part: {nat} vs {py}, gap {gap}")
    log(f"[41] native and python loading: {nat['keyframes']} keyframes, "
        f"{nat['loops_closed']} loops each, trajectories {gap:.3g} m apart")
    # the scans (~47 MB) are not brought back; the runs' outputs are
    shutil.rmtree(os.path.join(root, "sequences"))
    # the conversions on the card against the CPU
    rng = np.random.RandomState(41)
    rpy = rng.uniform(-np.pi, np.pi, (4096, 3)).astype(np.float32)
    rpy[:, 1] /= 2.0
    rpy[:4, 1] = [np.pi / 2, -np.pi / 2, np.pi / 2 - 1e-4, 0.0]
    q = rng.normal(size=(4096, 4)).astype(np.float32)
    x6 = np.concatenate([rng.uniform(-50, 50, (4096, 3)).astype(np.float32), rpy], 1)
    # every conversion takes the same f32 inputs on both devices (one
    # matrix made on the CPU): near pitch +-pi/2 the angles read two
    # roundings of R, so the devices' own from_euler would part there
    R_np = so3.from_euler(torch.from_numpy(rpy)).numpy()
    worst = 0.0
    for dev in ("cpu", "cuda"):
        R = torch.from_numpy(R_np).to(dev)
        outs = [so3.to_euler(R), so3.from_euler(torch.from_numpy(rpy).to(dev)),
                so3.quat_to_matrix(torch.from_numpy(q).to(dev)), so3.matrix_to_quat(R),
                se3.from_xyzrpy(torch.from_numpy(x6).to(dev)).R,
                se3.to_xyzrpy(se3.Pose(R, torch.from_numpy(x6[:, :3]).to(dev))),
                se3.to_quat_trans(se3.Pose(R, torch.from_numpy(x6[:, :3]).to(dev)))[0]]
        if dev == "cpu":
            ref = [o.numpy() for o in outs]
        else:
            for o, r in zip(outs, ref):
                worst = max(worst, float(np.abs(o.cpu().numpy() - r).max()))
    if worst > CONVERSION_ATOL:
        raise AssertionError(f"the conversions on the card differ from the CPU by {worst}")
    log(f"[41] Euler/quaternion conversions, 4,096 rotations: card against CPU within {worst:.3g}")
    return {"build_s": build_s, "scans_per_s": len(paths) / read_s}


def solve_problem(robots: int, per: int, seed: int = 42):
    """A pose graph of ``robots`` blocks of ``per`` poses (the city-scale
    layout: robot r's keyframes in slots [r per, (r + 1) per)): each robot
    drives two laps of a 60 m circle with noisy odometry (a prior on its
    first pose), with loop factors from its second lap to its first and
    between robots on the shared circuit. The start is the ground truth
    with every pose moved by 2e-3 rad and 5 cm at random: what a drain
    solves from, the estimate of the last solve and new factors (from dead
    reckoning over 4,096 poses, 10 x 96 steps do not converge the f32
    problem, and two reduction orders part by ~1e-2 m). Returns (graph
    arrays at twice the slots' edge capacity, the start's R, t) as numpy."""
    rng = np.random.RandomState(seed)
    n = robots * per
    E, P = 2 * n, 8
    half = per // 2
    gt = np.zeros((n, 4, 4))
    for r in range(robots):
        a = 2 * np.pi * (np.arange(per) % half) / half + 0.3 * r
        gt[r * per:(r + 1) * per, :3, :3] = [rot(np.array([0, 0, x + np.pi / 2])) for x in a]
        gt[r * per:(r + 1) * per, :3, 3] = np.stack(
            [60 * np.cos(a), 60 * np.sin(a), 0.5 * r + 0.2 * np.sin(3 * a)], -1)
        gt[r * per:(r + 1) * per, 3, 3] = 1.0
    ii, jj, Z, si = [], [], [], []

    def factor(i, j, z, s):
        ii.append(i), jj.append(j), Z.append(z), si.append(s)

    for r in range(robots):
        for k in range(r * per, (r + 1) * per - 1):
            noise = np.eye(4)
            noise[:3, :3], noise[:3, 3] = rot(rng.normal(0, 3e-4, 3)), rng.normal(0, 5e-3, 3)
            z = np.linalg.inv(gt[k]) @ gt[k + 1] @ noise
            factor(k, k + 1, z, [1.0 / 3e-4] * 3 + [1.0 / 5e-3] * 3)
        for a in range(0, half, 16):        # the second lap back to the first
            factor(r * per + a, r * per + a + half,
                   np.linalg.inv(gt[r * per + a]) @ gt[r * per + a + half], [100.0] * 6)
        if r:                               # onto the previous robot's circuit
            for a in range(0, per, 64):
                b = (r - 1) * per + a
                factor(b, r * per + a, np.linalg.inv(gt[b]) @ gt[r * per + a], [30.0] * 6)
    m = len(ii)
    Z = np.stack(Z).astype(np.float32)
    eye = np.tile(np.eye(3, dtype=np.float32), (E, 1, 1))
    g = {"i": np.zeros(E, np.int32), "j": np.zeros(E, np.int32), "z.R": eye,
         "z.t": np.zeros((E, 3), np.float32), "sqrt_info": np.zeros((E, 6), np.float32),
         "num_edges": np.int32(m), "prior_idx": np.zeros(P, np.int32),
         "prior_z.R": np.tile(np.eye(3, dtype=np.float32), (P, 1, 1)),
         "prior_z.t": np.zeros((P, 3), np.float32), "prior_sqrt_info": np.zeros((P, 6), np.float32),
         "num_priors": np.int32(robots)}
    g["i"][:m], g["j"][:m] = ii, jj
    g["z.R"][:m], g["z.t"][:m], g["sqrt_info"][:m] = Z[:, :3, :3], Z[:, :3, 3], si
    X = gt.copy()
    for k in range(n):
        X[k, :3, :3] = gt[k, :3, :3] @ rot(rng.normal(0, 2e-3, 3))
        X[k, :3, 3] += rng.normal(0, 0.05, 3)
    for r in range(robots):
        g["prior_idx"][r] = r * per
        g["prior_z.R"][r], g["prior_z.t"][r] = gt[r * per][:3, :3], gt[r * per][:3, 3]
        g["prior_sqrt_info"][r] = 1000.0
    return g, X[:, :3, :3].astype(np.float32), X[:, :3, 3].astype(np.float32)


def sharded_solve_kwargs():
    """four_robot_cityscale.yaml's mesh-drain settings."""
    return dict(gn_iters=10, cg_iters=96, damping=1e-6, gamma=1.0,
                rotation_change_threshold=0.0, pose_change_threshold=0.0,
                coarse_stride=32, coarse_levels=1)


def rank_solves(rank: int, world: int, problems) -> list:
    """Phase 42 in each rank: ``sharded_solve`` of each (graph arrays, R0,
    t0, device, timed reps) over the default group; returns per problem
    the last rep's R and t, every rep's t and chi2 history, ms a solve,
    all-reduces, their bytes and broadcasts a solve, and each rep's
    breakdown in words."""
    import torch

    from scl_slam_tpu_torch.geometry import se3
    from scl_slam_tpu_torch.graph import factors as F
    from scl_slam_tpu_torch.graph import solver
    from scl_slam_tpu_torch.parallel import sharded

    out = []
    for g_np, R0, t0, dev, reps in problems:
        t = {k: torch.from_numpy(np.array(v)).to(dev) for k, v in g_np.items()}
        g = F.FactorGraph(t["i"], t["j"], se3.Pose(t["z.R"], t["z.t"]), t["sqrt_info"],
                          t["num_edges"], t["prior_idx"], se3.Pose(t["prior_z.R"], t["prior_z.t"]),
                          t["prior_sqrt_info"], t["num_priors"])
        init = se3.Pose(torch.from_numpy(R0).to(dev), torch.from_numpy(t0).to(dev))
        res = {"ms": [], "ts": [], "chis": [], "codes": []}
        for _ in range(reps):
            sharded.reset_counts()
            if dev == "cuda":
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            poses, chis, code = sharded.sharded_solve(None, g, init, **sharded_solve_kwargs())
            if dev == "cuda":
                torch.cuda.synchronize()
            res["ms"].append((time.perf_counter() - t1) * 1e3)
            res["ts"].append(poses.t.cpu().numpy())
            res["chis"].append(chis.cpu().numpy())
            res["codes"].append(solver.breakdown_stages(int(code)))
        res.update(R=poses.R.cpu().numpy(), t=res["ts"][-1], chi2=res["chis"][-1],
                   all_reduce=sharded.COUNTS["all_reduce"],
                   bytes=sharded.COUNTS["all_reduce_bytes"],
                   broadcast=sharded.COUNTS["broadcast"])
        out.append(res)
    return out


# Two reduction orders of one f32 solve part along the chain's smooth
# modes, which its chi2 barely sees: measured on the CPU between world
# sizes 1 and 2 (gloo) from solve_problem's start, 3.4e-3 m at 16,384
# poses (6.3e-4 m at 1,024), the final chi2 3e-5 (5e-5) relative, and the
# chi2 after the first step 2.4e-2 (8.1e-2). On an H100 80GB HBM3 at
# 700 W, over a dozen runs (PERF.md): NCCL against gloo 2.4e-4 to 5.5e-3
# m, the gloo solves among themselves up to 5.1e-3 m, 1,024 poses card
# against CPU 6.8e-5 to 2.4e-4 m, every chi2 history within 1.2e-2 to
# 6.5e-2 relative, the final chi2 within 1.3e-4.
SHARDED_T_ATOL = 1e-2          # m, 16,384 poses
SHARDED_SMALL_T_ATOL = 1e-3    # m, 1,024 poses
SHARDED_CHI2_RTOL = 1.2e-1     # the history
SHARDED_FINAL_RTOL = 1e-3      # the final chi2


def rank_distributed(rank: int, world: int, problems, fleet_frames: int) -> dict:
    """Phases 42-43 in each rank, one process group a world (a spawn costs
    15-25 s of process start and CUDA set-up): the solves of ``rank_solves``,
    the dry run's parts A-D (``parallel/dryrun.rank_dryrun``) and, where
    ``fleet_frames``, the sharded fleet session."""
    from scl_slam_tpu_torch.parallel import dryrun

    out = {"solves": rank_solves(rank, world, problems)}
    t = time.perf_counter()
    out["dryrun"] = dryrun.rank_dryrun(rank, world, "cuda")
    out["dryrun_s"] = time.perf_counter() - t
    if fleet_frames:
        out["fleet"] = rank_fleet_session(rank, world, fleet_frames)
    return out


DISTRIBUTED: dict = {}   # phase 42's spawns, read by phase 43


def phase_sharded_solve(torch) -> dict:
    """Phase 42: ``parallel/sharded.sharded_solve`` at the city-scale widths
    (``SHARDED_POSES``: 16,384 pose slots, 32,768 edges, coarse stride 32
    so a [3,072, 3,072] dense coarse Cholesky, 96 PCG steps, 10
    Gauss-Newton steps) in a world of size 1 over NCCL and in two ranks
    sharing the card over gloo: the final poses and chi2 histories held
    against each other (``SHARDED_T_ATOL``, ``SHARDED_CHI2_RTOL``,
    ``SHARDED_FINAL_RTOL``: each rank's sums come back through all-reduce
    in another grouping, and the card's scatter-sums run in varying order),
    beside the spread of two NCCL solves of one problem (the first warms
    up; the gloo ranks solve once); a 1,024-pose problem in the same ranks on the card, held against
    the CPU's (world 1, gloo for CPU tensors) within
    ``SHARDED_SMALL_T_ATOL``; ms a solve, all-reduces and broadcasts a
    solve. The same worlds then run phase 43's dry run and fleet session
    (``rank_distributed``), whose checks phase 43 makes."""
    from scl_slam_tpu_torch.parallel import multihost

    import tempfile

    big = solve_problem(*SHARDED_POSES)
    small = solve_problem(*SHARDED_SMALL, seed=7)
    # the world of size 1 is this process (a spawn costs ~15-25 s): its
    # group is left before the gloo ranks start
    t = time.perf_counter()
    multihost.init(f"file://{tempfile.mkdtemp(prefix='nccl_')}/store", 1, 0,
                   backend="cpu:gloo,cuda:nccl", device="cuda")
    try:
        nccl = [rank_distributed(0, 1, [(*big, "cuda", SHARDED_REPS[0]), (*small, "cuda", 1),
                                        (*small, "cpu", 1)], 0)]
    finally:
        multihost.shutdown()
    t_nccl = time.perf_counter() - t
    t = time.perf_counter()
    # the gloo ranks' CPU side would repeat the CPU reference: left out
    gloo = multihost.spawn(rank_distributed, 2,
                           ([(*big, "cuda", SHARDED_REPS[1]), (*small, "cuda", 1)],
                            FLEET_SHARDED_FRAMES),
                           device="cuda", backend="gloo")
    t_gloo = time.perf_counter() - t
    DISTRIBUTED.update(nccl=nccl, gloo=gloo)
    log(f"[42] the worlds of phases 42-43: NCCL world 1 (this process) {t_nccl:.1f} s, two "
        f"spawned gloo ranks {t_gloo:.1f} s, start to exit")
    nccl = [o["solves"] for o in nccl]
    gloo = [o["solves"] for o in gloo]
    for name, outs in (("nccl-1", nccl), ("gloo-2", gloo)):
        r = outs[0][0]
        for tt, chis, code in zip(r["ts"], r["chis"], r["codes"]):
            if not (np.isfinite(tt).all() and np.isfinite(chis).all()) or code:
                raise AssertionError(f"{name}: the 16,384-pose solve broke down: {code}, chi2 "
                                     f"{chis.tolist()}, {int((~np.isfinite(tt)).any(-1).sum())} "
                                     f"poses non-finite")
            if not chis[-1] < 1e-2 * chis[0]:
                raise AssertionError(f"{name}: chi2 {chis[0]} -> {chis[-1]} did not fall")
        spread = max(float(np.abs(x - y).max()) for x in r["ts"] for y in r["ts"])
        log(f"[42] sharded_solve {name}, 16,384 poses, {int(big[0]['num_edges'])} edges: ms a "
            f"solve {[round(x, 1) for x in r['ms']]} (the first warm), {r['all_reduce']} "
            f"all-reduces ({r['bytes'] / 1e6:.1f} MB) and {r['broadcast']} broadcasts a solve, "
            f"chi2 {r['chi2'][0]:.6g} -> {r['chi2'][-1]:.6g}, its solves up to {spread:.3g} m "
            f"apart; 1,024 poses on the card {outs[0][1]['ms'][0]:.1f} ms")
    for r in gloo[1:]:   # the ranks hold one result
        for key in ("R", "t", "chi2"):
            if not np.array_equal(r[0][key], gloo[0][0][key]):
                raise AssertionError("gloo-2: the ranks' solves differ")
    # every NCCL solve against every gloo one
    pairs = [(t1, c1, t2, c2) for t1, c1 in zip(nccl[0][0]["ts"], nccl[0][0]["chis"])
             for t2, c2 in zip(gloo[0][0]["ts"], gloo[0][0]["chis"])]
    gap_t = max(float(np.abs(t1 - t2).max()) for t1, _, t2, _ in pairs)
    gap_c = max(float(np.abs(c1 / c2 - 1).max()) for _, c1, _, c2 in pairs)
    gap_f = max(float(abs(c1[-1] / c2[-1] - 1)) for _, c1, _, c2 in pairs)
    gap_R = float(np.abs(nccl[0][0]["R"] - gloo[0][0]["R"]).max())
    log(f"[42] nccl-1 against gloo-2 at 16,384 poses ({len(pairs)} pairs of solves): t "
        f"{gap_t:.3g} m, R {gap_R:.3g} (the last of each), chi2 history {gap_c:.3g}, final "
        f"{gap_f:.3g} relative")
    if not (gap_t <= SHARDED_T_ATOL and gap_c <= SHARDED_CHI2_RTOL and gap_f <= SHARDED_FINAL_RTOL):
        raise AssertionError("the NCCL and gloo solves part beyond the stated tolerance")
    cpu = nccl[0][2]
    log(f"[42] 1,024 poses on the CPU (world 1, gloo) {cpu['ms'][0]:.1f} ms")
    for name, outs in (("nccl-1", nccl), ("gloo-2", gloo)):
        card = outs[0][1]
        g_t = float(np.abs(card["t"] - cpu["t"]).max())
        g_c = float(np.abs(card["chi2"] / cpu["chi2"] - 1).max())
        g_f = float(abs(card["chi2"][-1] / cpu["chi2"][-1] - 1))
        log(f"[42] {name} 1,024 poses, card against CPU: t {g_t:.3g} m, chi2 history "
            f"{g_c:.3g}, final {g_f:.3g} relative")
        if card["codes"][0] or cpu["codes"][0] or not (
                g_t <= SHARDED_SMALL_T_ATOL and g_c <= SHARDED_CHI2_RTOL
                and g_f <= SHARDED_FINAL_RTOL):
            raise AssertionError(f"{name}: the 1,024-pose solve parts from the CPU's "
                                 f"{card['codes']}")
    return {"nccl_ms": nccl[0][0]["ms"][1:], "gloo_ms": gloo[0][0]["ms"][1:],
            "all_reduces": nccl[0][0]["all_reduce"]}


def rank_fleet_session(rank: int, world: int, frames: int) -> dict:
    """Phase 43's fleet in each rank: run_multi --fleet's loop at
    four_robot_cityscale.yaml's widths on the synthetic sequence of phase
    27, ``frames`` frames, once with the DB sharded and the drain on the
    mesh and once with the whole DB and the same mesh drain. One drain, at
    the end (the throttled drains of ``spin`` are cut), with the
    configuration's prior; then the same drain again from the state
    before it with the tight prior ``TIGHT_PRIOR_SQRT_INFO`` on the
    robots' first poses. Returns each run's counts, loops, loop queue,
    graph and trajectories before the drain, each drain's chi2 history,
    breakdowns and trajectories after it, launches and wall seconds."""
    import argparse
    import dataclasses

    import torch

    from scl_slam_tpu_torch import run_multi
    from scl_slam_tpu_torch.config import load_config
    from scl_slam_tpu_torch.ops import kernels
    from scl_slam_tpu_torch.parallel import multihost
    from scl_slam_tpu_torch.runtime import FleetMapper

    mesh = multihost.make_mesh(("shard",))
    cfg = load_config(os.path.join(ROOT, "configs", "four_robot_cityscale.yaml"))
    cfg = dataclasses.replace(cfg, number_of_robots=4, robot_id=0, robot_name="a")
    args = argparse.Namespace(dataset="synthetic", frames=frames, root=None)
    get_scan, get_pose, n = run_multi.build_dataset(args)
    splits = run_multi.make_splits(n, 4, 10)
    scans = {k: get_scan(k) for k in range(n)}
    out = {}
    for which, shard in (("sharded", True), ("whole", False)):
        fleet = FleetMapper(cfg, device="cuda")
        if shard:
            fleet.shard_database(mesh)
        fleet.attach_mesh(mesh)
        kernels.reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        intra = inter = 0
        for step in range(max(len(s) for s in splits)):
            for r in range(4):
                if step < len(splits[r]):
                    k = splits[r][step]
                    fleet.add_robot_frame(r, run_multi.pose_of(get_pose(k)), scans[k],
                                          stamp=0.1 * k)
            for ev in fleet.step():
                intra += "loop" in ev
                inter += "inter_loop" in ev
        q = fleet.state.loop_queue
        c = int(q.count)
        queue = (q.i[:c].cpu().numpy(), q.j[:c].cpu().numpy(), q.z_t[:c].cpu().numpy())
        before = [fleet.trajectory(robot=r) for r in range(4)]
        # the drain writes its factors into the graph in place
        snap = fleet.state._replace(graph=type(fleet.state.graph)(*[
            x.clone() if torch.is_tensor(x) else se3_clone(x) for x in fleet.state.graph]))
        drains = {}
        for prior in ("config", "tight"):
            if prior == "tight":
                g = snap.graph
                fleet.state = snap._replace(graph=g._replace(
                    prior_sqrt_info=torch.full_like(g.prior_sqrt_info, TIGHT_PRIOR_SQRT_INFO)))
            torch.cuda.synchronize()
            t_solve = time.perf_counter()
            chi2 = fleet.optimize()
            torch.cuda.synchronize()
            drains[prior] = {
                "solve_s": time.perf_counter() - t_solve, "chi2": chi2,
                "traj": [fleet.trajectory(robot=r) for r in range(4)],
                "broken": fleet.broken_drains, "breakdowns": list(fleet.solve_breakdowns),
            }
            if prior == "config":
                wall = time.perf_counter() - t
                launches = dict(kernels.LAUNCHES)
        out[which] = {
            "wall_s": wall, "intra": intra, "inter": inter,
            "counts": [int(x) for x in fleet.state.counts], "queue": queue,
            "edges": int(fleet.state.graph.num_edges), "before": before, "drains": drains,
            "launches": launches, "local_rows": int(fleet.state.desc_db.index.shape[0]),
        }
    return out


def se3_clone(p):
    """A copy of an ``se3.Pose``'s tensors."""
    return type(p)(*[x.clone() for x in p])


# The sharded fleet against the whole-DB one on the card: the loop
# factors' z (ICP and RANSAC over the card's sums) and the trajectories
# before the drain; after the drain, with the configuration's prior
# (translation sigma 1e4 m, yaw pi: the gauge nearly free, so f32 solves
# of one graph part along it), within FLEET_DRAIN_ATOL and the final chi2
# within FLEET_DRAIN_CHI2_RTOL, and with a tight prior on each robot's
# first pose (the gauge fixed) within FLEET_TIGHT_ATOL. Measured from the
# state before the drain, f32: on the CPU in 9 edge orders, the
# configuration's prior 0.28-0.33 final chi2 (f64: 0.050-0.052), the
# trajectories up to 2.45e-2 m apart; on an H100 80GB HBM3 (PERF.md)
# in 8 orders over NCCL 0.277-0.322 and up to 3.46e-2 m apart, the
# sharded fleet against the whole-DB one 2.71e-2 m and 2.9e-2 relative;
# the tight prior 1e-5 m apart on the CPU, 1.14e-5 m on the card.
FLEET_Z_ATOL = 1e-2
FLEET_TRAJ_ATOL = 1e-3
FLEET_DRAIN_ATOL = 7e-2
FLEET_DRAIN_CHI2_RTOL = 0.4
FLEET_TIGHT_ATOL = 2e-4
TIGHT_PRIOR_SQRT_INFO = 1e3


def phase_distributed(torch) -> dict:
    """Phase 43, from phase 42's spawns: ``parallel/dryrun``'s parts A-D
    (the sharded DB and the mesh drain, peer ingest and replay, eviction, a
    2-robot fleet step, each held against a whole-DB run in the rank) in
    two ranks over gloo and in one over NCCL (``dryrun_multichip``'s runs,
    its ranks held by ``dryrun.hold_ranks``); then the ``FleetMapper`` at
    four_robot_cityscale.yaml's widths (16,384 DB rows, 8,192 a rank) with
    ``shard_database`` and ``attach_mesh`` over the two gloo ranks on phase
    27's scene for ``FLEET_SHARDED_FRAMES`` frames, against the whole-DB
    fleet with the same mesh drain: the same counts, loops and loop queue
    (its z_t within ``FLEET_Z_ATOL``), the same edges, the trajectories
    before the drain within ``FLEET_TRAJ_ATOL``; each fleet's drain, with
    the configuration's prior and again with a tight one, must not break
    down and must bring the chi2 below 5% of its start, and the two
    fleets' trajectories after it must agree within ``FLEET_DRAIN_ATOL``
    (the final chi2 within ``FLEET_DRAIN_CHI2_RTOL``) and
    ``FLEET_TIGHT_ATOL``; the two ranks' bit-equal; K1, K2 and K6
    launches and wall seconds."""
    from scl_slam_tpu_torch.parallel import dryrun

    for name, outs in (("2 x gloo", DISTRIBUTED["gloo"]), ("1 x nccl", DISTRIBUTED["nccl"])):
        runs = [o["dryrun"] for o in outs]
        dryrun.hold_ranks(runs)
        o = runs[0]
        if min(o["launches"]["max_image"], o["launches"]["nn_select"],
               o["launches"]["nn_select_batched"], o["launches"]["ransac_counts_batched"]) < 1:
            raise AssertionError(f"dry run {name}: a kernel was not launched: {o['launches']}")
        log(f"[43] dry run {name} ({outs[0]['dryrun_s']:.1f} s in the rank): A {o['A']['loops']} "
            f"loops, chi2 {o['A']['chi2'][0]:.4g} -> {o['A']['chi2'][-1]:.4g}; B {o['B']}; "
            f"C {o['C']}; D {o['D']}; rank 0 launches {o['launches']}")

    def gap(a, b):
        """The largest translation gap between two fleets' trajectories."""
        return max(float(np.abs(x[:, :3, 3] - y[:, :3, 3]).max()) for x, y in zip(a, b) if len(x))

    outs = [o["fleet"] for o in DISTRIBUTED["gloo"]]
    for o in outs:
        sh, wh = o["sharded"], o["whole"]
        for key in ("counts", "edges", "intra", "inter"):
            if sh[key] != wh[key]:
                raise AssertionError(f"the sharded fleet's {key} {sh[key]} vs {wh[key]}")
        for a, b in zip(sh["queue"][:2], wh["queue"][:2]):
            if not np.array_equal(a, b):
                raise AssertionError("the sharded fleet's loop queue differs")
        z_gap = float(np.abs(sh["queue"][2] - wh["queue"][2]).max()) if len(sh["queue"][2]) else 0.0
        before = gap(sh["before"], wh["before"])
        if not (z_gap <= FLEET_Z_ATOL and before <= FLEET_TRAJ_ATOL) or sh["local_rows"] != 8192:
            raise AssertionError(f"the sharded fleet parts from the whole-DB one: z {z_gap} m, "
                                 f"trajectories before the drain {before} m, local rows "
                                 f"{sh['local_rows']}")
        for prior, atol in (("config", FLEET_DRAIN_ATOL), ("tight", FLEET_TIGHT_ATOL)):
            ds, dw = sh["drains"][prior], wh["drains"][prior]
            for name, d in (("sharded", ds), ("whole", dw)):
                finite = all(np.isfinite(x).all() for x in d["traj"]) and np.isfinite(d["chi2"]).all()
                if d["broken"] or d["breakdowns"] or not finite:
                    raise AssertionError(f"the {name} fleet's drain ({prior} prior) broke down: "
                                         f"{d['breakdowns']}, chi2 {d['chi2'].tolist()}")
                if not d["chi2"][-1] < 0.05 * d["chi2"][0]:
                    raise AssertionError(f"the {name} fleet's drain ({prior} prior): chi2 "
                                         f"{d['chi2'][0]} -> {d['chi2'][-1]}")
            apart = gap(ds["traj"], dw["traj"])
            rel = abs(float(ds["chi2"][-1]) / float(dw["chi2"][-1]) - 1)
            if not (apart <= atol and (prior == "tight" or rel <= FLEET_DRAIN_CHI2_RTOL)):
                raise AssertionError(f"after the drain ({prior} prior) the sharded fleet parts "
                                     f"from the whole-DB one by {apart} m, final chi2 {rel} relative")
            ds["gap"], ds["rel"] = apart, rel
        for key in ("max_image", "nn_select_batched", "ransac_counts_batched"):
            if sh["launches"][key] < 1:
                raise AssertionError(f"the sharded fleet launched no {key}")
    for prior in ("config", "tight"):
        rank_raw = gap(outs[0]["sharded"]["drains"][prior]["traj"],
                       outs[1]["sharded"]["drains"][prior]["traj"])
        if rank_raw != 0.0:
            raise AssertionError(f"the ranks' sharded fleets part by {rank_raw} m ({prior} prior)")
    sh, wh = outs[0]["sharded"], outs[0]["whole"]
    log(f"[43] sharded fleet, 2 ranks x 8,192 DB rows, {FLEET_SHARDED_FRAMES} frames: "
        f"{sh['intra']} intra + {sh['inter']} inter loops, counts {sh['counts'][:4]}, queue "
        f"{len(sh['queue'][0])} (z_t {z_gap:.3g} m from the whole-DB run's), {sh['edges']} "
        f"edges; wall {sh['wall_s']:.1f} s sharded, {wh['wall_s']:.1f} s whole (the drive and "
        f"one drain); launches K1 {sh['launches']['nn_select_batched']} K2 "
        f"{sh['launches']['max_image']} K6 {sh['launches']['ransac_counts_batched']}; "
        f"sharded against whole before the drain {before:.3g} m; the ranks bit-equal")
    for prior in ("config", "tight"):
        ds, dw = sh["drains"][prior], wh["drains"][prior]
        log(f"[43] the drain, {prior} prior: chi2 {ds['chi2'][0]:.6g} -> {ds['chi2'][-1]:.6g} "
            f"sharded ({ds['solve_s']:.2f} s), {dw['chi2'][0]:.6g} -> {dw['chi2'][-1]:.6g} "
            f"whole ({dw['solve_s']:.2f} s); no breakdown; sharded against whole {ds['gap']:.3g} "
            f"m, final chi2 {ds['rel']:.3g} relative")
    return {"launches": sh["launches"], "wall_s": sh["wall_s"]}


def phase_input_modes(torch, kernels, bench: BenchReplay, anchor: dict) -> dict:
    """Phase 44: the replay's input modes on the card (see the module
    docstring)."""
    from scl_slam_tpu_torch import bench_quality as bq
    from scl_slam_tpu_torch.runtime import mapper as M

    modes = {"f32": {}, "int16": {"transfer": "int16"}, "host": {"host_descriptors": True}}
    runs = {k: [] for k in modes}
    launches = {k: {} for k in modes}
    last = {}
    for turn in range(3):
        order = list(modes) if turn % 2 == 0 else list(modes)[::-1]
        for name in order:
            kernels.reset_launch_counts()
            m, out, sec = bench.run(**modes[name])
            for k, v in kernels.LAUNCHES.items():
                launches[name][k] = launches[name].get(k, 0) + v
            bench.check_state(m, out)
            runs[name].append(bench.n / sec)
            last[name] = m
    desc = {k: last[k].state.desc_db.descriptors[: bench.n].cpu().numpy() for k in modes}
    res = {}
    for name in modes:
        chunk = last[name].last_replay["chunks"][0]
        k1, k2 = launches[name]["nn_select_batched"], launches[name]["max_image"]
        if k1 < 3 or k2 != (0 if name == "host" else 3 * bench.R):
            raise AssertionError(f"replay under {name}: K1 {k1}, K2 {k2} in 3 runs")
        res[name] = {"fps": runs[name], "h2d_bytes": chunk["h2d_bytes"], "k1": k1, "k2": k2,
                     "bin_ms": chunk["bin_ms"]}
        log(f"[44] replay {name}: frames/s {', '.join(f'{x:.2f}' for x in runs[name])} (median "
            f"{float(np.median(runs[name])):.2f}); {chunk['h2d_bytes']:,} bytes to the card a "
            f"chunk of {bench.n}; K1 {k1}, K2 {k2} in 3 runs; host binning "
            f"{chunk['bin_ms']:.1f} ms; state checks ok")
    if res["f32"]["h2d_bytes"] - res["int16"]["h2d_bytes"] != 6 * bench.n * bench.n_pts:
        raise AssertionError(f"int16 did not halve the scans' 12 bytes a point: {res}")
    bins = (np.abs(desc["host"] - desc["f32"]) > 1e-5).reshape(bench.n // 4, -1).sum(axis=1)
    if bins.max() > HOST_IMAGE_BINS:
        raise AssertionError(f"host images against K2's: {int(bins.max())} bins in 4 frames")
    log(f"[44] host images (C++ on the host) against K2's (f32 run), {bench.n} frames: "
        f"{int(bins.sum())} bins > 1e-5 apart, at most {int(bins.max())} in 4 frames "
        f"(bound {HOST_IMAGE_BINS}); int16 images against f32's: "
        f"{int((np.abs(desc['int16'] - desc['f32']) > M.Q16_SCALE).sum())} bins more than a "
        f"5 mm step apart")
    res["host_bins"] = int(bins.sum())

    # the binning of the next chunk on a worker thread beside the card
    m, out, sec = bench.run(chunk_batches=max(1, bench.R // 3), host_descriptors=True)
    bench.check_state(m, out)
    ch = m.last_replay["chunks"]
    ahead = ch[1:]
    hidden = 1.0 - sum(c["wait_ms"] for c in ahead) / sum(c["host_ms"] for c in ahead)
    log(f"[44] host_descriptors in {len(ch)} chunks of {bench.n // len(ch)}: "
        f"{bench.n / sec:.2f} frames/s; host half a chunk (ms: host, binning, main thread's "
        f"wait) " + "; ".join(f"{c['host_ms']:.1f}, {c['bin_ms']:.1f}, {c['wait_ms']:.1f}" for c in ch)
        + f"; hidden {100 * hidden:.1f}% of chunks 2-{len(ch)}'s host half")
    res["hidden"] = hidden

    # the anchor on phase 24's scans under each mode, and under f32 on the
    # scans an int16 chunk sees
    scans, cfg = anchor["scans"], bq.quality_config(False)
    q16 = {k: M.quantize_q16(v).astype(np.float32) * M.Q16_SCALE for k, v in scans.items()}
    with open(bq.GOLDEN) as f:
        golden = json.load(f)
    # each mode against the f32 run on its scans
    ref = {"host": anchor["record"]["loops"]}
    for name, frames in (("host", scans), ("f32 on int16 scans", q16), ("int16", scans)):
        rec, _, _ = bq.run_session(cfg, anchor["gt"], anchor["odom"], frames.__getitem__, "cuda",
                                   32, 6, replay_kw=modes.get(name, {}))
        if name in modes:
            held = f"held to {ref[name]} +- {ANCHOR_LOOP_SPREAD}"
        else:
            ref["int16"], held = rec["loops"], "int16's reference"
        rc = bq.gate(rec, golden)
        log(f"[44] anchor under {name}: ATE {rec['value']:.4f} m (ratio {rec['ratio']:.4f}), "
            f"{rec['loops']} loops ({held}), {rec['keyframes']} keyframes, {rec['evicted']} "
            f"evicted, wall {rec['wall_s']:.2f} s")
        if rc != 0 or rec["keyframes"] != len(anchor["gt"]) or (
                name in modes and abs(rec["loops"] - ref[name]) > ANCHOR_LOOP_SPREAD):
            raise AssertionError(f"the anchor under {name} missed its gate or loops: {rec}")
        res[f"anchor_{name}"] = rec
    log(f"[44] phase 24's f32 anchor: {ref['host']} loops")
    return res


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "scl_slam_tpu_torch")):
        raise RuntimeError(
            "run chip_smoke.py from a checkout: scl_slam_tpu_torch/ is not beside it"
        )
    sys.path.insert(0, ROOT)
    import torch

    t_start = time.perf_counter()

    def run(n, fn, *args):
        """Phase ``n``: its result, its seconds and the seconds since the
        start logged after it."""
        t = time.perf_counter()
        res = fn(*args)
        now = time.perf_counter()
        log(f"[{n}] phase done in {now - t:.1f} s ({now - t_start:.1f} s since the start)")
        return res

    smi = run(1, phase_card, torch)
    from scl_slam_tpu_torch.ops import kernels

    run(2, phase_build, kernels)
    k1 = run(3, phase_k1, torch, kernels)
    k2 = run(4, phase_k2, torch, kernels)
    bench = BenchReplay(torch)
    launches = run(5, phase_slice, torch, kernels, bench)["launches"]
    run(6, phase_cross_device, torch)
    k4 = run(7, phase_k4, torch, kernels)
    live = run(8, phase_live_demo, torch, kernels)
    kitti = run(9, phase_live_kitti, torch, kernels)
    drive = kitti.pop("drive")
    k3 = run(10, phase_k3, torch, kernels)
    multi, inter2 = run(11, phase_multi, torch, kernels)
    tcp = run(12, phase_tcp, torch)
    k6 = run(13, phase_k6, torch, kernels)
    run(14, phase_fleet_bench, torch, kernels)
    fleet = run(15, phase_fleet_run, torch, kernels, inter2)
    run(16, phase_reduced_fleet, torch)
    run(17, phase_eviction, torch)
    k5 = run(18, phase_k5, torch, kernels)
    k7 = run(19, phase_k7, torch, kernels)
    k8 = run(20, phase_k8, torch, kernels)
    switches = run(21, phase_replay_switches, torch, kernels, bench)
    run(22, phase_switch_decisions, torch, kernels)
    run(23, phase_sim, torch)
    anchor = run(24, phase_anchor, torch, kernels)
    run(25, phase_anchor_cross, torch)
    run(26, phase_modes_cross, torch)
    run(27, phase_cityscale, torch, kernels, CITYSCALE_FRAMES)
    run(28, phase_checkpoint, torch, kernels, drive)
    run(29, phase_respawn, torch, tcp)
    run(30, phase_serve, torch)
    del drive
    k2_iris = run(31, phase_k2_iris, torch, kernels, k2)
    run(32, phase_iris_sim, torch)
    iris_live = run(33, phase_iris_live, torch, kernels)
    run(34, phase_iris_multi, torch, kernels)
    run(35, phase_vector_families, torch, kernels)
    k4_odo = run(36, phase_k4_odometry, torch, kernels)
    front = run(37, phase_odometry, torch, kernels)
    run(38, phase_imu_odometry, torch, front)
    del front["scans"]
    run(39, phase_runner_front_ends, torch, kernels)
    run(40, phase_serve_odometry, torch)
    run(41, phase_native_loader, torch)
    run(42, phase_sharded_solve, torch)
    run(43, phase_distributed, torch)
    run(44, phase_input_modes, torch, kernels, bench, anchor)
    del bench, anchor

    def entry(name, source, replaces, n, res, library_ms=None):
        e = {"name": name, "route": "cuda", "source": f"scl_slam_tpu_torch/csrc/{source}",
             "replaces": f"scl_slam_tpu/ops/pallas_kernels.py:{replaces}", "launches": n,
             "max_abs_err": res["max_abs_err"], "ms": res["ms"], "plain_ms": res["plain_ms"],
             "bound_ms": res["bound_ms"], "bound_by": res["bound_by"], "library_ms": library_ms}
        if "many_ms" in res:
            # K1, K2 and K6: "ms" (one launch a graph replay) reads the
            # launch floor at K2's and K6's one-frame shapes; 20 launches
            # to a graph read the device's time a launch
            e["graph20_ms"] = res["many_ms"]
        return e

    # launches: K1 from the replay run (phase 5), K2 from the live path at
    # the KITTI widths (phase 9; its time at that shape, [1, 131072]) and,
    # as max_image_iris, from the live Iris session (phase 33; its time at
    # that shape, [9, 131072] into 80 x 360 bins), K4
    # from the live demo (phase 8) and, as nn_select_odometry, from the
    # ICP odometry (phase 37; its time at that shape, 4,096 x 32,768 P = 8),
    # K3 from the two-robot run (phase 11), K6
    # from the fleet run (phase 15; its time at that run's [2, 256, 1024]),
    # K5, K7, K8 and K1's argmin body from the replay
    # under their switches (phase 21); no kernel but K2 has a single
    # PyTorch call (library_ms null)
    report = {"kernels": [
        entry("nn_select_batched", "nn_select_batched.cu", 273,
              launches["nn_select_batched"], k1["full"]),
        entry("max_image", "max_image.cu", 1053, kitti["launches"]["max_image"],
              k2["live_kitti"], k2["live_kitti"]["library_ms"]),
        entry("max_image_iris", "max_image.cu", 1053, iris_live["launches"]["max_image"],
              k2_iris["iris_live"], k2_iris["iris_live"]["library_ms"]),
        entry("nn_select", "nn_select.cu", 132, live["nn_select"], k4["full"]),
        entry("nn_select_odometry", "nn_select.cu", 132, front["launches"], k4_odo),
        entry("nearest_neighbors", "nn_select.cu", 532, multi["nearest_neighbors"], k3["full"]),
        entry("ransac_counts_batched", "ransac_counts.cu", 898, fleet["ransac_counts_batched"],
              k6["fleet_run"]),
        entry("icp_moments_batched", "icp_moments.cu", 768,
              switches["FUSED_ICP"]["launches"]["icp_moments_batched"], k5["full"]),
        entry("nn_index_batched", "nn_select_batched.cu", 367,
              switches["NN_INDEX"]["launches"]["nn_index_batched"], k7["replay"]["k7"]),
        entry("nn_select_batched_mxu", "nn_select_batched.cu", 479,
              switches["MXU_NN"]["launches"]["nn_select_batched_mxu"], k8),
        entry("nn_select_batched_argmin", "nn_select_batched.cu", 273,
              switches["argmin"]["launches"]["nn_select_batched_argmin"], k7["replay"]["k1_argmin"]),
    ]}
    log(f"card: {smi}")
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
