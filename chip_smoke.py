#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``scl_slam_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. the card: fails without CUDA; prints ``nvidia-smi``'s name and power
   limit;
2. builds the CUDA kernels from ``scl_slam_tpu_torch/csrc`` with nvcc and
   prints the build seconds (beside those of one nvcc call of the same
   sources and flags) and ptxas' register/shared-memory report (the split
   kernels of K1, K7, K8, K4, K3 and K5 are the ``nn_split_kernel``
   entries);
3. K1 (batched 1-NN + payload select) against its plain PyTorch version on
   the card at both ICP shapes of the replay path, with inactive lanes and
   planted exact ties: d2 bit-equal, selection equal up to the stated tie
   tolerance; kernel and plain times by CUDA events; the launch geometry
   (blocks, warps per SM, slices), the time beside PERF.md's row from
   before the split-target design, and the share of the bound beside the
   50% issue ceiling;
4. K2 (max image) against its plain version at 32 x 65,536 points into
   20 x 60 bins: bit-equal; both times;
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
   end with an ATE below odometry-only; then the same 60-frame run on the
   CPU (plain versions) and on the card must make the same loop decisions and match the same keyframes, with the
   trajectories within the stated tolerance;
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
   ``chiprun_out/profile_verify.txt``); then ``--robots 3``; then a
   reduced two-robot session on the CPU and on the
   card, which must make the same retrieval hits and inter-loop decisions,
   with the trajectories within the stated tolerance;
12. ``run_multi --robots 2 --transport tcp`` on the card: two worker
   processes share it and verify inter-robot loops over sockets;
13. K6 (batched RANSAC hypothesis scoring: inlier counts) against its
   plain version on the card at the fleet bench's 16 x 256 x 1,024, at a
   full keyframe's 16 x 256 x 4,096 and at a ragged 3 x 37 x 1,000, with
   points planted exactly on the threshold and a lane without a good
   point: counts equal;
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
   and successes.

Kernel times are CUDA events around replays of a CUDA graph of the call
(device time without the host's launch cost), beside the eager call's
time; each kernel's bound is the larger of its bytes over 3.35 TB/s and
its FP32 operations over 67 TFLOP/s (the H100 SXM data sheet at 700 W),
counted from this run's shapes (9 operations a query-target pair for K1,
K3, K4, K5, K7 and K8). The line before the last is a JSON object
with one entry per kernel; the last line is ``{"ok": true, "device":
{...}}``. This script imports nothing of JAX.
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
# each kernel's time before it moved onto the split-target design
ROW_MS = {
    "K1-mineq full": 0.4269, "K1-mineq coarse": 0.1060,
    "K1-argmin replay": 0.1847, "K1-argmin fleet_ransac": 0.1369,
    "K7 replay": 0.1421, "K7 fleet_ransac": 0.0993,
    "K4 full": 0.0188, "K4 coarse": 0.0119, "K4 full_p8": 0.0190,
    "K3 full": 0.0273, "K3 small": 0.0123, "K3 kitti": 0.0477,
    "K5-mineq full": 0.4334, "K5-mineq coarse": 0.1101,
    "K5-argmin full": 0.1830, "K5-argmin coarse": 0.0401,
    "K8 replay": 0.1784,
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
    # for comparison: the same sources and flags in one nvcc call
    one = path.with_name(f".one_call.{os.getpid()}.so")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", str(one),
         *map(str, kernels._sources())],
        capture_output=True, text=True,
    )
    one_secs = time.perf_counter() - t0
    one.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"one-call nvcc build failed:\n{proc.stdout}\n{proc.stderr}")
    log(f"[2] the same sources and flags in one nvcc call: {one_secs:.2f} s")
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


def phase_k1(torch, kernels) -> dict:
    res = {}
    for B, nq, nt, label in ((32, 1024, 8192, "full"), (32, 256, 2048, "coarse")):
        q, payload, active = k1_inputs(torch, B, nq, nt, seed=nq)
        d, sel = kernels.nn_select_batched(q, payload, active)
        d_p, sel_p = kernels.nn_select_batched_plain(q, payload, active)
        torch.cuda.synchronize()
        if not torch.equal(d, d_p):
            bad = (d != d_p).sum().item()
            raise AssertionError(f"K1 {label}: d2 differs from the plain version in {bad} places")
        if not (torch.isinf(d[3]).all() and (sel[3] == 0).all()):
            raise AssertionError(f"K1 {label}: an inactive lane was written")
        if not (d[2, : min(nt // 3, nq)] == 1.0).all():
            raise AssertionError(f"K1 {label}: planted ties not found")
        scale = payload[:, :3][payload[:, :3] < 1e5].abs().max().item()
        tol = TIE_ULPS * 2.0 ** (np.floor(np.log2(scale)) - 23)
        err = (sel - sel_p).abs().max().item()
        n_diff = (sel != sel_p).sum().item()
        if err > tol:
            raise AssertionError(f"K1 {label}: sel differs by {err} > {tol}")
        args = (q, payload, active)
        call_ms = time_cuda(torch, lambda: kernels.nn_select_batched(*args), reps=20)
        ms = time_graph(torch, lambda: kernels.nn_select_batched(*args), reps=20)
        plain_ms = time_graph(torch, lambda: kernels.nn_select_batched_plain(*args), reps=5)
        # 9 FP32 operations per (query, target) pair of an active lane:
        # 3 subtracts, 3 multiplies, 2 adds, 1 compare
        n_active = int(active.sum().item())
        bound_ms, bound_by = bound(
            4 * (B * nq * 3 + B * 4 * nt + B + B * nq + B * 4 * nq), 9 * n_active * nq * nt
        )
        log(f"[3] K1 {label} {B}x{nq}x{nt}: d2 bit-equal, sel max|diff| {err:.3g} "
            f"(tol {tol:.3g}, {n_diff} elements differ), kernel {ms:.4f} ms "
            f"(eager call {call_ms:.4f} ms), plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by})")
        log(f"[3]   K1 {label} geometry: "
            f"{split_geometry(torch, kernels.k1_geometry(B, nq, nt), B, n_active)}; "
            f"{versus_row('K1-mineq ' + label, ms, bound_ms)}")
        res[label] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by}
    return res


def phase_k2(torch, kernels) -> dict:
    from scl_slam_tpu_torch.ops import pointcloud as pc

    dev = torch.device("cuda")
    xyz = torch.from_numpy(np.stack(bench_scans(32, 65536, seed=1))).to(dev)
    mask = torch.ones(xyz.shape[:2], dtype=torch.bool, device=dev)
    mask[5, 40000:] = False  # one partly padded frame
    ring, sector, valid = pc.polar_bins(xyz, mask, 20, 60, 80.0)
    z = (xyz[..., 2] + 1.65).contiguous()
    args = (z, ring.contiguous(), sector.contiguous(), valid.contiguous(), 20, 60)
    img = kernels.max_image(*args)
    ref = kernels.max_image_plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(img, ref):
        bad = (img != ref).sum().item()
        raise AssertionError(f"K2: image differs from the plain version in {bad} bins")
    call_ms = time_cuda(torch, lambda: kernels.max_image(*args), reps=50)
    ms = time_graph(torch, lambda: kernels.max_image(*args), reps=50)
    plain_ms = time_graph(torch, lambda: kernels.max_image_plain(*args), reps=20)
    # the one PyTorch call with the same result: scatter_reduce_ "amax"
    # over the flat bin index (the index and values prepared beforehand)
    ok = args[3] & (z > 0)
    flat = torch.where(ok, ring.long() * 60 + sector.long(), 1200)
    vals = torch.where(ok, z, 0.0)
    lib_img = torch.zeros((32, 1201), device=dev)
    lib_img.scatter_reduce_(1, flat, vals, "amax", include_self=True)
    if not torch.equal(lib_img[:, :1200].reshape(32, 20, 60), ref):
        raise AssertionError("K2: scatter_reduce_ amax disagrees with the plain version")
    library_ms = time_graph(
        torch, lambda: lib_img.scatter_reduce_(1, flat, vals, "amax", include_self=True), reps=50
    )
    B, n = z.shape
    bound_ms, bound_by = bound(B * n * (4 + 4 + 4 + 1) + B * 20 * 60 * 4, 2 * B * n)
    log(f"[4] K2 32x65536 -> 20x60: bit-equal, kernel {ms:.4f} ms (eager call "
        f"{call_ms:.4f} ms), plain {plain_ms:.4f} ms, scatter_reduce_ {library_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    return {"max_abs_err": float((img - ref).abs().max().item()), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


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

    def run(self):
        """One ``Mapper.replay`` of the workload on a fresh Mapper, ended by a
        synchronize: (mapper, its output, seconds)."""
        from scl_slam_tpu_torch.runtime import mapper as M

        torch = self.torch
        m = M.Mapper(self.cfg)  # the card by default
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = m.replay(self.poses, self.scans, self.stamps, apply_gate=False,
                       batch=self.B, chunk_batches=self.R)
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
    """Phase 5; returns the kernel launch counts of the untimed counting
    run."""
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
    return launches


def profile_block(torch, tag, what, fn, table_name) -> None:
    """Run ``fn`` once under torch.profiler: log the device's busy share
    and its top kernels; the whole table goes to chiprun_out/."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in on_device) / 1e3
    n_launch = sum(e.count for e in on_device)
    log(f"{tag} profile of {what}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), {n_launch} device operations, under the profiler")
    for e in sorted(on_device, key=dev_us, reverse=True)[:8]:
        log(f"{tag}   {dev_us(e) / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", table_name), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=60))


def profile_replay(torch, M, cfg, args) -> None:
    """One more card-resident chunk under torch.profiler: device busy
    share and the kernels by device time; the table goes to
    chiprun_out/profile_replay.txt."""
    from torch.profiler import ProfilerActivity, profile

    state = M.make_state(cfg, torch.device("cuda"))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        M._replay_batches(state, *args, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    from torch.autograd import DeviceType

    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    # the device's own rows (kernels, memcpy, memset), not the host ops
    # that launched them
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in on_device) / 1e3
    top = sorted(on_device, key=dev_us, reverse=True)[:12]
    log(f"[5] profile: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%) under the profiler")
    for e in top:
        log(f"[5]   {dev_us(e) / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "profile_replay.txt"), "w") as f:
        f.write(events.table(sort_by="self_device_time_total", row_limit=60))


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
    then 60 frames on the CPU and on the card. Returns the kernel launch
    counts of the demo run."""
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

    n, get_scan, get_odom, gt_of = R.synthetic_sequence(60, 0, 0.05)
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
    log(f"[8] 60 frames: {len(dec_c)} loops, decisions and matched "
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
    then one ``Mapper.optimize()`` at the full capacity."""
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
    if launches["nn_select"] < 1 or m.icp_attempts < 1:
        raise AssertionError(f"the KITTI-width live run launched no K4: {launches}")
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
    return launches


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


def reduced_multi_cfg(r: int):
    """The reduced two-robot configuration (tests/test_torch_inter.py's
    session: tests/test_multi_robot.py's widths)."""
    from scl_slam_tpu_torch.config import (
        KeyframeConfig, LoopConfig, OptimizerConfig, ScanContextParams, SlamConfig,
    )

    return SlamConfig(
        number_of_robots=2, robot_id=r, robot_name=chr(ord("a") + r),
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
    )


def reduced_multi_session(torch, device: str):
    """Two robots over the in-process bus: robot a at frames 16-39 of a
    35 m circle with ground-truth odometry, robot b at 32-47 drifting 5 cm
    and 1 mrad a frame. Returns (retrieval hits, verified loops, robot a's
    view of both trajectories, seconds)."""
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
        ms = [M.Mapper(reduced_multi_cfg(r), device) for r in range(2)]
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
    rc3, rep3 = run_multi_report(["--robots", "3", "--output", out_dir + "3"])
    log(f"[11] run_multi --robots 3 (defaults) -> {json.dumps(rep3)}")
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


def phase_k6(torch, kernels) -> dict:
    res = {}
    for B, H, N, label in ((16, 256, 1024, "fleet"), (16, 256, 4096, "keyframe"),
                           (3, 37, 1000, "ragged")):
        args, thr2 = ransac_inputs(torch, B, H, N, seed=B + H + N)
        counts = kernels.ransac_counts_batched(*args, thr2)
        ref = kernels.ransac_counts_batched_plain(*args, thr2)
        torch.cuda.synchronize()
        if not torch.equal(counts, ref):
            raise AssertionError(f"K6 {label}: counts differ from the plain version in "
                                 f"{(counts != ref).sum().item()} places")
        if not (counts[1] == 0).all():
            raise AssertionError(f"K6 {label}: the lane without a good point has inliers")
        q = N // 4
        half = kernels.ransac_counts_batched(
            *(a[:1, : 2 * q].contiguous() for a in args[:3]),
            args[3][:1, :1].contiguous(), args[4][:1, :1].contiguous(), thr2,
        )
        if int(half[0, 0]) != int(args[2][0, q : 2 * q].sum()):
            raise AssertionError(f"K6 {label}: the points planted on the threshold were miscounted")
        call_ms = time_cuda(torch, lambda: kernels.ransac_counts_batched(*args, thr2), reps=50)
        ms = time_graph(torch, lambda: kernels.ransac_counts_batched(*args, thr2), reps=50)
        plain_ms = time_graph(torch, lambda: kernels.ransac_counts_batched_plain(*args, thr2), reps=10)
        # 27 FP32 operations per (hypothesis, point): 18 for the transform,
        # 3 subtracts, 3 multiplies, 2 adds and the compare; bytes: the
        # points once, the poses once, the counts written once
        bound_ms, bound_by = bound(B * N * (12 + 12 + 1) + B * H * (36 + 12 + 4), 27 * B * H * N)
        log(f"[13] K6 {label} {B}x{H}x{N}: counts equal (the planted on-threshold points out), "
            f"kernel {ms:.4f} ms (eager call {call_ms:.4f} ms), plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by})")
        res[label] = {"max_abs_err": float((counts - ref).abs().max().item()), "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}
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


def phase_tcp(torch) -> None:
    rc, rep = run_multi_report(["--robots", "2", "--transport", "tcp",
                                "--output", os.path.join(ROOT, "chiprun_out", "run_multi_tcp")])
    log(f"[12] run_multi --robots 2 --transport tcp -> {json.dumps(rep)}")
    if rc != 0 or rep["inter_loops"] < 1 or rep["device"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"the tcp run on the card verified no inter-robot loop (rc {rc})")


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


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "scl_slam_tpu_torch")):
        raise RuntimeError(
            "run chip_smoke.py from a checkout: scl_slam_tpu_torch/ is not beside it"
        )
    sys.path.insert(0, ROOT)
    import torch

    smi = phase_card(torch)
    from scl_slam_tpu_torch.ops import kernels

    phase_build(kernels)
    k1 = phase_k1(torch, kernels)
    k2 = phase_k2(torch, kernels)
    bench = BenchReplay(torch)
    launches = phase_slice(torch, kernels, bench)
    phase_cross_device(torch)
    k4 = phase_k4(torch, kernels)
    live = phase_live_demo(torch, kernels)
    phase_live_kitti(torch, kernels)
    k3 = phase_k3(torch, kernels)
    multi, inter2 = phase_multi(torch, kernels)
    phase_tcp(torch)
    k6 = phase_k6(torch, kernels)
    phase_fleet_bench(torch, kernels)
    fleet = phase_fleet_run(torch, kernels, inter2)
    phase_reduced_fleet(torch)
    phase_eviction(torch)
    k5 = phase_k5(torch, kernels)
    k7 = phase_k7(torch, kernels)
    k8 = phase_k8(torch, kernels)
    switches = phase_replay_switches(torch, kernels, bench)
    del bench
    phase_switch_decisions(torch, kernels)

    def entry(name, source, replaces, n, res, library_ms=None):
        return {"name": name, "route": "cuda", "source": f"scl_slam_tpu_torch/csrc/{source}",
                "replaces": f"scl_slam_tpu/ops/pallas_kernels.py:{replaces}", "launches": n,
                "max_abs_err": res["max_abs_err"], "ms": res["ms"], "plain_ms": res["plain_ms"],
                "bound_ms": res["bound_ms"], "bound_by": res["bound_by"], "library_ms": library_ms}

    # launches: K1 and K2 from the replay run (phase 5), K4 from the live
    # demo (phase 8), K3 from the two-robot run (phase 11), K6 from the
    # fleet run (phase 15), K5, K7, K8 and K1's argmin body from the replay
    # under their switches (phase 21); no kernel but K2 has a single
    # PyTorch call (library_ms null)
    report = {"kernels": [
        entry("nn_select_batched", "nn_select_batched.cu", 273,
              launches["nn_select_batched"], k1["full"]),
        entry("max_image", "max_image.cu", 1053, launches["max_image"], k2, k2["library_ms"]),
        entry("nn_select", "nn_select.cu", 132, live["nn_select"], k4["full"]),
        entry("nearest_neighbors", "nn_select.cu", 532, multi["nearest_neighbors"], k3["full"]),
        entry("ransac_counts_batched", "ransac_counts.cu", 898, fleet["ransac_counts_batched"],
              k6["fleet"]),
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
