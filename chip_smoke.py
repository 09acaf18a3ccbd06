#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``scl_slam_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):

1. the card: fails without CUDA; prints ``nvidia-smi``'s name and power
   limit;
2. builds the CUDA kernels from ``scl_slam_tpu_torch/csrc`` with nvcc and
   prints the build seconds and ptxas' register/shared-memory report;
3. K1 (batched 1-NN + payload select) against its plain PyTorch version on
   the card at both ICP shapes of the replay path, with inactive lanes and
   planted exact ties: d2 bit-equal, selection equal up to the stated tie
   tolerance; kernel and plain times by CUDA events;
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
   and padded targets: d2 bit-equal, selection equal;
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
   capacity against the 0.3 s ``mapping_process_interval``.

Kernel times are CUDA events around replays of a CUDA graph of the call
(device time without the host's launch cost), beside the eager call's
time; each kernel's bound is the larger of its bytes over 3.35 TB/s and
its FP32 operations over 67 TFLOP/s (the H100 SXM data sheet at 700 W),
counted from this run's shapes. The line before the last is a JSON object
with one entry per kernel; the last line is ``{"ok": true, "device":
{...}}``. This script imports nothing of JAX.
"""
from __future__ import annotations

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
    log(f"[2] built {os.path.relpath(path, ROOT)} in {secs:.2f} s")
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


def phase_slice(torch, kernels) -> dict:
    """Phase 5; returns the kernel launch counts of the first timed run."""
    from scl_slam_tpu_torch.geometry import se3
    from scl_slam_tpu_torch.runtime import mapper as M

    cfg = bench_cfg()
    B, R = 32, 6
    n = B * R
    n_pts = cfg.keyframe.raw_points_capacity
    t0 = time.perf_counter()
    scans = bench_scans(n, n_pts, seed=0)
    eye = np.eye(3, dtype=np.float32)
    poses = [se3.Pose(eye, np.float32([1.0 * k, 0.0, 0.0])) for k in range(n)]
    stamps = [0.0] * n
    log(f"[5] generated {n} bench scans in {time.perf_counter() - t0:.1f} s")

    def run():
        m = M.Mapper(cfg)  # the card by default
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = m.replay(poses, scans, stamps, apply_gate=False, batch=B, chunk_batches=R)
        torch.cuda.synchronize()
        return m, out, time.perf_counter() - t

    run()  # warm-up
    kernels.reset_launch_counts()
    m, out, dt = run()
    launches = dict(kernels.LAUNCHES)
    # four more timed runs for the spread (fresh Mapper each)
    times = [dt] + [run()[2] for _ in range(4)]
    fps = n / float(np.median(times))
    loops = sum(1 for x in out["loops"] if x)
    st = m.state
    if launches["max_image"] < R or launches["nn_select_batched"] < 1:
        raise AssertionError(f"replay did not go through both kernels: {launches}")
    traj = m.trajectory()
    checks = {
        "keyframes": int(st.counts[0]) == n == out["keyframes"],
        "edges": int(st.graph.num_edges) == n - 1,
        "queue": int(st.loop_queue.count) == loops,
        "finite": bool(np.isfinite(traj).all()) and traj.shape == (n, 4, 4),
        "poses": bool(np.allclose(traj[:, 0, 3], np.arange(n), atol=1e-3)),
        "db": bool(torch.isfinite(st.desc_db.descriptors[:n]).all()) and int(st.desc_db.count) == n,
    }
    if not all(checks.values()):
        raise AssertionError(f"replay state checks failed: {checks}")
    log(f"[5] Mapper.replay {n} frames ({n_pts} pts, B={B} x {R}), 5 runs: "
        f"median {fps:.2f} frames/s "
        f"(run seconds {', '.join(f'{x:.4f}' for x in times)}); loops {loops}; "
        f"launches in the first timed run {launches}; state checks ok")

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
    from scl_slam_tpu_torch.config import (
        KeyframeConfig, LoopConfig, OptimizerConfig, ScanContextParams, SlamConfig,
    )
    from scl_slam_tpu_torch.geometry import se3
    from scl_slam_tpu_torch.runtime import mapper as M

    cfg = SlamConfig(
        keyframe=KeyframeConfig(
            max_keyframes=256, points_per_keyframe=1024, raw_points_capacity=16384
        ),
        # sparse surface-sampled synthetic scans: the looser gates that
        # tests/test_pipeline.py uses for them
        loop=LoopConfig(near_keyframes=6, submap_capacity=2048, icp_iterations=20,
                        history_fitness_score=8.0),
        optimizer=OptimizerConfig(edge_capacity=512),
        scan_context=ScanContextParams(
            exclude_recent=16, num_candidates=6, distance_threshold=0.25
        ),
    )
    T, scans = revisit_world(64, 16384)
    T = T.astype(np.float32)
    poses = [se3.Pose(T[k, :3, :3], T[k, :3, 3]) for k in range(len(T))]
    stamps = [0.1 * k for k in range(len(T))]
    runs = {}
    for device in ("cpu", "cuda"):
        m = M.Mapper(cfg, device)
        t = time.perf_counter()
        out = m.replay(poses, scans, stamps, apply_gate=False, batch=16, chunk_batches=2)
        if device == "cuda":
            torch.cuda.synchronize()
        runs[device] = (m, out, time.perf_counter() - t)
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
            f"(eager call {call_ms:.4f} ms, chunking {kernels._k4_chunking(nq, nt)}), "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
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
    launches = phase_slice(torch, kernels)
    phase_cross_device(torch)
    k4 = phase_k4(torch, kernels)
    live = phase_live_demo(torch, kernels)
    phase_live_kitti(torch, kernels)

    def entry(name, source, replaces, n, res, library_ms=None):
        return {"name": name, "route": "cuda", "source": f"scl_slam_tpu_torch/csrc/{source}",
                "replaces": f"scl_slam_tpu/ops/pallas_kernels.py:{replaces}", "launches": n,
                "max_abs_err": res["max_abs_err"], "ms": res["ms"], "plain_ms": res["plain_ms"],
                "bound_ms": res["bound_ms"], "bound_by": res["bound_by"], "library_ms": library_ms}

    # launches: K1 and K2 from the replay run (phase 5), K4 from the live
    # demo (phase 8); K1 and K4 have no single PyTorch call (library_ms null)
    report = {"kernels": [
        entry("nn_select_batched", "nn_select_batched.cu", 273,
              launches["nn_select_batched"], k1["full"]),
        entry("max_image", "max_image.cu", 1053, launches["max_image"], k2, k2["library_ms"]),
        entry("nn_select", "nn_select.cu", 132, live["nn_select"], k4["full"]),
    ]}
    log(f"card: {smi}")
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
