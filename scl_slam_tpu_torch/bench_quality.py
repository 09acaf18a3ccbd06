"""Quality-at-scale anchor of the port: a 1,224-keyframe realistic-proxy
session -> ATE, gated on ``tests/golden/quality_ate.json`` (the port's copy
of ``scripts/bench_quality.py``, which imports JAX).

The session exercises every at-scale mechanism at once:

- 6 lane-offset laps of the urban proxy world (``io/lidar_sim.py``,
  64-beam ring-structured scans rendered on the mapper's device) = 1,224
  keyframes at the reference's 1 m cadence;
- drifted odometry (a random walk, the realistic LIO error process);
- the batched replay path (``Mapper.replay``, 6 x 32 chunks) with a drain
  and pose-graph solve after every chunk;
- live eviction: capacity 1,024 < 1,224 keyframes, so the last laps run
  compaction while loops keep closing (``full_trajectory`` merges the
  archive back for evaluation).

Prints ONE JSON line (``metric`` ``quality_ate_m``, ``value`` the optimized
ATE, ``ate_odom_m`` the dead-reckoning ATE, ``ratio``, ``keyframes``,
``evicted``, ``loops``, ``platform`` the card's name or ``cpu``,
``wall_s``) and exits 1 above either bound of the golden file, which it
reads and never writes. The port's scans carry their own range-noise
stream (``io/lidar_sim.py``), so its ATE is not the JAX package's; it is
held to the same bounds.

    python -m scl_slam_tpu_torch.bench_quality                      # the card
    python -m scl_slam_tpu_torch.bench_quality --quick --device cpu  # smoke
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

GOLDEN = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tests", "golden", "quality_ate.json",
)
# lane offsets (m) of the anchor's laps: later laps revisit every earlier lane
LAPS = (0.0, 2.0, 1.0, 3.0, 0.5, 2.5)


def build_gt(scene, laps):
    """Lap sequence with lane-offset revisits: [N] 4x4 world poses."""
    gt = []
    for offset in laps:
        gt += scene.circuit(lane_offset=offset, step=1.0)
    return gt


def drift_odometry(gt, seed=3, rot_sigma=0.002, trans_sigma=0.02):
    """Random-walk-corrupted odometry chain: each ground-truth increment
    composed with exp of a Gaussian twist (a systematic bias would be
    model-inconsistent, and the MAP estimate would rightly refuse to bend
    the chain). Returns [N] CPU f32 poses."""
    import torch

    from .geometry import se3

    def pose(T):
        T = torch.as_tensor(np.asarray(T, np.float32))
        return se3.Pose(T[:3, :3], T[:3, 3])

    rng = np.random.RandomState(seed)
    odom = [pose(gt[0])]
    for k in range(1, len(gt)):
        twist = np.concatenate([rng.randn(3) * rot_sigma, rng.randn(3) * trans_sigma])
        noise = se3.exp(torch.as_tensor(twist, dtype=torch.float32))
        inc = pose(np.linalg.inv(gt[k - 1]) @ gt[k])
        odom.append(se3.compose(odom[-1], se3.compose(inc, noise)))
    return odom


def quality_config(quick: bool, max_keyframes: int = 1024):
    """Reference-default thresholds at realistic density (SC gate 0.14,
    fitness gate 0.3, 1 m cadence, 8,192 / 16,384-point storage); ``quick``
    narrows the widths for a CPU smoke and caps the capacity at 256."""
    from .config import (
        KeyframeConfig, LoopConfig, OptimizerConfig, ScanContextParams, SlamConfig,
    )
    from .io.lidar_sim import SENSOR_HEIGHT

    return SlamConfig(
        keyframe=KeyframeConfig(
            max_keyframes=min(max_keyframes, 256) if quick else max_keyframes,
            points_per_keyframe=2048 if quick else 8192,
            raw_points_capacity=65536 if quick else 131072,
            distance_threshold=1.0,
            angle_threshold=0.2,
        ),
        loop=LoopConfig(
            near_keyframes=6,
            submap_capacity=4096 if quick else 16384,
            history_fitness_score=0.3,
            icp_iterations=30,
            icp_max_corr_dist=10.0,
        ),
        optimizer=OptimizerConfig(edge_capacity=2048, gn_iters=5, cg_iters=32),
        scan_context=ScanContextParams(lidar_height=SENSOR_HEIGHT),
    )


def run_session(cfg, gt, odom, scan, device="cuda", batch=32, chunk_batches=6,
                n_frames=None, log=None, replay_kw=None):
    """Replay frames ``0 .. n_frames`` (all by default) in chunks of ``batch
    * chunk_batches`` with a drain and solve after each; ``scan(k)`` gives
    frame k's sensor-frame scan [M, 3]; ``replay_kw`` goes to every
    ``Mapper.replay`` (its input mode). Returns (record, mapper, loops):
    the record holds the optimized and dead-reckoning ATE over the
    keyframes (without alignment), their ratio, keyframes, evicted
    keyframes, loops, the device's name and the wall seconds, unrounded;
    ``loops`` is the replay's per-keyframe result (a dict or None)."""
    import torch

    from .geometry import se3
    from .io import trajectory as tio
    from .runtime import Mapper

    n = len(gt) if n_frames is None else n_frames
    t0 = time.perf_counter()
    m = Mapper(cfg, device=device)
    chunk = batch * chunk_batches
    loops: list = []
    pos = 0
    while pos < n:
        idx = list(range(pos, min(n, pos + chunk)))
        out = m.replay(
            [odom[k] for k in idx], [scan(k) for k in idx],
            stamps=[1.0 * k for k in idx],
            apply_gate=False, batch=batch, chunk_batches=chunk_batches, **(replay_kw or {}),
        )
        loops += out["loops"]
        m.optimize()                     # drain every chunk (ends on the host)
        pos += len(idx)
        if log:
            log(f"[quality] fed {pos}/{n} kf={m._keyframes} "
                f"loops={sum(1 for x in loops if x)} "
                f"resident={int(m.state.counts.sum())} ({time.perf_counter() - t0:.0f}s)")
    est, stamps = m.full_trajectory()
    kf_idx = [int(round(float(s))) for s in stamps]
    kf_gt = np.stack([gt[i] for i in kf_idx])
    dead = np.stack([se3.to_matrix(odom[i]).numpy() for i in kf_idx])
    ate_opt = tio.ate_rmse(est, kf_gt, align=False)
    ate_dead = tio.ate_rmse(dead, kf_gt, align=False)
    rec = {
        "metric": "quality_ate_m",
        "value": ate_opt,
        "unit": "m",
        "ate_odom_m": ate_dead,
        "ratio": ate_opt / max(ate_dead, 1e-9),
        "keyframes": m._keyframes,
        "evicted": sum(len(v) for v in m._evicted.values()),
        "loops": sum(1 for x in loops if x),
        "platform": torch.cuda.get_device_name(0) if m.device.type == "cuda" else "cpu",
        "wall_s": time.perf_counter() - t0,
    }
    return rec, m, loops


def gate(rec: dict, golden: dict) -> int:
    """Exit code of the golden gate: 1 (and ``rec["regression"]``) when the
    ATE or its ratio to dead reckoning is above its bound, else 0."""
    rec["golden_bound"] = golden["ate_opt_bound"]
    if rec["value"] > golden["ate_opt_bound"] or rec["ratio"] > golden["ratio_bound"]:
        rec["regression"] = True
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="scl_slam_tpu_torch quality anchor")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the mapper and the simulator run (default: the GPU)")
    ap.add_argument("--quick", action="store_true",
                    help="reduced scale (1 lap, 512-azimuth scans, capacity 256, no "
                    "eviction): a CPU smoke, NOT the anchor, no golden gate")
    ap.add_argument("--azimuth", type=int, default=1024)
    ap.add_argument("--max-keyframes", type=int, default=1024)
    args = ap.parse_args(argv)

    from .io.lidar_sim import LidarSim, UrbanScene
    from .run_multi import require_device

    require_device(args.device)
    scene = UrbanScene(seed=7, blocks=1, block_size=40.0)
    azimuth = 512 if args.quick else args.azimuth
    sim = LidarSim(scene, n_azimuth=azimuth, device=args.device)
    gt = build_gt(scene, LAPS[:1] if args.quick else LAPS)
    odom = drift_odometry(gt)
    cfg = quality_config(args.quick, args.max_keyframes)
    print(f"[quality] device={args.device} frames={len(gt)} "
          f"capacity={cfg.keyframe.max_keyframes} azimuth={azimuth}", file=sys.stderr, flush=True)
    B, R = (8, 2) if args.quick else (32, 6)
    rec, _, _ = run_session(
        cfg, gt, odom, lambda k: sim.scan_at(gt[k], seed=k), args.device, B, R,
        log=lambda s: print(s, file=sys.stderr, flush=True),
    )
    rc = 0
    if args.quick:
        rec["note"] = "quick mode — not the anchor, no golden gate"
    else:
        with open(GOLDEN) as f:
            rc = gate(rec, json.load(f))
    print(json.dumps(rec), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
