#!/usr/bin/env python3
"""How often, and where, the pose-graph solve of the PyTorch port breaks
down (ends non-finite) on one NVIDIA GPU, and what the decentralized tcp
run's inter-robot loop count does beside it.

Run from the root of a checkout on the machine with the card:

    python3 scripts/torch_solve_breakdown.py [--repeats 8] [--tcp-runs 3]
        [--tcp-roots DIR,DIR]

1. chip_smoke.py phase 30's drive (``configs/kitti_velodyne.yaml``, 4,096
   pose slots; the anchor's urban world at 2,048 azimuths: every other
   frame of a lap, then 36 frames of the same lane again) through an
   in-process Mapper, keeping each drain's input state; then every drain
   again ``--repeats`` times from its own input (``_drain_queue_and_optimize``:
   the warm and the chordal start). On the card the solve's scatter-sums
   run with atomics in an order that changes from run to run, so the
   repeats sample that order. Prints, per drain and start, the solves that
   ended non-finite and those that ended finite with a step flagged (PCG
   stopped on r.z <= 0), each by step and stage
   (``solver.breakdown_stages``), and the drain's milliseconds.
2. ``python -m scl_slam_tpu_torch.run_multi --robots 2 --transport tcp``
   (phase 12) ``--tcp-runs`` times from each checkout root of
   ``--tcp-roots`` in turn (default: this checkout), each run a process of
   its own: its inter loops, wall seconds and, where the checkout reports
   them, its drains whose solve broke down and the inter-robot path's
   outcomes.

The last line is one JSON object with the counts.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def drain_probe(torch, device: str, repeats: int) -> dict:
    from scl_slam_tpu_torch import bench_quality as bq
    from scl_slam_tpu_torch.config import load_config
    from scl_slam_tpu_torch.graph import solver
    from scl_slam_tpu_torch.runtime import mapper as M
    from scl_slam_tpu_torch.runtime.state import state_from_numpy, state_to_numpy

    scene, sim, _ = cs.anchor_world(2048, device)
    gt = bq.build_gt(scene, (0.0, 0.0))
    lap = len(gt) // 2
    frames = list(range(0, lap, 2)) + list(range(lap, lap + 72, 2))
    poses = {k: np.asarray(gt[k], np.float32) for k in frames}
    scans = {k: sim.scan_at(gt[k], seed=k) for k in frames}
    cfg = load_config(os.path.join(ROOT, "configs", "kitti_velodyne.yaml"))
    inputs = []

    def keep_input(fn):
        def call(state, cfg_):
            inputs.append(state_to_numpy(state))
            return fn(state, cfg_)
        return call

    m = M.Mapper(cfg, device=device)
    undo = cs.patched(M, "_drain_queue_and_optimize", keep_input)
    t = time.perf_counter()
    try:
        decisions = cs.drive_on(m, frames, poses, scans, 0)
    finally:
        undo()
    print(f"drive: {len(frames)} frames, {sum(k for k, _ in decisions)} keyframes, "
          f"{sum(x is not None for _, x in decisions)} loops, {len(inputs)} drains, "
          f"{time.perf_counter() - t:.1f} s; the drive's own broken drains "
          f"{m.broken_drains} {m.solve_breakdowns}", flush=True)
    # every start's SolveResult: a start that ended finite with a nonzero
    # breakdown code is one whose PCG stopped on r.z <= 0 (or was flagged
    # otherwise) and still ended finite
    results = []

    def keep_result(fn):
        def call(*a, **k):
            results.append(fn(*a, **k))
            return results[-1]
        return call

    broken, flagged, solves, per_drain = collections.Counter(), collections.Counter(), 0, []
    undo = cs.patched(M.solver, "solve", keep_result)
    try:
        for d, snap in enumerate(inputs):
            here, ms, n_edges = collections.Counter(), [], 0
            for _ in range(repeats):
                state = state_from_numpy(snap, device)
                if device == "cuda":
                    torch.cuda.synchronize()
                results.clear()
                t = time.perf_counter()
                state, _, _ = M._drain_queue_and_optimize(state, cfg)
                n_edges = int(state.graph.num_edges)
                ms.append((time.perf_counter() - t) * 1e3)
                solves += len(results)
                for start, r in zip(("warm", "chordal"), results):
                    code = int(r.breakdown)
                    finite = bool(M._solved(r.poses, r.chi2_history))
                    if finite and code == 0:
                        continue
                    what = (("finite" if finite else "non-finite") + f", {start}: "
                            + (solver.breakdown_stages(code) if code else "no step flagged"))
                    here[what] += 1
                    (flagged if finite else broken)[what] += 1
            per_drain.append({"drain": d, "edges": n_edges, "starts": dict(here),
                              "ms_p50": float(np.median(ms))})
            print(f"drain {d}: {repeats} repeats, edges {n_edges}, p50 {np.median(ms):.1f} ms, "
                  f"flagged starts {dict(here)}", flush=True)
    finally:
        undo()
    return {"drains": len(inputs), "solves": solves, "non_finite": dict(broken),
            "finite_flagged": dict(flagged), "drive_broken_drains": m.broken_drains,
            "drive_breakdowns": m.solve_breakdowns, "per_drain": per_drain}


def tcp_runs(roots: list[str], runs: int, device: str) -> list[dict]:
    out = []
    for i in range(runs):
        for root in roots:
            with tempfile.TemporaryDirectory(prefix="tcp_") as tmp:
                env = dict(os.environ, PYTHONPATH=root)
                cmd = [sys.executable, "-m", "scl_slam_tpu_torch.run_multi", "--robots", "2",
                       "--transport", "tcp", "--device", device, "--output", tmp]
                t = time.perf_counter()
                p = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True,
                                   timeout=600)
                secs = time.perf_counter() - t
            lines = p.stdout.strip().splitlines()
            rep = json.loads(lines[-1]) if p.returncode == 0 and lines else {}
            row = {"root": root, "run": i, "rc": p.returncode, "secs": round(secs, 1),
                   "inter_loops": rep.get("inter_loops"), "ate": rep.get("ate_rmse_m"),
                   "nearest_neighbors": rep.get("launches", {}).get("nearest_neighbors"),
                   "broken_drains": rep.get("broken_drains"),
                   "solve_breakdowns": rep.get("solve_breakdowns"),
                   "inter_log": rep.get("inter_log")}
            if p.returncode != 0:
                row["stderr"] = p.stderr[-2000:]
            print(f"tcp {json.dumps(row)}", flush=True)
            out.append(row)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=8)
    ap.add_argument("--tcp-runs", type=int, default=3)
    ap.add_argument("--tcp-roots", default=ROOT,
                    help="comma-separated checkout roots, run in turn (default: this one)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from scl_slam_tpu_torch.ops import kernels

    kernels.build()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    summary = {"drain_probe": drain_probe(torch, "cuda", args.repeats)}
    summary["tcp"] = tcp_runs(args.tcp_roots.split(","), args.tcp_runs, "cuda")
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
