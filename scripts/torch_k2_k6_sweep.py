#!/usr/bin/env python3
"""Launch-geometry sweep of K2 (max image, ``csrc/max_image.cu``) and K6
(RANSAC inlier counts, ``csrc/ransac_counts.cu``) of the PyTorch port on
one NVIDIA GPU.

Run from the root of a checkout on the machine with the card:

    python3 scripts/torch_k2_k6_sweep.py [--quick] [--kernels K2,K6]

Builds the kernels (printing ptxas' registers and stack of both), prints
the floor of a timed launch (a one-element add replayed as a CUDA graph),
then times every geometry of the grids below by CUDA-graph replays, 20
launches to a graph (chip_smoke.time_graph_many: the device's time, by
which the geometries are ranked) and alone (chip_smoke.time_graph, as
PERF.md's rows, which a launch shorter than the host's replay does not
move), at the shapes of chip_smoke.py's phases 4 and 13, and checks each
against the plain version on the same inputs (the image bit-equal, the
counts equal). K2's grid: threads a block, fewest points a block and
blocks aimed for, at
the one-frame shapes on dense_world scans and on bench.py's random scans
(every bin hit), and at LiDAR-Iris's 80 x 360 bins (chip_smoke.py's phase
31 inputs: one frame's 9 channels and a 32-frame batch's 288). K6's: threads a block, blocks aimed for and most
hypotheses a block. Prints one line per
(kernel, shape, geometry), then per shape the five fastest and the
default geometry (``kernels.k2_geometry`` / ``k6_geometry``). ``--quick``
times the default geometries only; ``--kernels`` names the kernels to
sweep (default both). Exits non-zero on a mismatch.
"""
from __future__ import annotations

import argparse
import itertools
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="the default geometries only")
    ap.add_argument("--kernels", default="K2,K6", help="comma-separated kernels to sweep")
    args = ap.parse_args()
    which = set(args.kernels.split(","))
    import torch

    from scl_slam_tpu_torch.ops import kernels as K

    cs.phase_card(torch)
    _, out = K.build(verbose=True)
    lines = out.splitlines()
    for n, line in enumerate(lines):
        if ("max_image_kernel" in line or "ransac_counts_kernel" in line) and "Compiling" in line:
            for follow in lines[n : n + 4]:
                if "registers" in follow or "spill" in follow or "Compiling" in follow:
                    print(f"[ptxas] {follow.strip()}", flush=True)
    K.load_library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    floor, floor_many = cs.launch_floor(torch)
    print(f"floor: one-element add as a graph replay {floor:.4f} ms alone, {floor_many:.4f} ms "
          f"20 to a graph", flush=True)
    bad = 0

    def sweep(name, geoms, default, launch, check, blocks):
        nonlocal bad
        rows = []
        for g in sorted(geoms | {default}):
            try:
                ok = check(launch(g))
            except RuntimeError as e:  # a launch the card refuses
                print(f"{name} {g}: refused ({e})", flush=True)
                continue
            if not ok:
                bad += 1
                print(f"{name} {g}: MISMATCH", flush=True)
                continue
            many = cs.time_graph_many(torch, lambda g=g: launch(g))
            ms = cs.time_graph(torch, lambda g=g: launch(g), reps=30)
            rows.append((many, ms, g))
            print(f"{name} {many:.4f} ms 20 to a graph, {ms:.4f} alone  {blocks(g)} blocks  {g}",
                  flush=True)
        rows.sort()
        for rank, (many, ms, g) in enumerate(rows):
            if rank < 5 or g == default:
                print(f"{name} {'DEFAULT' if g == default else 'BEST'} {many:.4f} ms 20 to a "
                      f"graph, {ms:.4f} alone  {g} (rank {rank + 1} of {len(rows)})", flush=True)

    if "K2" in which:
        grid = list(itertools.product((256, 512, 1024), (512, 1024, 2048, 4096, 8192),
                                      (32, 64, 128, 256, 512)))
        cases = [(label, B, n, kind) for label, B, n, kind, _ in cs.K2_SHAPES]
        cases += [(label + "_bench", B, n, "bench") for label, B, n, kind, _ in cs.K2_SHAPES
                  if kind == "dense"]
        for label, B, n, kind in cases:
            a = cs.k2_inputs(torch, B, n, kind)
            ref = K.max_image_plain(*a)
            geoms = set() if args.quick else {K.k2_geometry(B, n, c) for c in grid}
            sweep(f"K2 {label} {B}x{n}", geoms, K.k2_geometry(B, n),
                  lambda g, a=a: K._launch_max_image(*a, geom=g),
                  lambda img, ref=ref: torch.equal(img, ref), lambda g, B=B: B * g.chunks)
        # LiDAR-Iris's 80 x 360 bins: one frame's 9 channels and a 32-frame
        # replay batch's 288, with longer chunks in the grid (the clear and
        # the flush of 28,800 bins)
        grid = list(itertools.product((256, 512, 1024), (2048, 8192, 14400, 32768, 65536, 131072),
                                      (132, 264)))
        for label, frames in (("iris_live", 1), ("iris_replay", 32)):
            a = cs.iris_k2_inputs(torch, frames, 131072)
            B, n = a[0].shape
            ref = K.max_image_plain(*a)
            geoms = set() if args.quick else {K.k2_geometry(B, n, c) for c in grid}
            sweep(f"K2 {label} {B}x{n} 80x360", geoms, K.k2_geometry(B, n, bins=80 * 360),
                  lambda g, a=a: K._launch_max_image(*a, geom=g),
                  lambda img, ref=ref: torch.equal(img, ref), lambda g, B=B: B * g.chunks)

    if "K6" in which:
        grid = list(itertools.product((128, 256, 512), (sms, 2 * sms, 4 * sms),
                                      (4, 8, 16, 32, 64)))
        for label, B, H, N, _ in cs.K6_SHAPES:
            a, thr2 = cs.ransac_inputs(torch, B, H, N, seed=B + H + N)
            ref = K.ransac_counts_batched_plain(*a, thr2)
            geoms = set() if args.quick else {K.k6_geometry(B, H, N, c) for c in grid}
            sweep(f"K6 {label} {B}x{H}x{N}", geoms, K.k6_geometry(B, H, N),
                  lambda g, a=a, thr2=thr2: K._launch_ransac_counts(*a, thr2, geom=g),
                  lambda c, ref=ref: torch.equal(c, ref),
                  lambda g, B=B: B * g.groups * g.chunks)
    print(f"sweep done: {bad} mismatches", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
