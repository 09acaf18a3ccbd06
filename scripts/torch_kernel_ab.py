#!/usr/bin/env python3
"""Times K1 (mineq), K4, K3, K7 and K1-argmin, K5 (both bodies) and K8 of
a checkout of the PyTorch port with that checkout's own chip_smoke.py
phases 3, 7, 10, 19, 18 and 20 (each also checks its kernels against the
plain versions, and raises on a mismatch), then K2 and K6 at the shapes of
phases 4 and 13 of the chip_smoke.py beside this script (its inputs and
checks, the checkout's kernels: bit-equal images, equal counts), on one
NVIDIA GPU, and prints one JSON line of milliseconds (K2 and K6 also
with 20 launches to a graph, keys ending in " 20"). K5-argmin's times
are read from phase 18's printed lines (its result holds the mineq body's
only).

With ``--e2e`` it runs instead the end-to-end phases 5 (``Mapper.replay``
at the bench configuration), 9 (the live path at the
``kitti_velodyne.yaml`` widths and one solve at 4,096 poses) and 14 (the
fleet bench) of the chip_smoke.py beside this script on the checkout's
package, each with its own checks, and prints one JSON line of the
numbers they return: replay frames/s (median of 5), live-kitti ms a
keyframe (p50, p99), solve ms, fleet frames/s (median of 5).

Used to compare two commits within one machine session, in turns:

    git archive <parent> | tar -x -C _archive/parent   # a gitignored dir
    for r in _archive/parent . . _archive/parent; do
        python3 scripts/torch_kernel_ab.py $r [--e2e]
    done
"""
import argparse
import contextlib
import importlib.util
import io
import json
import os
import re
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def end_to_end(torch, kernels, here) -> dict:
    """Phases 5, 9 and 14 of ``here`` (their log lines go to stderr)."""
    with contextlib.redirect_stdout(sys.stderr):
        replay = here.phase_slice(torch, kernels, here.BenchReplay(torch))
        kitti = here.phase_live_kitti(torch, kernels)
        fleet = here.phase_fleet_bench(torch, kernels)
    return {"replay_frames_per_s": replay["frames_per_s"], "live_kitti_p50_ms": kitti["p50_ms"],
            "live_kitti_p99_ms": kitti["p99_ms"], "solve_ms": kitti["solve_ms"],
            "fleet_frames_per_s": fleet["fleet_frames_per_s"]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkout", help="root of the checkout whose kernels are timed")
    ap.add_argument("--e2e", action="store_true", help="phases 5, 9 and 14 instead")
    opts = ap.parse_args()
    root = os.path.abspath(opts.checkout)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from scl_slam_tpu_torch.ops import kernels

    # phases 4, 13 (and 5, 9, 14) as this script's checkout runs them
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  os.path.join(HERE, "chip_smoke.py"))
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)

    kernels.load_library()
    if opts.e2e:
        out = {"checkout": opts.checkout, **end_to_end(torch, kernels, here)}
        print(json.dumps(out), flush=True)
        return 0
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        res = {"K1": cs.phase_k1(torch, kernels), "K4": cs.phase_k4(torch, kernels),
               "K3": cs.phase_k3(torch, kernels), "K5-mineq": cs.phase_k5(torch, kernels)}
        k7 = cs.phase_k7(torch, kernels)
        k8 = cs.phase_k8(torch, kernels)
    res["K7"] = {label: r["k7"] for label, r in k7.items()}
    res["K1-argmin"] = {label: r["k1_argmin"] for label, r in k7.items()}
    res["K8"] = {"replay": k8}
    res["K2"] = {label: here.k2_case(torch, kernels, here.k2_inputs(torch, B, n, kind), full=False)
                 for label, B, n, kind, _ in here.K2_SHAPES}
    res["K6"] = {}
    for label, B, H, N, _ in here.K6_SHAPES:
        args, thr2 = here.ransac_inputs(torch, B, H, N, seed=B + H + N)
        res["K6"][label] = here.k6_case(torch, kernels, args, thr2, full=False)
    floor, floor_many = here.launch_floor(torch)
    out = {"checkout": opts.checkout, "floor": round(floor, 4), "floor 20": round(floor_many, 4)}
    for name, by_label in res.items():
        for label, r in by_label.items():
            out[f"{name} {label}"] = round(r["ms"], 4)
            if "many_ms" in r:  # K1, K2 and K6: also 20 launches to a graph
                out[f"{name} {label} 20"] = round(r["many_ms"], 4)
    for label, ms in re.findall(r"\[18\] K5 (\w+) .*?argmin kernel ([0-9.]+) ms",
                                printed.getvalue()):
        out[f"K5-argmin {label}"] = float(ms)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
