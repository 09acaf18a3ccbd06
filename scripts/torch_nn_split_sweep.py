#!/usr/bin/env python3
"""Launch-geometry sweep of the split-target 1-NN kernels of the PyTorch
port (K1 both bodies, K7, K8, K4, K3, K5 both bodies:
``scl_slam_tpu_torch/csrc/nn_split.cuh``) on one NVIDIA GPU.

Run from the root of a checkout on the machine with the card:

    python3 scripts/torch_nn_split_sweep.py [--quick] [--kernels K5,K8]

Builds the kernels (printing ptxas' registers and stack of the split
kernels), prints the floor of a timed launch (a one-element add replayed
as a CUDA graph, alone and 20 to a graph) and K4's fixed costs (1,024
queries against 64 targets in 1, 2 and 8 slices), then for each kernel at the
shapes of its main path times every geometry of the grid below by
CUDA-graph replays (chip_smoke.time_graph, as PERF.md's rows) and checks
each against the plain version on the same inputs (d2 and index or
selection bit-equal; K1-mineq's selection within chip_smoke.TIE_ULPS; K5
its counts equal and every sum within chip_smoke.K5_MASS_TOL of its
terms' mass). Prints one line per (kernel, shape, geometry) and, per
shape, the fastest geometry and the default one (``kernels.k1_geometry``
/ ``k4_geometry`` / ``k5_geometry``), the default also with 20 launches
captured in one graph (the device time without the host's cost between
replays). The inputs are chip_smoke.py's (planted ties, padded targets,
inactive lanes; K5's and K8's tie-free, as phases 18 and 20).
``--quick`` times the default geometries only; ``--kernels`` names the
kernels to sweep (default all). Exits non-zero on a mismatch.
"""
from __future__ import annotations

import argparse
import itertools
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def sel_tol(payload) -> float:
    scale = payload[:, :3][payload[:, :3] < 1e5].abs().max().item()
    return cs.TIE_ULPS * 2.0 ** (np.floor(np.log2(scale)) - 23)


def graph_multi(torch, fn, n: int = 20, reps: int = 10) -> float:
    """ms a call with ``n`` calls captured in one CUDA graph (no host cost
    between them)."""
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="the default geometries only")
    ap.add_argument("--kernels", default="K1,K7,K4,K3,K5,K8",
                    help="comma-separated kernels to sweep")
    args = ap.parse_args()
    which = set(args.kernels.split(","))
    import torch

    from scl_slam_tpu_torch.ops import kernels as K

    cs.phase_card(torch)
    _, out = K.build(verbose=True)
    lines = out.splitlines()
    for n, line in enumerate(lines):
        if "nn_split_kernel" in line and "Compiling entry" in line:
            for follow in lines[n : n + 4]:
                if "registers" in follow or "spill" in follow or "Compiling" in follow:
                    print(f"[ptxas] {follow.strip()}", flush=True)
    K.load_library()

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # (warps a block, queries a lane, warps to aim for, fewest targets a warp)
    grid = [(w, rq, ww * sms, mw) for w, rq, ww, mw in
            itertools.product((4, 8, 16), (2, 4), (16, 32, 48), (32, 64, 128, 256))]
    bad = 0

    one = torch.zeros(1, device="cuda")
    print(f"floor: one-element add {cs.time_graph(torch, lambda: one.add_(1), reps=50):.4f} ms, "
          f"20 to a graph {graph_multi(torch, lambda: one.add_(1)):.4f} ms each", flush=True)
    # K4's fixed costs: 1,024 queries against 64 targets, in 1 slice (no
    # merge across blocks) and in 2 and 8 (the arrival and the merge)
    q, p, _ = cs.k4_inputs(torch, 1024, 64, 4, seed=1)
    for slices in (1, 2, 8):
        g = K.SplitGeometry(512, 2, 16, -(-64 // slices), slices)
        ms = cs.time_graph(torch, lambda g=g: K._launch_nn_select(q, p, g), reps=50)
        print(f"floor: K4 1024x64 in {slices} slices {ms:.4f} ms", flush=True)

    def sweep(name, shape, lanes, nq, nt, active_lanes, launch, plain, check, default):
        nonlocal bad
        if name.split("-")[0] not in which:
            return
        ref = plain()
        geoms = {default}
        if not args.quick:
            geoms |= {K.nn_split_geometry(lanes, nq, nt, *c) for c in grid}
        rows = []
        for g in sorted(geoms):
            out = launch(g)
            torch.cuda.synchronize()
            why = check(out, ref)
            ms = cs.time_graph(torch, lambda g=g: launch(g), reps=20)
            blocks = g.q_groups * g.slices * active_lanes
            tag = " default" if g == default else ""
            print(f"{name} {shape} warps {g.threads // 32} rq {g.rq} slices {g.slices} x "
                  f"{g.slice_len}: {ms:.4f} ms, {blocks} working blocks, "
                  f"{blocks * g.threads / 32 / sms:.1f} warps/SM{tag}"
                  f"{' MISMATCH ' + why if why else ''}", flush=True)
            bad += bool(why)
            rows.append((ms, g))
        best_ms, best = min(rows)
        dflt = next(ms for ms, g in rows if g == default)
        multi = graph_multi(torch, lambda: launch(default))
        print(f"== {name} {shape}: fastest {best_ms:.4f} ms at {tuple(best)}; default "
              f"{dflt:.4f} ms at {tuple(default)}, 20 to a graph {multi:.4f} ms each",
              flush=True)

    def eq(a, b, what):
        return "" if torch.equal(a, b) else f"{what} {(a != b).sum().item()}"

    # K1 both bodies and K7 at the replay shapes and the fleet RANSAC's
    for B, nq, nt in ((32, 1024, 8192), (32, 256, 2048), (16, 1024, 8192)):
        q, p, act = cs.k1_inputs(torch, B, nq, nt, seed=nq + B)
        n_act = int(act.sum().item())
        tol = sel_tol(p)
        default = K.k1_geometry(B, nq, nt)
        shape = f"{B}x{nq}x{nt}"

        def check_mineq(out, ref):
            return eq(out[0], ref[0], "d2") or (
                "" if (out[1] - ref[1]).abs().max().item() <= tol else "sel")

        def check_exact(out, ref):
            return eq(out[0], ref[0], "d2") or eq(out[1], ref[1], "sel/index")

        sweep("K1-mineq", shape, B, nq, nt, n_act,
              lambda g: K._launch_nn_select_batched(q, p, act, "mineq", g),
              lambda: K.nn_select_batched_plain(q, p, act), check_mineq, default)
        sweep("K1-argmin", shape, B, nq, nt, n_act,
              lambda g: K._launch_nn_select_batched(q, p, act, "argmin", g),
              lambda: K.nn_select_batched_plain(q, p, act, "argmin"), check_exact, default)
        if nq == 1024:
            sweep("K7", shape, B, nq, nt, n_act,
                  lambda g: K._launch_nn_index_batched(q, p, act, g),
                  lambda: K.nn_index_batched_plain(q, p, act), check_exact, default)

    # K4 at the live shapes, K3 at the verification shapes
    for nq, nt, P in ((1024, 16384, 4), (256, 4096, 4), (1024, 16384, 8)):
        q, p, _ = cs.k4_inputs(torch, nq, nt, P, seed=nq + P)
        sweep("K4", f"{nq}x{nt} P={P}", 1, nq, nt, 1,
              lambda g: K._launch_nn_select(q, p, g), lambda: K.nn_select_plain(q, p),
              lambda out, ref: eq(out[0], ref[0], "d2") or eq(out[1], ref[1], "sel"),
              K.k4_geometry(nq, nt))
    for nq, nt in ((4096, 8192), (256, 4096), (4096, 16384)):
        q, t, _, _ = cs.k3_inputs(torch, nq, nt, seed=nq + nt)
        sweep("K3", f"{nq}x{nt}", 1, nq, nt, 1,
              lambda g: K._launch_nearest_neighbors(q, t, g),
              lambda: K.nearest_neighbors_plain(q, t),
              lambda out, ref: eq(out[0], ref[0], "d2") or eq(out[1], ref[1], "index"),
              K.k4_geometry(nq, nt))
    # K8 at the replay shape, on recentred coordinates (phase 20's inputs)
    B, nq, nt = 32, 1024, 8192
    q, p, act = cs.tie_free_inputs(torch, B, nq, nt, seed=8, recentre=True)
    sweep("K8", f"{B}x{nq}x{nt}", B, nq, nt, int(act.sum().item()),
          lambda g: K._launch_nn_select_batched_mxu(q, p, act, g),
          lambda: K.nn_select_batched_mxu_plain(q, p, act),
          lambda out, ref: eq(out[0], ref[0], "d2") or eq(out[1], ref[1], "sel"),
          K.k1_geometry(B, nq, nt))

    # K5 both bodies at the replay's two ICP stage shapes (phase 18's inputs)
    for B, nq, nt in ((32, 1024, 8192), (32, 256, 2048)):
        k5 = cs.k5_inputs(torch, B, nq, nt, seed=nq + 5)
        n_act = int(k5[4].sum().item())
        for variant in ("mineq", "argmin"):
            terms = K.icp_moments_terms_plain(*k5, 3.0, variant=variant).double()
            exact, mass = terms.sum(dim=1), terms.abs().sum(dim=1)

            def launch(g, v=variant):
                return K._launch_icp_moments_batched(*k5, 9.0, v, g)

            def check_k5(out, ref, exact=exact, mass=mass):
                counts = [K.M_W, K.M_NSRC]
                if not torch.equal(out[:, counts], ref[:, counts]):
                    return "counts"
                err = ((out.double() - exact).abs() / mass.clamp(min=1e-300)).max().item()
                return "" if err <= cs.K5_MASS_TOL else f"mass error {err:.3g}"

            sweep(f"K5-{variant}", f"{B}x{nq}x{nt}", B, nq, nt, n_act, launch,
                  lambda v=variant: K.icp_moments_batched_plain(*k5, 3.0, variant=v),
                  check_k5, K.k5_geometry(B, nq, nt, variant))
    print(f"mismatches: {bad}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
