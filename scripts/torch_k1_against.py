#!/usr/bin/env python3
"""Runs chip_smoke.py's bench replay (phase 5's workload) on one NVIDIA GPU
with every K1 (mineq) call also computed by another checkout's kernel and
by the plain version on the same inputs, and prints one JSON line: the
calls, the d2 elements that differ, and the selection elements that differ
between each pair (and by how much, and in which payload row).

    python3 scripts/torch_k1_against.py _archive/parent   # a gitignored dir
"""
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    import chip_smoke as cs
    from scl_slam_tpu_torch.ops import kernels as K

    other = os.path.join(os.path.abspath(sys.argv[1]), "scl_slam_tpu_torch/ops/kernels.py")
    spec = importlib.util.spec_from_file_location("other_kernels", other)
    OK = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(OK)
    stats = {"calls": 0, "d2": 0, "sel_this_other": 0, "sel_this_plain": 0,
             "sel_other_plain": 0, "max_this_other": 0.0, "rows": [0, 0, 0, 0]}
    real = K.nn_select_batched

    def compared(q, p, a, variant="mineq"):
        d, s = real(q, p, a, variant)
        if variant == "mineq":
            d_o, s_o = OK.nn_select_batched(q, p, a)
            _, s_p = K.nn_select_batched_plain(q, p, a)
            diff = s != s_o
            stats["calls"] += 1
            stats["d2"] += int((d != d_o).sum())
            stats["sel_this_other"] += int(diff.sum())
            stats["sel_this_plain"] += int((s != s_p).sum())
            stats["sel_other_plain"] += int((s_o != s_p).sum())
            if diff.any():
                stats["max_this_other"] = max(stats["max_this_other"],
                                              float((s - s_o).abs()[diff].max()))
                for r in range(4):
                    stats["rows"][r] += int(diff[:, r].sum())
        return d, s

    K.nn_select_batched = compared
    K.reset_launch_counts()
    cs.BenchReplay(torch).run()
    stats["launches"] = K.LAUNCHES["nn_select_batched"]
    print(json.dumps(stats), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
