#!/usr/bin/env python3
"""Times K1 (mineq), K4, K3, K7 and K1-argmin, K5 (both bodies) and K8 of
a checkout of the PyTorch port with that checkout's own chip_smoke.py
phases 3, 7, 10, 19, 18 and 20 (each also checks its kernels against the
plain versions, and raises on a mismatch), on one NVIDIA GPU, and prints
one JSON line of milliseconds. K5-argmin's times are read from phase
18's printed lines (its result holds the mineq body's only).

Used to compare two commits within one machine session, in turns:

    git archive <parent> | tar -x -C _archive/parent   # a gitignored dir
    for r in _archive/parent . . _archive/parent; do
        python3 scripts/torch_kernel_ab.py $r
    done
"""
import contextlib
import io
import json
import os
import re
import sys


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from scl_slam_tpu_torch.ops import kernels

    kernels.load_library()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        res = {"K1": cs.phase_k1(torch, kernels), "K4": cs.phase_k4(torch, kernels),
               "K3": cs.phase_k3(torch, kernels), "K5-mineq": cs.phase_k5(torch, kernels)}
        k7 = cs.phase_k7(torch, kernels)
        k8 = cs.phase_k8(torch, kernels)
    res["K7"] = {label: r["k7"] for label, r in k7.items()}
    res["K1-argmin"] = {label: r["k1_argmin"] for label, r in k7.items()}
    res["K8"] = {"replay": k8}
    out = {"checkout": sys.argv[1]}
    for name, by_label in res.items():
        for label, r in by_label.items():
            out[f"{name} {label}"] = round(r["ms"], 4)
    for label, ms in re.findall(r"\[18\] K5 (\w+) .*?argmin kernel ([0-9.]+) ms",
                                printed.getvalue()):
        out[f"K5-argmin {label}"] = float(ms)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
