#!/usr/bin/env python3
"""Times K1 (mineq), K4 and K3 of a checkout of the PyTorch port with that
checkout's own chip_smoke.py phases 3, 7 and 10, on one NVIDIA GPU, and
prints one JSON line of milliseconds.

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
import sys


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from scl_slam_tpu_torch.ops import kernels

    kernels.load_library()
    with contextlib.redirect_stdout(io.StringIO()):
        res = {"K1": cs.phase_k1(torch, kernels), "K4": cs.phase_k4(torch, kernels),
               "K3": cs.phase_k3(torch, kernels)}
    out = {"checkout": sys.argv[1]}
    for name, by_label in res.items():
        for label, r in by_label.items():
            out[f"{name} {label}"] = round(r["ms"], 4)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
