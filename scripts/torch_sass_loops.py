#!/usr/bin/env python3
"""Counts the instructions of the loops in the machine code (SASS) of one
kernel source of the PyTorch port, on a machine with the CUDA toolkit:

    python3 scripts/torch_sass_loops.py ransac_counts [--function "kernel<(bool)1>"]

Compiles ``scl_slam_tpu_torch/csrc/<source>.cu`` to a cubin with the
build's flags (``kernels.NVCC_FLAGS``), disassembles it with ``cuobjdump``
and, for each function whose demangled name holds ``--function``, prints
every loop (the instructions from a backward branch's target to the
branch) with its length and its opcodes by count, so that a kernel's
instructions per unit of work can be read off the code the card runs.
"""
from __future__ import annotations

import argparse
import collections
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from scl_slam_tpu_torch.ops import kernels  # noqa: E402
from torch_sass_compare import disassemble  # noqa: E402


def loops(ins: list[str]) -> list[tuple[int, int]]:
    """(first, last) instruction indices of each loop: a branch to an
    address at or before its own (instructions are 16 bytes)."""
    out = []
    for i, line in enumerate(ins):
        m = re.search(r"\bBRA\s+(0x[0-9a-f]+)", line)
        if m and int(m.group(1), 16) // 16 <= i:
            out.append((int(m.group(1), 16) // 16, i))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("source", help="a csrc/*.cu file's stem, e.g. ransac_counts")
    ap.add_argument("--function", default="", help="a part of the demangled kernel names")
    args = ap.parse_args()
    nvcc = kernels._nvcc()
    tool_dir = os.path.dirname(nvcc)
    with tempfile.TemporaryDirectory() as work:
        cubin = os.path.join(work, f"{args.source}.cubin")
        subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-cubin", "-o", cubin,
                        str(kernels.CSRC_DIR / f"{args.source}.cu")], check=True)
        funcs = disassemble(tool_dir, cubin)
    names = list(funcs)
    pretty = subprocess.run([os.path.join(tool_dir, "cu++filt")], input="\n".join(names),
                            capture_output=True, text=True, check=True).stdout.splitlines()
    for name, shown in sorted(zip(names, pretty), key=lambda x: x[1]):
        if args.function not in shown:
            continue
        ins = funcs[name]
        print(f"{shown}: {len(ins)} instructions", flush=True)
        for first, last in loops(ins):
            ops = collections.Counter(
                re.sub(r"^@!?U?P\w+\s+", "", x).split()[0].split(".")[0] for x in ins[first:last + 1]
            )
            hist = ", ".join(f"{op} {n}" for op, n in ops.most_common())
            print(f"  loop [{first * 16:#x}, {last * 16:#x}]: {last - first + 1} instructions: "
                  f"{hist}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
