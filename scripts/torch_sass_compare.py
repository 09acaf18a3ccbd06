#!/usr/bin/env python3
"""Compares the machine code (SASS) of the split-target kernel's
instantiations (``nn_split_kernel`` in ``scl_slam_tpu_torch/csrc/
nn_split.cuh``) between two checkouts of the PyTorch port, on a machine
with the CUDA toolkit:

    python3 scripts/torch_sass_compare.py <checkout A> <checkout B>

Each checkout's ``csrc/nn_select_batched.cu`` and ``csrc/nn_select.cu``
(K1, K7, K8, K4, K3) is compiled to a cubin with the build's flags
(``kernels.NVCC_FLAGS``) and disassembled with ``cuobjdump``; each
instantiation of one is matched with the other's by its template
arguments, leaving out the default policy ``NnOp`` (which an older
checkout's kernel does not name), and the two instruction streams are
compared without their addresses and encodings. Prints IDENTICAL or
DIFFERENT per matched instantiation (and, for the first that differs, the
lines that differ) and those found in one checkout only; exits non-zero
if any matched pair differs.
"""
from __future__ import annotations

import difflib
import os
import re
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from scl_slam_tpu_torch.ops import kernels  # noqa: E402

SOURCES = ("nn_select_batched", "nn_select")


def disassemble(tool_dir: str, cubin: str) -> dict[str, list[str]]:
    """{mangled function name: its instructions}."""
    out = subprocess.run([os.path.join(tool_dir, "cuobjdump"), "-sass", cubin],
                         capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            ins = re.sub(r"/\*[0-9a-f]{4,}\*/|/\* 0x[0-9a-f]+ \*/", "", line)
            funcs[name].append(ins.strip().rstrip(";").strip())
    return funcs


def split_kernels(tool_dir: str, funcs: dict) -> dict[str, list[str]]:
    """{template arguments without NnOp: instructions} of nn_split_kernel."""
    names = list(funcs)
    demangled = subprocess.run([os.path.join(tool_dir, "cu++filt")], input="\n".join(names),
                               capture_output=True, text=True, check=True).stdout.splitlines()
    res = {}
    for name, pretty in zip(names, demangled):
        m = re.search(r"nn_split_kernel<(.*)>\(", pretty)
        if m:
            key = re.sub(r"scl::(<unnamed>|\(anonymous namespace\))::NnOp, ", "", m.group(1))
            res[key] = funcs[name]
    return res


def main() -> int:
    a, b = (os.path.abspath(x) for x in sys.argv[1:3])
    nvcc = kernels._nvcc()
    tool_dir = os.path.dirname(nvcc)
    differ = 0
    with tempfile.TemporaryDirectory() as work:
        for src in SOURCES:
            cubins = []
            for tag, root in (("a", a), ("b", b)):
                cubin = os.path.join(work, f"{tag}-{src}.cubin")
                subprocess.run([nvcc, *kernels.NVCC_FLAGS, "-cubin", "-o", cubin,
                                os.path.join(root, "scl_slam_tpu_torch", "csrc", f"{src}.cu")],
                               check=True)
                cubins.append(split_kernels(tool_dir, disassemble(tool_dir, cubin)))
            ka, kb = cubins
            for key in sorted(set(ka) | set(kb)):
                if key not in ka or key not in kb:
                    where = "B" if key in kb else "A"
                    print(f"{src}: {key}: in {where} only", flush=True)
                    continue
                same = ka[key] == kb[key]
                print(f"{src}: {key}: {'IDENTICAL' if same else 'DIFFERENT'} "
                      f"({len(ka[key])} and {len(kb[key])} instructions)", flush=True)
                if not same and not differ:
                    diff = [line for line in difflib.unified_diff(ka[key], kb[key], lineterm="", n=0)
                            if line[:1] in "+-" and line[:3] not in ("+++", "---")]
                    print("\n".join(diff[:40]), flush=True)
                differ += not same
    print(f"differing instantiations: {differ}", flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
