"""Hand-written CUDA kernels of the replay, live, inter-robot and fleet
paths, their plain PyTorch versions, and the build that binds them
(counterpart of ``scl_slam_tpu/ops/pallas_kernels.py``).

========  ==============================  ===================================
kernel    replaces (TPU, Pallas)          source
========  ==============================  ===================================
K1        ``nn_select_batched_pallas``    ``csrc/nn_select_batched.cu``
          (variants ``mineq`` and         (the split-target loop in
          ``argmin``)                     ``csrc/nn_split.cuh``)
K2        ``max_image_pallas`` (exact     ``csrc/max_image.cu``
          here; see the source)
K3        ``nearest_neighbors_pallas``    ``csrc/nn_select.cu`` (shares
                                          K4's kernel)
K4        ``nn_select_pallas``            ``csrc/nn_select.cu``
K5        ``icp_moments_batched_pallas``  ``csrc/icp_moments.cu`` (the
          (variants ``mineq`` and         split-target loop)
          ``argmin``)
K6        ``ransac_counts_batched_pallas``  ``csrc/ransac_counts.cu``
K7        ``nn_index_batched_pallas``     ``csrc/nn_select_batched.cu``
K8        ``nn_select_batched_mxu_pallas``  ``csrc/nn_select_batched.cu``
                                          (the split-target loop)
========  ==============================  ===================================

K5, K7, K8 and K1's argmin body run behind the batched-ICP switches of
``ops/registration.py`` (``FUSED_ICP``, ``NN_INDEX``, ``MXU_NN``,
``SELECT_VARIANT``), as in the JAX package.

Each wrapper takes its plain version for CPU tensors, and only then. On a
CUDA tensor it launches its kernel or raises; nothing falls back. The
kernels are compiled on first use with ``nvcc`` (for ``sm_90a``, with
``-fmad=false`` so no multiply-add is contracted; one ``nvcc`` per source,
all started together, then one link) into a shared library with a plain C
interface under ``_build/``, and loaded with ``ctypes``.
``LAUNCHES`` counts the kernel launches per wrapper (K1 per body), so a
run can show that it went through them.

K1, K7, K8, K4, K3 and K5 run one split-target 1-NN
(``csrc/nn_split.cuh``) with compile-time policies for where a query
comes from, the distance and the finish: their launch geometry comes
from :func:`nn_split_geometry`, and with more than one slice the last
block of a query group to arrive merges them, counted on arrival counters
that each entry point owns (:func:`_arrivals`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC",
)

# kernel launches per wrapper since the last reset_launch_counts()
LAUNCHES = {
    "nn_select_batched": 0, "max_image": 0, "nn_select": 0, "nearest_neighbors": 0,
    "ransac_counts_batched": 0, "nn_select_batched_argmin": 0, "nn_index_batched": 0,
    "nn_select_batched_mxu": 0, "icp_moments_batched": 0,
}

_lib = None
_lib_lock = threading.Lock()


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _headers() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build(verbose: bool = False) -> tuple[Path, str]:
    """Compile ``csrc/*.cu`` into ``_build/`` unless a library built from
    the same sources and flags is already there: one ``nvcc -c`` per
    source, all running at once, then one ``nvcc -shared`` link.

    Returns (library path, compiler output). ``verbose`` adds
    ``-Xptxas -v`` (registers, shared memory and spills per kernel) and
    always rebuilds, so that the output is there to read.
    """
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + _headers():
        h.update(s.name.encode())
        h.update(s.read_bytes())
    lib = BUILD_DIR / f"libscl_kernels_{h.hexdigest()[:16]}.so"
    if lib.exists() and not verbose:
        return lib, ""
    work = BUILD_DIR / f".{lib.stem}.{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    try:
        nvcc = _nvcc()
        extra = ["-Xptxas", "-v"] if verbose else []
        procs = [
            (s, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *extra, "-c", "-o", str(work / f"{s.stem}.o"), str(s)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
            for s in srcs
        ]
        outs, failed = [], []
        for s, proc in procs:
            out, _ = proc.communicate()
            outs.append(out)
            if proc.returncode != 0:
                failed.append(f"{s.name} ({proc.returncode}):\n{out}")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        tmp = work / lib.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *(str(work / f"{s.stem}.o") for s in srcs)],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({link.returncode}):\n{link.stdout}\n{link.stderr}"
            )
        os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib, "".join(outs) + link.stdout + link.stderr


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _lib
    with _lib_lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.scl_nn_select_batched.argtypes = [p] * 9 + [i] * 9 + [p]
            lib.scl_nn_select_batched.restype = i
            lib.scl_nn_index_batched.argtypes = [p] * 8 + [i] * 8 + [p]
            lib.scl_nn_index_batched.restype = i
            lib.scl_nn_select_batched_mxu.argtypes = [p] * 8 + [i] * 8 + [p]
            lib.scl_nn_select_batched_mxu.restype = i
            lib.scl_icp_moments_batched.argtypes = (
                [p] * 12 + [i] * 3 + [ctypes.c_float] + [i] * 6 + [p]
            )
            lib.scl_icp_moments_batched.restype = i
            lib.scl_max_image.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
            lib.scl_max_image.restype = i
            lib.scl_nn_select.argtypes = [p] * 7 + [i] * 8 + [p]
            lib.scl_nn_select.restype = i
            lib.scl_nearest_neighbors.argtypes = [p] * 7 + [i] * 7 + [p]
            lib.scl_nearest_neighbors.restype = i
            lib.scl_ransac_counts_batched.argtypes = [
                p, p, p, p, p, p, i, i, i, ctypes.c_float, i, p,
            ]
            lib.scl_ransac_counts_batched.restype = i
            lib.scl_cuda_error_string.argtypes = [i]
            lib.scl_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check_launch(lib, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.scl_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} ({msg})")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# The split-target 1-NN of K1, K7, K8, K4, K3 and K5 (csrc/nn_split.cuh)
# ---------------------------------------------------------------------------

# streaming multiprocessors of an H100 SXM
_SMS = 132


class SplitGeometry(NamedTuple):
    """A launch of the split-target 1-NN: a grid of (q_groups, slices,
    lanes) blocks of ``threads`` threads; a block holds 32 x ``rq`` queries
    (``rq`` a lane) and the targets [s * slice_len, min(nt, (s + 1) *
    slice_len)) of its slice s, which its warps split in contiguous parts."""

    threads: int
    rq: int
    q_groups: int
    slice_len: int
    slices: int


# (warps a block, queries a lane, warps to aim for, fewest targets a warp),
# chosen by scripts/torch_nn_split_sweep.py on an H100: K1, K7 and K8 at
# about 48 warps an SM (all that fit); K4 and K3 at about 16 (more slices
# cost more in the merge than they gain in the walk), and in smaller blocks
# below 4 M pairs (the live path's coarse pass), where a launch is mostly
# its fixed costs; K5 in one slice at the replay shapes (its finish makes
# the last block's merge dearer), mineq in blocks of 8 warps, argmin of 16
K1_SPLIT = (8, 2, 48 * _SMS, 64)
K5_SPLIT = {"mineq": (8, 2, 16 * _SMS, 256), "argmin": (16, 2, 16 * _SMS, 256)}
K4_SPLIT = (16, 2, 2048, 32)
K4_SPLIT_SMALL = (4, 2, 2048, 64)
_K4_SMALL_PAIRS = 1 << 22


def nn_split_geometry(
    lanes: int, nq: int, nt: int, warps: int, rq: int, want_warps: int,
    min_per_warp: int,
) -> SplitGeometry:
    """The launch geometry for ``lanes`` x ``nq`` queries against ``nt``
    targets (all > 0): enough target slices that the grid reaches about
    ``want_warps`` warps, none giving a warp fewer than ``min_per_warp``
    targets where the target allows one slice more, and none empty. Read
    from the shapes alone: lanes that turn out inactive on the device
    still count."""
    q_groups = -(-nq // (32 * rq))
    slices = max(1, min(-(-want_warps // (q_groups * lanes * warps)),
                        nt // (min_per_warp * warps)))
    slice_len = -(-nt // slices)
    return SplitGeometry(32 * warps, rq, q_groups, slice_len, -(-nt // slice_len))


def k1_geometry(B: int, nq: int, nt: int) -> SplitGeometry:
    """K1's, K7's and K8's launch geometry at [B, Nq] x [B, ., Nt]."""
    return nn_split_geometry(B, nq, nt, *K1_SPLIT)


def k5_geometry(B: int, nq: int, nt: int, variant: str = "mineq") -> SplitGeometry:
    """K5's launch geometry for its ``variant`` body at src4 [B, 4, Nq] x
    payload [B, 4, Nt]."""
    return nn_split_geometry(B, nq, nt, *K5_SPLIT[variant])


def k4_geometry(nq: int, nt: int) -> SplitGeometry:
    """K4's and K3's launch geometry at [Nq] x [Nt]."""
    split = K4_SPLIT if nq * nt >= _K4_SMALL_PAIRS else K4_SPLIT_SMALL
    return nn_split_geometry(1, nq, nt, *split)


# arrival counters of each entry point, per device: the kernel leaves them
# at zero (atomicInc wraps), so they are zeroed once, when made
_ARRIVALS: dict[tuple[str, torch.device], torch.Tensor] = {}


def _arrivals(owner: str, n: int, device: torch.device) -> torch.Tensor:
    """At least ``n`` arrival counters that only ``owner``'s launches use
    (two entry points never share one: a launch of one could otherwise see
    the other's arrivals)."""
    key = (owner, device)
    buf = _ARRIVALS.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _ARRIVALS[key] = buf
    return buf


def _split_scratch(lanes: int, nq: int, g: SplitGeometry, device, sums: bool,
                   owner: str) -> list:
    """The scratch of one launch as [part_d, part_i, part_s, arrivals]:
    None where the launch reads none (all of it with one slice; part_s but
    for the tie average). The tensors may be freed once the launch is
    queued: the allocator reuses memory in stream order."""
    if g.slices == 1:
        return [None] * 4
    return [
        torch.empty((lanes, g.slices, nq), dtype=torch.float32, device=device),
        torch.empty((lanes, g.slices, nq), dtype=torch.int32, device=device),
        torch.empty((lanes, g.slices, 4, nq), dtype=torch.float32, device=device)
        if sums else None,
        _arrivals(owner, lanes * g.q_groups, device),
    ]


def _ptrs(tensors) -> list:
    """Device pointers for ctypes, None for an absent tensor."""
    return [x.data_ptr() if x is not None else None for x in tensors]


# ---------------------------------------------------------------------------
# K1: batched 1-NN + payload selection; K7: its index form; K8: its
# expanded form
# ---------------------------------------------------------------------------

VARIANTS = ("mineq", "argmin")


def _exact_d2(qx, qy, qz, t):
    """``((dx*dx) + (dy*dy)) + (dz*dz)`` of queries [B, Nq, 1] per
    coordinate against targets t [B, >=3, C], in exactly that order."""
    dx = qx - t[:, None, 0]
    dy = qy - t[:, None, 1]
    dz = qz - t[:, None, 2]
    d2 = dx * dx
    d2 = d2 + dy * dy
    return d2 + dz * dz                                     # [B, Nq, C]


def _default_chunk(B: int, nq: int, nt: int, device: torch.device) -> int:
    """Targets per chunk of the plain batched 1-NN: a [B, Nq, chunk]
    transient of 2**24 elements on the card, 2**20 on the CPU (it stays in
    cache there: 2.5-4x faster than 2**24 at 8 x 1,024 x 4,096)."""
    budget = 1 << (24 if device.type == "cuda" else 20)
    return max(1, min(nt, budget // max(1, B * nq)))


def _argmin_walk(query, payload, chunk, d2_of):
    """Running (min d2, lowest index) over the target axis in chunks: the
    first minimum within a chunk, a strict < across chunks; NaN distances
    never win. Returns (best [B, Nq], index [B, Nq] int64)."""
    B, nq, _ = query.shape
    nt = payload.shape[2]
    if chunk is None:
        chunk = _default_chunk(B, nq, nt, query.device)
    dtype, dev = query.dtype, query.device
    best = torch.full((B, nq), float("inf"), dtype=dtype, device=dev)
    arg = torch.zeros((B, nq), dtype=torch.int64, device=dev)
    for c0 in range(0, nt, chunk):
        d2 = d2_of(payload[:, :, c0 : c0 + chunk])
        d2 = torch.where(torch.isnan(d2), float("inf"), d2)
        cmin, carg = torch.min(d2, dim=-1)   # first minimum on ties
        take = cmin < best
        best = torch.where(take, cmin, best)
        arg = torch.where(take, carg + c0, arg)
    return best, arg


def _gather_columns(payload, idx, found):
    """payload [B, P, Nt] columns at idx [B, Nq], 0 where not ``found``."""
    P = payload.shape[1]
    sel = payload.gather(2, idx[:, None, :].expand(-1, P, -1))
    return torch.where(found[:, None], sel, 0.0)


def nn_index_batched_plain(
    query: torch.Tensor,
    payload: torch.Tensor,
    active: torch.Tensor,
    chunk: int | None = None,
):
    """Plain PyTorch version of K7, written from the contract.

    query [B, Nq, 3]; payload [B, P, Nt] (rows 0-2 target xyz, the only
    rows read); active [B]. Returns (d2 [B, Nq], index [B, Nq] int32): d2
    is K1's (bit-equal), index the lowest target index at exactly that d2;
    inactive lanes, and queries no target beats, give (inf, 0).
    """
    qx, qy, qz = (query[:, :, c, None] for c in range(3))   # [B, Nq, 1]
    best, arg = _argmin_walk(
        query, payload, chunk, lambda t: _exact_d2(qx, qy, qz, t)
    )
    lanes = active.to(torch.bool)[:, None]
    found = torch.isfinite(best) & lanes
    return (
        torch.where(lanes, best, float("inf")),
        torch.where(found, arg, 0).to(torch.int32),
    )


def nn_select_batched_plain(
    query: torch.Tensor,
    payload: torch.Tensor,
    active: torch.Tensor,
    variant: str = "mineq",
    chunk: int | None = None,
):
    """Plain PyTorch version of K1, written from the contract.

    query [B, Nq, 3]; payload [B, P, Nt] (rows 0-2 target xyz); active [B].
    Returns (d2 [B, Nq], sel [B, P, Nq]): d2 is the nearest target's
    ``((dx*dx) + (dy*dy)) + (dz*dz)`` in f32, in exactly that order (so it
    is bit-equal to the kernel's); sel is, for ``variant="mineq"``, the
    payload averaged over every target at exactly that d2, for
    ``"argmin"`` the lowest-index such target's column (exact). Inactive
    lanes give (inf, 0). The target axis is walked in chunks so
    [B, Nq, Nt] never exists whole.
    """
    _require(variant in VARIANTS, f"variant must be one of {VARIANTS}, got {variant!r}")
    if variant == "argmin":
        d2, idx = nn_index_batched_plain(query, payload, active, chunk)
        return d2, _gather_columns(payload, idx.long(), torch.isfinite(d2))
    B, nq, _ = query.shape
    P, nt = payload.shape[1], payload.shape[2]
    if chunk is None:
        chunk = _default_chunk(B, nq, nt, query.device)
    dtype, dev = query.dtype, query.device
    qx, qy, qz = (query[:, :, c, None] for c in range(3))   # [B, Nq, 1]
    best = torch.full((B, nq), float("inf"), dtype=dtype, device=dev)
    acc = torch.zeros((B, P, nq), dtype=dtype, device=dev)
    cnt = torch.zeros((B, nq), dtype=dtype, device=dev)
    for c0 in range(0, nt, chunk):
        t = payload[:, :, c0 : c0 + chunk]                  # [B, P, C]
        d2 = _exact_d2(qx, qy, qz, t)                       # [B, Nq, C]
        cmin = d2.min(dim=-1).values
        eq = (d2 == cmin[..., None]).to(dtype)
        # 0/1 weights: each output sums the tied payload values exactly
        # once (the order of that sum is the only freedom)
        csum = torch.einsum("bqc,bpc->bpq", eq, t)
        ccnt = eq.sum(dim=-1)
        take = cmin < best
        tie = (cmin == best) & (cnt > 0)
        acc = torch.where(
            take[:, None], csum, torch.where(tie[:, None], acc + csum, acc)
        )
        cnt = torch.where(take, ccnt, torch.where(tie, cnt + ccnt, cnt))
        best = torch.where(take, cmin, best)
    sel = torch.where(
        (cnt > 0)[:, None], acc / torch.clamp(cnt, min=1.0)[:, None], 0.0
    )
    lanes = active.to(torch.bool)
    d2 = torch.where(lanes[:, None], best, float("inf"))
    sel = torch.where(lanes[:, None, None], sel, 0.0)
    return d2, sel


def _check_batched_nn(query, payload, active) -> None:
    B = query.shape[0]
    _require(query.dim() == 3 and query.shape[2] == 3,
             f"query must be [B, Nq, 3], got {tuple(query.shape)}")
    _require(payload.dim() == 3 and payload.shape[0] == B,
             f"payload must be [B, P, Nt], got {tuple(payload.shape)}")
    _require(active.shape == (B,), f"active must be [B], got {tuple(active.shape)}")
    _require(query.dtype == payload.dtype == torch.float32,
             "query and payload must be float32")
    _require(query.device == payload.device == active.device,
             "query, payload and active must share a device")


def _check_batched_nn_cuda(query, payload) -> None:
    _require(query.device.type == "cuda", f"unsupported device {query.device}")
    _require(payload.shape[1] == 4,
             f"the kernel takes 4 payload rows, got {payload.shape[1]}")
    _require(query.is_contiguous() and payload.is_contiguous(),
             "query and payload must be contiguous")
    B, nq, nt = query.shape[0], query.shape[1], payload.shape[2]
    _require(nt > 0 and B < 65536 and B * 4 * max(nq, nt) < 2**31, "sizes out of range")


def nn_select_batched(
    query: torch.Tensor, payload: torch.Tensor, active: torch.Tensor,
    variant: str = "mineq",
):
    """K1 (see ``csrc/nn_select_batched.cu``): per-lane-predicated batched
    1-NN of query [B, Nq, 3] among payload rows 0-2 of [B, 4, Nt], with the
    winner's payload column: averaged over exact ties (``variant="mineq"``)
    or the lowest index's (``"argmin"``). Returns (d2 [B, Nq],
    sel [B, 4, Nq]); lanes with ``active`` false return (inf, 0)."""
    _check_batched_nn(query, payload, active)
    _require(variant in VARIANTS, f"variant must be one of {VARIANTS}, got {variant!r}")
    if query.device.type == "cpu":
        return nn_select_batched_plain(query, payload, active, variant)
    _check_batched_nn_cuda(query, payload)
    return _launch_nn_select_batched(query, payload, active, variant)


def _launch_nn_select_batched(query, payload, active, variant, geom=None):
    """K1's launch on checked CUDA inputs, at ``geom`` (default
    :func:`k1_geometry`)."""
    B, nq, nt = query.shape[0], query.shape[1], payload.shape[2]
    dev = query.device
    d2 = torch.empty((B, nq), dtype=torch.float32, device=dev)
    sel = torch.empty((B, 4, nq), dtype=torch.float32, device=dev)
    if B == 0 or nq == 0:
        return d2, sel
    g = geom or k1_geometry(B, nq, nt)
    act = active.to(torch.int32).contiguous()
    scratch = _split_scratch(B, nq, g, dev, variant == "mineq", "nn_select_batched")
    lib = load_library()
    rc = lib.scl_nn_select_batched(
        query.data_ptr(), payload.data_ptr(), act.data_ptr(), d2.data_ptr(),
        sel.data_ptr(), *_ptrs(scratch), B, nq, nt, VARIANTS.index(variant),
        g.threads, g.rq, g.slice_len, g.slices, dev.index or 0, _stream(dev),
    )
    _check_launch(lib, rc, "nn_select_batched")
    LAUNCHES["nn_select_batched" if variant == "mineq" else "nn_select_batched_argmin"] += 1
    return d2, sel


def nn_index_batched(
    query: torch.Tensor, payload: torch.Tensor, active: torch.Tensor
):
    """K7 (see ``csrc/nn_select_batched.cu``): K1's 1-NN returning the
    index instead of the payload. query [B, Nq, 3]; payload [B, 4, Nt]
    (rows 0-2 read); active [B]. Returns (d2 [B, Nq], index [B, Nq]
    int32), the lowest index on exact ties; inactive lanes (inf, 0)."""
    _check_batched_nn(query, payload, active)
    if query.device.type == "cpu":
        return nn_index_batched_plain(query, payload, active)
    _check_batched_nn_cuda(query, payload)
    return _launch_nn_index_batched(query, payload, active)


def _launch_nn_index_batched(query, payload, active, geom=None):
    """K7's launch on checked CUDA inputs, at ``geom`` (default
    :func:`k1_geometry`)."""
    B, nq, nt = query.shape[0], query.shape[1], payload.shape[2]
    dev = query.device
    d2 = torch.empty((B, nq), dtype=torch.float32, device=dev)
    idx = torch.empty((B, nq), dtype=torch.int32, device=dev)
    if B == 0 or nq == 0:
        return d2, idx
    g = geom or k1_geometry(B, nq, nt)
    act = active.to(torch.int32).contiguous()
    part_d, part_i, _, arrivals = _split_scratch(B, nq, g, dev, False, "nn_index_batched")
    lib = load_library()
    rc = lib.scl_nn_index_batched(
        query.data_ptr(), payload.data_ptr(), act.data_ptr(), d2.data_ptr(),
        idx.data_ptr(), *_ptrs((part_d, part_i, arrivals)), B, nq, nt,
        g.threads, g.rq, g.slice_len, g.slices, dev.index or 0, _stream(dev),
    )
    _check_launch(lib, rc, "nn_index_batched")
    LAUNCHES["nn_index_batched"] += 1
    return d2, idx


def nn_select_batched_mxu_plain(
    query: torch.Tensor,
    payload: torch.Tensor,
    active: torch.Tensor,
    chunk: int | None = None,
):
    """Plain PyTorch version of K8, written from the contract.

    K1's argmin contract with d2 by the expanded form, elementwise in
    exactly the kernel's order (no matmul, which would reorder the sum):
    ``qq = (q0*q0 + q1*q1) + q2*q2``, ``c = (q0*t0 + q1*t1) + q2*t2``,
    ``tt`` as ``qq``, ``d2 = (qq - 2*c) + tt``. Returns (max(min d2, 0)
    [B, Nq], sel [B, P, Nq]): the lowest index at the min wins; inactive
    lanes give (inf, 0). Selection order only: the caller recentres the
    clouds first and recomputes the winner's exact distance.
    """
    qx, qy, qz = (query[:, :, c, None] for c in range(3))   # [B, Nq, 1]
    qq = (qx * qx + qy * qy) + qz * qz

    def d2_of(t):
        tx, ty, tz = (t[:, None, c] for c in range(3))      # [B, 1, C]
        tt = (tx * tx + ty * ty) + tz * tz
        c = (qx * tx + qy * ty) + qz * tz
        return (qq - 2.0 * c) + tt

    best, arg = _argmin_walk(query, payload, chunk, d2_of)
    lanes = active.to(torch.bool)[:, None]
    found = torch.isfinite(best) & lanes
    d2 = torch.where(lanes, torch.clamp(best, min=0.0), float("inf"))
    return d2, _gather_columns(payload, arg, found)


def nn_select_batched_mxu(
    query: torch.Tensor, payload: torch.Tensor, active: torch.Tensor
):
    """K8 (see ``csrc/nn_select_batched.cu``): K1's argmin contract with
    d2 by the expanded form, for selection order only. query [B, Nq, 3];
    payload [B, 4, Nt]; active [B]. Returns (approximate d2 [B, Nq],
    sel [B, 4, Nq]); inactive lanes (inf, 0)."""
    _check_batched_nn(query, payload, active)
    if query.device.type == "cpu":
        return nn_select_batched_mxu_plain(query, payload, active)
    _check_batched_nn_cuda(query, payload)
    return _launch_nn_select_batched_mxu(query, payload, active)


def _launch_nn_select_batched_mxu(query, payload, active, geom=None):
    """K8's launch on checked CUDA inputs, at ``geom`` (default
    :func:`k1_geometry`)."""
    B, nq, nt = query.shape[0], query.shape[1], payload.shape[2]
    dev = query.device
    d2 = torch.empty((B, nq), dtype=torch.float32, device=dev)
    sel = torch.empty((B, 4, nq), dtype=torch.float32, device=dev)
    if B == 0 or nq == 0:
        return d2, sel
    g = geom or k1_geometry(B, nq, nt)
    act = active.to(torch.int32).contiguous()
    part_d, part_i, _, arrivals = _split_scratch(B, nq, g, dev, False, "nn_select_batched_mxu")
    lib = load_library()
    rc = lib.scl_nn_select_batched_mxu(
        query.data_ptr(), payload.data_ptr(), act.data_ptr(), d2.data_ptr(),
        sel.data_ptr(), *_ptrs((part_d, part_i, arrivals)), B, nq, nt,
        g.threads, g.rq, g.slice_len, g.slices, dev.index or 0, _stream(dev),
    )
    _check_launch(lib, rc, "nn_select_batched_mxu")
    LAUNCHES["nn_select_batched_mxu"] += 1
    return d2, sel


# ---------------------------------------------------------------------------
# K5: one fused batched ICP iteration -> Kabsch moments
# ---------------------------------------------------------------------------

# moment slots of the [B, 18] output (the TPU kernel's M_* layout)
M_W = 0          # sum w                      (w = correspondence accepted)
M_S = 1          # 1:4   sum w * s            (s = pose-transformed source)
M_D = 4          # 4:7   sum w * d            (d = matched target point)
M_CROSS = 7      # 7:16  sum w * s_a * d_b    (row-major 3x3)
M_WD2 = 16       # sum w * d2                 (fitness numerator)
M_NSRC = 17      # count of valid source points (inlier_frac denominator)
M_SLOTS = 18


def k5_sum_roundings(g: SplitGeometry, variant: str = "mineq") -> int:
    """The most roundings a term of K5 passes through on its way into its
    sum, in the kernel's order at geometry ``g`` (``csrc/icp_moments.cu``):
    its own product (1), the ``rq`` queries of a lane in order (rq - 1),
    the 32-lane shuffle tree (5), the warps (0: they merge nearest
    neighbours, not sums), the tie average of a mineq selection summed
    range by range (2: within 2 ulp of the payload, chip_smoke.TIE_ULPS),
    then the lane's query groups in ascending order (q_groups - 1). A
    float32 sum whose every term passes through at most d roundings is
    within about d * 2**-24 of their absolute mass of the exact sum."""
    return 1 + (g.rq - 1) + 5 + (2 if variant == "mineq" else 0) + (g.q_groups - 1)


def icp_moments_terms_plain(
    src4: torch.Tensor,
    payload: torch.Tensor,
    R: torch.Tensor,
    t: torch.Tensor,
    active: torch.Tensor,
    max_corr_dist: float,
    variant: str = "mineq",
) -> torch.Tensor:
    """The per-query terms [B, Nq, 18] that K5 sums, in float32, each as
    the kernel forms it (so a check can also take their exact sum and
    their absolute mass).

    src4 [B, 4, Nq] (local source xyz rows + validity row); payload
    [B, 4, Nt]; R [B, 3, 3], t [B, 3]; active [B]. Each source point moves
    by its lane's pose in the kernel's direct form,
    ``((R_i0*x + R_i1*y) + R_i2*z) + t_i``; its 1-NN with selection is
    K1's plain version (``variant``); good = valid source & selected
    validity > 0.5 & d2 < max_corr_dist**2; the terms are 0 where not
    good (the last, n_src, where the source point is invalid), and 0 on
    inactive lanes.
    """
    x, y, z = src4[:, 0], src4[:, 1], src4[:, 2]                   # [B, Nq]
    moved = [((R[:, i, 0, None] * x + R[:, i, 1, None] * y) + R[:, i, 2, None] * z)
             + t[:, i, None] for i in range(3)]                    # 3 x [B, Nq]
    d2, sel = nn_select_batched_plain(torch.stack(moved, dim=-1), payload, active, variant)
    lanes = active.to(torch.bool)[:, None]
    valid = (src4[:, 3] > 0.5) & lanes
    good = valid & (sel[:, 3] > 0.5) & (d2 < max_corr_dist * max_corr_dist)
    zero = torch.zeros((), dtype=src4.dtype, device=src4.device)

    def w(v):
        return torch.where(good, v, zero)

    cols = [good.to(src4.dtype)] + [w(moved[a]) for a in range(3)]
    cols += [w(sel[:, a]) for a in range(3)]
    cols += [w(moved[a] * sel[:, b]) for a in range(3) for b in range(3)]
    cols += [w(d2), valid.to(src4.dtype)]
    return torch.stack(cols, dim=-1)


def icp_moments_batched_plain(
    src4: torch.Tensor,
    payload: torch.Tensor,
    R: torch.Tensor,
    t: torch.Tensor,
    active: torch.Tensor,
    max_corr_dist: float,
    variant: str = "mineq",
) -> torch.Tensor:
    """Plain PyTorch version of K5, written from the contract: the sums
    over the query axis of :func:`icp_moments_terms_plain`, [B, 18] in the
    M_* layout (inactive lanes zeros), taken in torch's order, not the
    kernel's."""
    return icp_moments_terms_plain(
        src4, payload, R, t, active, max_corr_dist, variant
    ).sum(dim=1)


def icp_moments_batched(
    src4: torch.Tensor,
    payload: torch.Tensor,
    R: torch.Tensor,
    t: torch.Tensor,
    active: torch.Tensor,
    max_corr_dist: float,
    variant: str = "mineq",
) -> torch.Tensor:
    """K5 (see ``csrc/icp_moments.cu``): one batched ICP iteration per
    lane (transform, 1-NN with selection as K1's ``variant``, gate)
    reduced to the 18 weighted Kabsch moment sums [B, 18] (M_* layout).
    src4 [B, 4, Nq]; payload [B, 4, Nt]; R [B, 3, 3]; t [B, 3]; active
    [B]; inactive lanes return zeros."""
    B = src4.shape[0]
    _require(src4.dim() == 3 and src4.shape[1] == 4,
             f"src4 must be [B, 4, Nq], got {tuple(src4.shape)}")
    _require(payload.dim() == 3 and payload.shape[:2] == (B, 4),
             f"payload must be [B, 4, Nt], got {tuple(payload.shape)}")
    _require(R.shape == (B, 3, 3) and t.shape == (B, 3),
             f"R, t must be [B, 3, 3], [B, 3], got {tuple(R.shape)}, {tuple(t.shape)}")
    _require(active.shape == (B,), f"active must be [B], got {tuple(active.shape)}")
    _require(all(x.dtype == torch.float32 for x in (src4, payload, R, t)),
             "src4, payload, R and t must be float32")
    _require(all(x.device == src4.device for x in (payload, R, t, active)),
             "inputs must share a device")
    _require(variant in VARIANTS, f"variant must be one of {VARIANTS}, got {variant!r}")
    if src4.device.type == "cpu":
        return icp_moments_batched_plain(src4, payload, R, t, active, max_corr_dist, variant)
    _require(src4.device.type == "cuda", f"unsupported device {src4.device}")
    _require(all(x.is_contiguous() for x in (src4, payload, R, t)),
             "src4, payload, R and t must be contiguous")
    nq, nt = src4.shape[2], payload.shape[2]
    _require(nt > 0 and B < 65536 and B * 4 * max(nq, nt) < 2**31, "sizes out of range")
    return _launch_icp_moments_batched(
        src4, payload, R, t, active, float(max_corr_dist) ** 2, variant
    )


def _launch_icp_moments_batched(src4, payload, R, t, active, maxd2, variant, geom=None):
    """K5's launch on checked CUDA inputs, at ``geom`` (default
    :func:`k5_geometry`)."""
    B, nq, nt = src4.shape[0], src4.shape[2], payload.shape[2]
    dev = src4.device
    if B == 0 or nq == 0:
        return torch.zeros((B, M_SLOTS), dtype=torch.float32, device=dev)
    g = geom or k5_geometry(B, nq, nt, variant)
    act = active.to(torch.int32).contiguous()
    scratch = _split_scratch(B, nq, g, dev, variant == "mineq", "icp_moments_batched")
    # each query group's sums, and the lanes' arrival counters for their sum
    rows = torch.empty((B, g.q_groups, M_SLOTS), dtype=torch.float32, device=dev)
    groups = _arrivals("icp_moments_batched_groups", B, dev)
    m = torch.empty((B, M_SLOTS), dtype=torch.float32, device=dev)
    lib = load_library()
    rc = lib.scl_icp_moments_batched(
        src4.data_ptr(), payload.data_ptr(), R.data_ptr(), t.data_ptr(), act.data_ptr(),
        *_ptrs(scratch), *_ptrs((rows, groups, m)), B, nq, nt, maxd2,
        VARIANTS.index(variant), g.threads, g.rq, g.slice_len, g.slices,
        dev.index or 0, _stream(dev),
    )
    _check_launch(lib, rc, "icp_moments_batched")
    LAUNCHES["icp_moments_batched"] += 1
    return m


# ---------------------------------------------------------------------------
# K2: bin-wise max image
# ---------------------------------------------------------------------------


def max_image_plain(
    values: torch.Tensor,
    ring: torch.Tensor,
    sector: torch.Tensor,
    valid: torch.Tensor,
    num_rings: int,
    num_sectors: int,
) -> torch.Tensor:
    """Plain PyTorch version of K2: [B, N] points -> [B, R, S] image of
    per-bin maxima over an all-zero image (so empty bins and non-positive
    values read 0). Points with an out-of-range bin are ignored."""
    B, n = values.shape
    nb = num_rings * num_sectors
    ok = (
        valid & (values > 0)
        & (ring >= 0) & (ring < num_rings)
        & (sector >= 0) & (sector < num_sectors)
    )
    flat = torch.where(ok, ring.long() * num_sectors + sector.long(), nb)
    vals = torch.where(ok, values, 0.0)
    img = torch.zeros((B, nb + 1), dtype=values.dtype, device=values.device)
    img.scatter_reduce_(1, flat, vals, "amax", include_self=True)
    return img[:, :nb].reshape(B, num_rings, num_sectors)


def max_image(
    values: torch.Tensor,
    ring: torch.Tensor,
    sector: torch.Tensor,
    valid: torch.Tensor,
    num_rings: int,
    num_sectors: int,
) -> torch.Tensor:
    """K2 (see ``csrc/max_image.cu``): exact bin-wise max image.

    values [B, N] f32; ring, sector [B, N] int32; valid [B, N] bool.
    Returns [B, num_rings, num_sectors]."""
    _require(values.dim() == 2, f"values must be [B, N], got {tuple(values.shape)}")
    for name, x in (("ring", ring), ("sector", sector), ("valid", valid)):
        _require(x.shape == values.shape,
                 f"{name} must be {tuple(values.shape)}, got {tuple(x.shape)}")
        _require(x.device == values.device, f"{name} must be on {values.device}")
    _require(values.dtype == torch.float32, "values must be float32")
    _require(ring.dtype == sector.dtype == torch.int32,
             "ring and sector must be int32")
    _require(valid.dtype == torch.bool, "valid must be bool")
    _require(num_rings > 0 and num_sectors > 0, "empty image")
    if values.device.type == "cpu":
        return max_image_plain(values, ring, sector, valid, num_rings, num_sectors)
    _require(values.device.type == "cuda", f"unsupported device {values.device}")
    _require(num_rings * num_sectors <= 4096, "the kernel holds at most 4096 bins")
    _require(
        all(x.is_contiguous() for x in (values, ring, sector, valid)),
        "inputs must be contiguous",
    )
    B, n = values.shape
    _require(B * max(n, num_rings * num_sectors) < 2**31, "sizes out of range")
    out = torch.empty(
        (B, num_rings, num_sectors), dtype=torch.float32, device=values.device
    )
    if B == 0:
        return out
    lib = load_library()
    rc = lib.scl_max_image(
        values.data_ptr(), ring.data_ptr(), sector.data_ptr(), valid.data_ptr(),
        out.data_ptr(), B, n, num_rings, num_sectors,
        values.device.index or 0, _stream(values.device),
    )
    _check_launch(lib, rc, "max_image")
    LAUNCHES["max_image"] += 1
    return out


# ---------------------------------------------------------------------------
# K4: solo 1-NN + payload selection (argmin ties)
# ---------------------------------------------------------------------------

def nn_select_plain(
    query: torch.Tensor, payload: torch.Tensor, chunk: int | None = None
):
    """Plain PyTorch version of K4, written from the contract.

    query [Nq, 3]; payload [P, Nt] (rows 0-2 target xyz). Returns
    (d2 [Nq], sel [P, Nq]): d2 is the nearest target's
    ``((dx*dx) + (dy*dy)) + (dz*dz)`` in f32, in exactly that order (so it is
    bit-equal to the kernel's), clamped at 0; sel is the payload column of
    the lowest target index at exactly that d2. A query that no target
    beats (no target, or only NaN distances) gives (inf, 0). The target
    axis is walked in chunks so [Nq, Nt] never exists whole: the first
    minimum within a chunk, a strict < across chunks.
    """
    nq = query.shape[0]
    P, nt = payload.shape
    if chunk is None:
        chunk = max(1, min(nt, (1 << 24) // max(1, nq)))
    dtype, dev = query.dtype, query.device
    best = torch.full((nq,), float("inf"), dtype=dtype, device=dev)
    if nt == 0:
        return best, torch.zeros((P, nq), dtype=dtype, device=dev)
    qx, qy, qz = (query[:, c, None] for c in range(3))       # [Nq, 1]
    arg = torch.zeros((nq,), dtype=torch.int64, device=dev)
    for c0 in range(0, nt, chunk):
        t = payload[:3, c0 : c0 + chunk]                       # [3, C]
        dx = qx - t[None, 0]
        dy = qy - t[None, 1]
        dz = qz - t[None, 2]
        d2 = dx * dx
        d2 = d2 + dy * dy
        d2 = d2 + dz * dz                                      # [Nq, C]
        d2 = torch.where(torch.isnan(d2), float("inf"), d2)
        cmin, carg = torch.min(d2, dim=-1)   # first minimum on ties
        take = cmin < best
        best = torch.where(take, cmin, best)
        arg = torch.where(take, carg + c0, arg)
    found = torch.isfinite(best)
    sel = torch.where(found[None], payload[:, arg], 0.0)
    d2 = torch.where(found, torch.clamp(best, min=0.0), float("inf"))
    return d2, sel


def nn_select(query: torch.Tensor, payload: torch.Tensor):
    """K4 (see ``csrc/nn_select.cu``): 1-NN of query [Nq, 3] among payload
    rows 0-2 of [P, Nt], with the winner's payload column (lowest index on
    exact ties). Returns (d2 [Nq], sel [P, Nq])."""
    _require(query.dim() == 2 and query.shape[1] == 3,
             f"query must be [Nq, 3], got {tuple(query.shape)}")
    _require(payload.dim() == 2 and payload.shape[0] >= 3,
             f"payload must be [P >= 3, Nt], got {tuple(payload.shape)}")
    _require(query.dtype == payload.dtype == torch.float32,
             "query and payload must be float32")
    _require(query.device == payload.device, "query and payload must share a device")
    if query.device.type == "cpu":
        return nn_select_plain(query, payload)
    _require(query.device.type == "cuda", f"unsupported device {query.device}")
    _require(query.is_contiguous() and payload.is_contiguous(),
             "query and payload must be contiguous")
    nq = query.shape[0]
    P, nt = payload.shape
    _require(P * max(nq, nt) < 2**31, "sizes out of range")
    dev = query.device
    if nq == 0 or nt == 0:
        return (
            torch.full((nq,), float("inf"), dtype=torch.float32, device=dev),
            torch.zeros((P, nq), dtype=torch.float32, device=dev),
        )
    return _launch_nn_select(query, payload)


def _launch_nn_select(query, payload, geom=None):
    """K4's launch on checked CUDA inputs (Nq, Nt > 0), at ``geom``
    (default :func:`k4_geometry`)."""
    nq = query.shape[0]
    P, nt = payload.shape
    dev = query.device
    d2 = torch.empty((nq,), dtype=torch.float32, device=dev)
    sel = torch.empty((P, nq), dtype=torch.float32, device=dev)
    g = geom or k4_geometry(nq, nt)
    part_d, part_i, _, arrivals = _split_scratch(1, nq, g, dev, False, "nn_select")
    lib = load_library()
    rc = lib.scl_nn_select(
        query.data_ptr(), payload.data_ptr(), *_ptrs((part_d, part_i, arrivals)),
        d2.data_ptr(), sel.data_ptr(), nq, nt, P, g.threads, g.rq, g.slice_len,
        g.slices, dev.index or 0, _stream(dev),
    )
    _check_launch(lib, rc, "nn_select")
    LAUNCHES["nn_select"] += 1
    return d2, sel


# ---------------------------------------------------------------------------
# K3: solo 1-NN (distance and index, argmin ties)
# ---------------------------------------------------------------------------


def nearest_neighbors_plain(
    query: torch.Tensor, target: torch.Tensor, chunk: int | None = None
):
    """Plain PyTorch version of K3, written from the contract.

    query [Nq, 3]; target [Nt, 3]. Returns (d2 [Nq] f32, index [Nq] int32):
    d2 is the nearest target's ``((dx*dx) + (dy*dy)) + (dz*dz)`` in f32, in
    exactly that order (bit-equal to the kernel's), clamped at 0; index is
    the lowest target index at exactly that d2. A query that no target
    beats (no target, or only NaN distances) gives (inf, 0). The target
    axis is walked in chunks as in :func:`nn_select_plain`.
    """
    nq, nt = query.shape[0], target.shape[0]
    if chunk is None:
        chunk = max(1, min(nt, (1 << 24) // max(1, nq)))
    dtype, dev = query.dtype, query.device
    best = torch.full((nq,), float("inf"), dtype=dtype, device=dev)
    arg = torch.zeros((nq,), dtype=torch.int64, device=dev)
    qx, qy, qz = (query[:, c, None] for c in range(3))       # [Nq, 1]
    for c0 in range(0, nt, chunk):
        t = target[c0 : c0 + chunk]                            # [C, 3]
        dx = qx - t[None, :, 0]
        dy = qy - t[None, :, 1]
        dz = qz - t[None, :, 2]
        d2 = dx * dx
        d2 = d2 + dy * dy
        d2 = d2 + dz * dz                                      # [Nq, C]
        d2 = torch.where(torch.isnan(d2), float("inf"), d2)
        cmin, carg = torch.min(d2, dim=-1)   # first minimum on ties
        take = cmin < best
        best = torch.where(take, cmin, best)
        arg = torch.where(take, carg + c0, arg)
    found = torch.isfinite(best)
    d2 = torch.where(found, torch.clamp(best, min=0.0), float("inf"))
    return d2, torch.where(found, arg, 0).to(torch.int32)


def nearest_neighbors(query: torch.Tensor, target: torch.Tensor):
    """K3 (see ``csrc/nn_select.cu``): 1-NN of query [Nq, 3] among target
    [Nt, 3], lowest index on exact ties. Returns (d2 [Nq] f32, index [Nq]
    int32)."""
    _require(query.dim() == 2 and query.shape[1] == 3,
             f"query must be [Nq, 3], got {tuple(query.shape)}")
    _require(target.dim() == 2 and target.shape[1] == 3,
             f"target must be [Nt, 3], got {tuple(target.shape)}")
    _require(query.dtype == target.dtype == torch.float32,
             "query and target must be float32")
    _require(query.device == target.device, "query and target must share a device")
    if query.device.type == "cpu":
        return nearest_neighbors_plain(query, target)
    _require(query.device.type == "cuda", f"unsupported device {query.device}")
    _require(query.is_contiguous() and target.is_contiguous(),
             "query and target must be contiguous")
    nq, nt = query.shape[0], target.shape[0]
    _require(3 * max(nq, nt) < 2**31, "sizes out of range")
    dev = query.device
    if nq == 0 or nt == 0:
        return (
            torch.full((nq,), float("inf"), dtype=torch.float32, device=dev),
            torch.zeros((nq,), dtype=torch.int32, device=dev),
        )
    return _launch_nearest_neighbors(query, target)


def _launch_nearest_neighbors(query, target, geom=None):
    """K3's launch on checked CUDA inputs (Nq, Nt > 0), at ``geom``
    (default :func:`k4_geometry`)."""
    nq, nt = query.shape[0], target.shape[0]
    dev = query.device
    d2 = torch.empty((nq,), dtype=torch.float32, device=dev)
    idx = torch.empty((nq,), dtype=torch.int32, device=dev)
    g = geom or k4_geometry(nq, nt)
    part_d, part_i, _, arrivals = _split_scratch(1, nq, g, dev, False, "nearest_neighbors")
    lib = load_library()
    rc = lib.scl_nearest_neighbors(
        query.data_ptr(), target.data_ptr(), *_ptrs((part_d, part_i, arrivals)),
        d2.data_ptr(), idx.data_ptr(), nq, nt, g.threads, g.rq, g.slice_len,
        g.slices, dev.index or 0, _stream(dev),
    )
    _check_launch(lib, rc, "nearest_neighbors")
    LAUNCHES["nearest_neighbors"] += 1
    return d2, idx


# ---------------------------------------------------------------------------
# K6: batched RANSAC hypothesis scoring
# ---------------------------------------------------------------------------


def ransac_counts_batched_plain(
    source: torch.Tensor,
    matched: torch.Tensor,
    good: torch.Tensor,
    R: torch.Tensor,
    t: torch.Tensor,
    thr2: float,
    chunk: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of K6, written from the contract.

    source, matched [B, N, 3]; good [B, N] bool; hypotheses R [B, H, 3, 3],
    t [B, H, 3]. Returns counts [B, H] int32: the points with ``good`` and
    ``res2 < thr2``, where ``m_i = ((R_i0*x + R_i1*y) + R_i2*z) + t_i`` and
    ``res2 = ((dx*dx) + (dy*dy)) + (dz*dz)``, elementwise in exactly that
    order (no matmul, so the counts equal the kernel's). The hypothesis
    axis is walked in chunks so the [B, Hc, N] transient stays bounded.
    """
    B, n, _ = source.shape
    H = R.shape[1]
    if chunk is None:
        chunk = max(1, min(H, (1 << 22) // max(1, B * n)))
    x, y, z = (source[:, None, :, c] for c in range(3))       # [B, 1, N]
    gd = good[:, None, :]
    out = []
    for h0 in range(0, H, chunk):
        Rc, tc = R[:, h0 : h0 + chunk], t[:, h0 : h0 + chunk]  # [B, Hc, ...]
        res2 = None
        for i in range(3):
            m = ((Rc[..., i, 0, None] * x + Rc[..., i, 1, None] * y)
                 + Rc[..., i, 2, None] * z) + tc[..., i, None]   # [B, Hc, N]
            d = m - matched[:, None, :, i]
            res2 = d * d if res2 is None else res2 + d * d
        out.append(((res2 < thr2) & gd).sum(dim=-1, dtype=torch.int32))
    if not out:
        return torch.zeros((B, 0), dtype=torch.int32, device=source.device)
    return torch.cat(out, dim=1)


def ransac_counts_batched(
    source: torch.Tensor,
    matched: torch.Tensor,
    good: torch.Tensor,
    R: torch.Tensor,
    t: torch.Tensor,
    thr2: float,
) -> torch.Tensor:
    """K6 (see ``csrc/ransac_counts.cu``): inlier counts [B, H] int32 of
    hypotheses (R [B, H, 3, 3], t [B, H, 3]) over the correspondences
    source/matched [B, N, 3] with validity ``good`` [B, N]."""
    _require(source.dim() == 3 and source.shape[2] == 3,
             f"source must be [B, N, 3], got {tuple(source.shape)}")
    B, n = source.shape[:2]
    _require(matched.shape == source.shape,
             f"matched must be {tuple(source.shape)}, got {tuple(matched.shape)}")
    _require(good.shape == (B, n) and good.dtype == torch.bool,
             f"good must be [B, N] bool, got {tuple(good.shape)} {good.dtype}")
    _require(R.dim() == 4 and R.shape[0] == B and R.shape[2:] == (3, 3),
             f"R must be [B, H, 3, 3], got {tuple(R.shape)}")
    H = R.shape[1]
    _require(t.shape == (B, H, 3), f"t must be [B, H, 3], got {tuple(t.shape)}")
    _require(all(x.dtype == torch.float32 for x in (source, matched, R, t)),
             "source, matched, R and t must be float32")
    _require(all(x.device == source.device for x in (matched, good, R, t)),
             "inputs must share a device")
    if source.device.type == "cpu":
        return ransac_counts_batched_plain(source, matched, good, R, t, thr2)
    _require(source.device.type == "cuda", f"unsupported device {source.device}")
    _require(all(x.is_contiguous() for x in (source, matched, good, R, t)),
             "inputs must be contiguous")
    _require(B < 65536 and B * max(n, H) * 9 < 2**31, "sizes out of range")
    counts = torch.empty((B, H), dtype=torch.int32, device=source.device)
    if B == 0 or H == 0:
        return counts
    if n == 0:
        return counts.zero_()
    lib = load_library()
    dev = source.device
    rc = lib.scl_ransac_counts_batched(
        source.data_ptr(), matched.data_ptr(), good.data_ptr(), R.data_ptr(),
        t.data_ptr(), counts.data_ptr(), B, n, H, float(thr2), dev.index or 0,
        _stream(dev),
    )
    _check_launch(lib, rc, "ransac_counts_batched")
    LAUNCHES["ransac_counts_batched"] += 1
    return counts
