"""Hand-written CUDA kernels of the replay and live paths, their plain
PyTorch versions, and the build that binds them (counterpart of
``scl_slam_tpu/ops/pallas_kernels.py``).

========  ==============================  ===================================
kernel    replaces (TPU, Pallas)          source
========  ==============================  ===================================
K1        ``nn_select_batched_pallas``    ``csrc/nn_select_batched.cu``
          (variant ``mineq``)
K2        ``max_image_pallas`` (exact     ``csrc/max_image.cu``
          here; see the source)
K4        ``nn_select_pallas``            ``csrc/nn_select.cu``
========  ==============================  ===================================

Each wrapper takes its plain version for CPU tensors, and only then. On a
CUDA tensor it launches its kernel or raises; nothing falls back. The
kernels are compiled on first use with ``nvcc`` (for ``sm_90a``, with
``-fmad=false`` so no multiply-add is contracted) into a shared library
with a plain C interface under ``_build/``, and loaded with ``ctypes``.
``LAUNCHES`` counts the kernel launches per wrapper, so a run can show that
it went through them (K4 is two launches, a partial pass and a reduction,
counted as one call).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

# kernel launches per wrapper since the last reset_launch_counts()
LAUNCHES = {"nn_select_batched": 0, "max_image": 0, "nn_select": 0}

_lib = None
_lib_lock = threading.Lock()


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


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
    the same sources and flags is already there.

    Returns (library path, compiler output). ``verbose`` adds
    ``-Xptxas -v`` (registers, shared memory and spills per kernel) and
    always rebuilds, so that the output is there to read.
    """
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    lib = BUILD_DIR / f"libscl_kernels_{h.hexdigest()[:16]}.so"
    if lib.exists() and not verbose:
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS]
    if verbose:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", str(tmp), *map(str, srcs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib, proc.stdout + proc.stderr


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process."""
    global _lib
    with _lib_lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.scl_nn_select_batched.argtypes = [p, p, p, p, p, i, i, i, i, p]
            lib.scl_nn_select_batched.restype = i
            lib.scl_max_image.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
            lib.scl_max_image.restype = i
            lib.scl_nn_select.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p]
            lib.scl_nn_select.restype = i
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
# K1: batched 1-NN + payload selection
# ---------------------------------------------------------------------------


def nn_select_batched_plain(
    query: torch.Tensor,
    payload: torch.Tensor,
    active: torch.Tensor,
    chunk: int | None = None,
):
    """Plain PyTorch version of K1, written from the contract.

    query [B, Nq, 3]; payload [B, P, Nt] (rows 0-2 target xyz); active [B].
    Returns (d2 [B, Nq], sel [B, P, Nq]): d2 is the nearest target's
    ``((dx*dx) + (dy*dy)) + (dz*dz)`` in f32, in exactly that order (so it
    is bit-equal to the kernel's); sel averages the payload over every
    target at exactly that d2; inactive lanes give (inf, 0). The target
    axis is walked in chunks so [B, Nq, Nt] never exists whole.
    """
    B, nq, _ = query.shape
    P, nt = payload.shape[1], payload.shape[2]
    if chunk is None:
        chunk = max(1, min(nt, (1 << 24) // max(1, B * nq)))
    dtype, dev = query.dtype, query.device
    qx, qy, qz = (query[:, :, c, None] for c in range(3))   # [B, Nq, 1]
    best = torch.full((B, nq), float("inf"), dtype=dtype, device=dev)
    acc = torch.zeros((B, P, nq), dtype=dtype, device=dev)
    cnt = torch.zeros((B, nq), dtype=dtype, device=dev)
    for c0 in range(0, nt, chunk):
        t = payload[:, :, c0 : c0 + chunk]                  # [B, P, C]
        dx = qx - t[:, None, 0]
        dy = qy - t[:, None, 1]
        dz = qz - t[:, None, 2]
        d2 = dx * dx
        d2 = d2 + dy * dy
        d2 = d2 + dz * dz                                   # [B, Nq, C]
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


def nn_select_batched(
    query: torch.Tensor, payload: torch.Tensor, active: torch.Tensor
):
    """K1 (see ``csrc/nn_select_batched.cu``): per-lane-predicated batched
    1-NN of query [B, Nq, 3] among payload rows 0-2 of [B, 4, Nt], with the
    winner's (tie-averaged) payload column. Returns (d2 [B, Nq],
    sel [B, 4, Nq]); lanes with ``active`` false return (inf, 0)."""
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
    if query.device.type == "cpu":
        return nn_select_batched_plain(query, payload, active)
    _require(query.device.type == "cuda", f"unsupported device {query.device}")
    _require(payload.shape[1] == 4,
             f"the kernel takes 4 payload rows, got {payload.shape[1]}")
    _require(query.is_contiguous() and payload.is_contiguous(),
             "query and payload must be contiguous")
    nq, nt = query.shape[1], payload.shape[2]
    _require(nt > 0 and B * 4 * max(nq, nt) < 2**31, "sizes out of range")
    act = active.to(torch.int32).contiguous()
    d2 = torch.empty((B, nq), dtype=torch.float32, device=query.device)
    sel = torch.empty((B, 4, nq), dtype=torch.float32, device=query.device)
    if B == 0 or nq == 0:
        return d2, sel
    lib = load_library()
    rc = lib.scl_nn_select_batched(
        query.data_ptr(), payload.data_ptr(), act.data_ptr(),
        d2.data_ptr(), sel.data_ptr(), B, nq, nt,
        query.device.index or 0, _stream(query.device),
    )
    _check_launch(lib, rc, "nn_select_batched")
    LAUNCHES["nn_select_batched"] += 1
    return d2, sel


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

# pass 1 of the CUDA kernel: 128 queries per block (csrc/nn_select.cu)
_K4_QUERY_BLOCK = 128
# blocks of pass 1 to aim for: two per SM of an H100 (132 SMs)
_K4_TARGET_BLOCKS = 264
# fewest targets per chunk, so the shared-memory tile loads stay amortized
_K4_MIN_CHUNK = 128


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


def _k4_chunking(nq: int, nt: int) -> tuple[int, int]:
    """(targets per chunk, chunks) for pass 1: enough blocks to fill the
    card, no chunk below ``_K4_MIN_CHUNK`` targets."""
    q_blocks = -(-nq // _K4_QUERY_BLOCK)
    want = -(-_K4_TARGET_BLOCKS // q_blocks)
    chunks = max(1, min(want, nt // _K4_MIN_CHUNK))
    chunk = -(-nt // chunks)
    return chunk, -(-nt // chunk)


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
    d2 = torch.empty((nq,), dtype=torch.float32, device=dev)
    sel = torch.empty((P, nq), dtype=torch.float32, device=dev)
    chunk, chunks = _k4_chunking(nq, nt)
    part_d = torch.empty((chunks, nq), dtype=torch.float32, device=dev)
    part_i = torch.empty((chunks, nq), dtype=torch.int32, device=dev)
    lib = load_library()
    rc = lib.scl_nn_select(
        query.data_ptr(), payload.data_ptr(), part_d.data_ptr(),
        part_i.data_ptr(), d2.data_ptr(), sel.data_ptr(), nq, nt, P, chunk,
        chunks, dev.index or 0, _stream(dev),
    )
    _check_launch(lib, rc, "nn_select")
    LAUNCHES["nn_select"] += 1
    return d2, sel
