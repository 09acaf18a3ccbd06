// K4: solo 1-NN + payload selection, lowest index on exact ties ("argmin"),
// and K3: solo 1-NN (distance and index), which shares K4's kernel.
//
// K4 replaces scl_slam_tpu/ops/pallas_kernels.py::nn_select_pallas (kernel
// body _nn_select_kernel). It runs in every iteration of the solo ICP of the
// live path (ops/registration.py::nearest_select, called by _icp_stage and by
// the final fitness pass of icp).
//
// K3 replaces pallas_kernels.py::nearest_neighbors_pallas (kernel body
// _nn_kernel). It runs once in every inter-robot geometric verification
// (ops/registration.py::nearest_neighbors, called by ransac_align on the
// server side of the verification RPC). Its contract is K4's without the
// payload: d[q] as below, idx[q] = the lowest target index at exactly that d,
// and a query that no target beats gives (inf, 0). Its target is [Nt, 3]
// (xyz interleaved) where K4's payload is [P, Nt]: the kernel reads either
// layout through a (row, column) stride pair.
//
// Contract (the plain version is ops/kernels.py::nn_select_plain):
//   query [Nq, 3], payload [P, Nt] (rows 0-2 target xyz with invalid points
//   already far away, rows 3.. any per-point extras: validity, normals, ...).
//   d[q]      = min over targets of ((dx*dx) + (dy*dy)) + (dz*dz), each step
//               rounded to f32 (the build passes -fmad=false and the
//               arithmetic is spelled with _rn intrinsics, so d is bit-equal
//               to the plain version and to the TPU kernel's exact
//               per-coordinate f32), clamped at 0;
//   sel[:, q] = the payload column of the LOWEST target index at exactly that
//               d (the TPU kernel's argmin within a tile and strict < across
//               tiles give the same winner);
//   a query that no target beats (no target, or only NaN distances) keeps
//   d = inf and sel = 0.
//
// What bounds it on the H100: instruction issue. Each (query, target) pair
// costs three subtract-multiply steps, two adds and a compare in plain FP32,
// each its own instruction (-fmad=false): half the stated FP32 bound, which
// counts a multiply-add as two, is the ceiling. The live path's
// full-resolution pass is 1,024 x 16,384 = 16.8 M pairs, its coarse pass
// 256 x 4,096; K3's verification pass is 4,096 x 8,192 at the default
// configuration (33.6 M pairs).
//
// Design: both run the split-target 1-NN of csrc/nn_split.cuh on one lane:
// a grid of (query groups, target slices), each warp walking a contiguous
// part of its slice for 64 queries held two to a lane, double-buffered
// tiles staged by cp.async, the parts' (min d2, lowest index) merged in
// shared memory and the slices' by the last block of a query group to
// arrive, in ascending order with a strict <; that block then gathers the
// winner's payload column (K4) or writes its index (K3). One launch a call;
// each entry point owns its arrival counters (ops/kernels.py), and the
// scratch may be null with one slice.
#include <cuda_runtime.h>
#include <stdint.h>

#include "nn_split.cuh"

extern "C" int scl_nn_select(const float* query, const float* payload,
                             float* part_d, int32_t* part_i,
                             uint32_t* arrivals, float* d_out, float* sel_out,
                             int nq, int nt, int rows, int threads, int rq,
                             int slice_len, int slices, int device,
                             void* stream) {
  if (!scl::split_geometry_ok(nt, threads, slice_len, slices)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  scl::SplitArgs a{};
  a.query = query;
  a.target = {payload, 0, static_cast<size_t>(nt), 1};
  a.active = nullptr;
  a.nq = nq;
  a.nt = nt;
  a.slice_len = slice_len;
  a.slices = slices;
  a.part_d = part_d;
  a.part_i = part_i;
  a.part_s = nullptr;
  a.arrivals = arrivals;
  a.d_out = d_out;
  a.sel_out = sel_out;
  a.sel_rows = rows;
  a.idx_out = nullptr;
  a.clamp = true;
  return static_cast<int>(scl::launch_split<scl::Pick::kLowest>(
      a, 1, threads, rq, static_cast<cudaStream_t>(stream)));
}

// K3: target [Nt, 3] (row stride 1, column stride 3).
extern "C" int scl_nearest_neighbors(const float* query, const float* target,
                                     float* part_d, int32_t* part_i,
                                     uint32_t* arrivals, float* d_out,
                                     int32_t* idx_out, int nq, int nt,
                                     int threads, int rq, int slice_len,
                                     int slices, int device, void* stream) {
  if (!scl::split_geometry_ok(nt, threads, slice_len, slices)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  scl::SplitArgs a{};
  a.query = query;
  a.target = {target, 0, 1, 3};
  a.active = nullptr;
  a.nq = nq;
  a.nt = nt;
  a.slice_len = slice_len;
  a.slices = slices;
  a.part_d = part_d;
  a.part_i = part_i;
  a.part_s = nullptr;
  a.arrivals = arrivals;
  a.d_out = d_out;
  a.sel_out = nullptr;
  a.sel_rows = 0;
  a.idx_out = idx_out;
  a.clamp = true;
  return static_cast<int>(scl::launch_split<scl::Pick::kLowest>(
      a, 1, threads, rq, static_cast<cudaStream_t>(stream)));
}


