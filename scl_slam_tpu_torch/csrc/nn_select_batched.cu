// K1: per-lane-predicated batched 1-NN + payload selection (both bodies),
// K7: the same 1-NN returning the index (no payload), and
// K8: K1's argmin contract with d2 by the expanded form.
//
// K1 replaces scl_slam_tpu/ops/pallas_kernels.py::nn_select_batched_pallas,
// with its default body _nn_select_batched_mineq_kernel ("mineq") and its
// body _nn_select_batched_kernel ("argmin", SELECT_VARIANT="argmin"). It
// runs in every ICP iteration of the keyframe replay path and of the fleet's
// intra ICP, in their exact final pass, and in the fleet RANSAC's 1-NN
// (ops/registration.py::_matches_batched) under the default switches.
// K7 replaces nn_index_batched_pallas (body _nn_index_batched_kernel): the
// 1-NN of _matches_batched under NN_INDEX, the caller gathering the payload.
// K8 replaces nn_select_batched_mxu_pallas (body
// _nn_select_batched_mxu_kernel): the non-exact 1-NN of _matches_batched
// under MXU_NN, on coordinates the caller has recentred.
//
// Contracts (the plain versions are ops/kernels.py::nn_select_batched_plain,
// nn_index_batched_plain and nn_select_batched_mxu_plain):
//   query [B, Nq, 3], payload [B, 4, Nt] (rows 0-2 target xyz, row 3
//   validity), active [B] int32; lanes with active == 0 write (inf, 0)
//   and do no work.
//   K1 d[b, q] = min over targets of ((dx*dx) + (dy*dy)) + (dz*dz) (each
//      step rounded to f32: csrc/batched_nn.cuh), bit-equal to the plain
//      version and to the TPU kernel's exact per-coordinate f32;
//      sel[b, :, q] = mineq: the payload column of the nearest target,
//      averaged over every target at exactly that d (the TPU kernel
//      averages exact ties within a target tile, and at the replay path's
//      shapes its tile is the whole target); argmin: the lowest-index
//      nearest target's column, exactly.
//   K7 d as K1; idx[b, q] int32 = the lowest index at that d (0 without a
//      winner).
//   K8 d2 = (qq - 2*c) + tt with qq = (q0*q0 + q1*q1) + q2*q2,
//      c = (q0*t0 + q1*t1) + q2*t2 and tt = (t0*t0 + t1*t1) + t2*t2, every
//      step rounded to f32 in that order (the cross term is computed here,
//      in FP32, not by a library product: a product would reorder the
//      sum), so it is bit-equal to the plain version; the winner is the
//      lowest index at the min, d[b, q] = max(min d2, 0), and sel its
//      payload column. The expanded form loses ~eps * |coords|^2 to
//      cancellation: its d is for selection order only, the caller
//      recomputes the winner's exact distance.
//
// What bounds them on the H100: arithmetic. Each (query, target) pair
// costs 9 FP32 operations in K1 and K7 (three subtract-multiply steps, two
// adds, a compare) and 9 in K8 (three multiplies and two adds for the
// cross term, the doubling, a subtract, an add, a compare; qq and tt are
// per point). The tensor cores cannot give an exact per-coordinate
// distance, and the TPU kernel's MXU cross term becomes plain FP32 work
// here, so K8 saves nothing on this card. The replay path's full-resolution
// pass is 32 x 1024 x 8192 = 0.27 G pairs.
//
// Design: grid (query blocks, lanes); one thread per query with its running
// best in registers; the lane's target streams through shared memory
// (csrc/batched_nn.cuh). K8 adds each target's tt to its tile as a fifth
// row, computed once where the tile is loaded. Inactive lanes return before
// touching the target.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "batched_nn.cuh"

namespace {

using scl::kNnRows;
using scl::kNnThreads;
using scl::kNnTile;
using scl::Select;

template <Select kSel>
__global__ void __launch_bounds__(kNnThreads)
nn_select_batched_kernel(const float* __restrict__ query,
                         const float* __restrict__ payload,
                         const int32_t* __restrict__ active,
                         float* __restrict__ d_out,
                         float* __restrict__ sel_out,
                         int32_t* __restrict__ idx_out, int nq, int nt) {
  __shared__ float tile[kNnRows][kNnTile];
  const int b = blockIdx.y;
  const int i = blockIdx.x * kNnThreads + threadIdx.x;
  const bool in_range = i < nq;
  float* d_lane = d_out + static_cast<size_t>(b) * nq;

  if (active[b] == 0) {  // uniform across the block
    if (in_range) {
      d_lane[i] = CUDART_INF_F;
      if constexpr (kSel == Select::kIndex) {
        idx_out[static_cast<size_t>(b) * nq + i] = 0;
      } else {
        float* sel_lane = sel_out + static_cast<size_t>(b) * kNnRows * nq;
        for (int p = 0; p < kNnRows; ++p) sel_lane[p * nq + i] = 0.0f;
      }
    }
    return;
  }

  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (in_range) {
    const float* q = query + (static_cast<size_t>(b) * nq + i) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
  }
  scl::Nearest r = scl::no_target();
  scl::stream_nearest<kSel>(qx, qy, qz,
                            payload + static_cast<size_t>(b) * kNnRows * nt,
                            nt, tile, r);
  if (!in_range) return;
  d_lane[i] = r.best;
  if constexpr (kSel == Select::kIndex) {
    idx_out[static_cast<size_t>(b) * nq + i] = r.idx;
  } else {
    float s[kNnRows];
    scl::selected<kSel>(r, s);
    float* sel_lane = sel_out + static_cast<size_t>(b) * kNnRows * nq;
    for (int p = 0; p < kNnRows; ++p) sel_lane[p * nq + i] = s[p];
  }
}

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return __fadd_rn(__fadd_rn(__fmul_rn(ax, bx), __fmul_rn(ay, by)),
                   __fmul_rn(az, bz));
}

__global__ void __launch_bounds__(kNnThreads)
nn_select_batched_mxu_kernel(const float* __restrict__ query,
                             const float* __restrict__ payload,
                             const int32_t* __restrict__ active,
                             float* __restrict__ d_out,
                             float* __restrict__ sel_out, int nq, int nt) {
  __shared__ float tile[kNnRows + 1][kNnTile];  // xyz, validity, tt
  const int b = blockIdx.y;
  const int i = blockIdx.x * kNnThreads + threadIdx.x;
  const bool in_range = i < nq;
  float* d_lane = d_out + static_cast<size_t>(b) * nq;
  float* sel_lane = sel_out + static_cast<size_t>(b) * kNnRows * nq;

  if (active[b] == 0) {  // uniform across the block
    if (in_range) {
      d_lane[i] = CUDART_INF_F;
      for (int p = 0; p < kNnRows; ++p) sel_lane[p * nq + i] = 0.0f;
    }
    return;
  }

  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (in_range) {
    const float* q = query + (static_cast<size_t>(b) * nq + i) * 3;
    qx = q[0];
    qy = q[1];
    qz = q[2];
  }
  const float qq = dot3(qx, qy, qz, qx, qy, qz);
  const float* pl = payload + static_cast<size_t>(b) * kNnRows * nt;

  float best = CUDART_INF_F;
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  for (int t0 = 0; t0 < nt; t0 += kNnTile) {
    const int n = min(kNnTile, nt - t0);
    __syncthreads();  // previous tile fully consumed
    for (int k = threadIdx.x; k < n; k += kNnThreads) {
      float v[kNnRows];
#pragma unroll
      for (int p = 0; p < kNnRows; ++p) {
        v[p] = pl[static_cast<size_t>(p) * nt + t0 + k];
        tile[p][k] = v[p];
      }
      tile[kNnRows][k] = dot3(v[0], v[1], v[2], v[0], v[1], v[2]);
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float tx = tile[0][j];
      const float ty = tile[1][j];
      const float tz = tile[2][j];
      const float c = dot3(qx, qy, qz, tx, ty, tz);
      const float d = __fadd_rn(__fsub_rn(qq, __fmul_rn(2.0f, c)), tile[kNnRows][j]);
      if (d < best) {  // strict: the lowest index keeps a tie
        best = d;
        s0 = tx;
        s1 = ty;
        s2 = tz;
        s3 = tile[3][j];
      }
    }
  }
  if (!in_range) return;
  d_lane[i] = fmaxf(best, 0.0f);  // inf stays inf
  sel_lane[0 * nq + i] = s0;
  sel_lane[1 * nq + i] = s1;
  sel_lane[2 * nq + i] = s2;
  sel_lane[3 * nq + i] = s3;
}

}  // namespace

// variant 0: mineq, 1: argmin
extern "C" int scl_nn_select_batched(const float* query, const float* payload,
                                     const int32_t* active, float* d_out,
                                     float* sel_out, int batch, int nq, int nt,
                                     int variant, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nq + kNnThreads - 1) / kNnThreads, batch);
  auto s = static_cast<cudaStream_t>(stream);
  if (variant == 0) {
    nn_select_batched_kernel<Select::kMinEq><<<grid, kNnThreads, 0, s>>>(
        query, payload, active, d_out, sel_out, nullptr, nq, nt);
  } else {
    nn_select_batched_kernel<Select::kArgmin><<<grid, kNnThreads, 0, s>>>(
        query, payload, active, d_out, sel_out, nullptr, nq, nt);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int scl_nn_index_batched(const float* query, const float* payload,
                                    const int32_t* active, float* d_out,
                                    int32_t* idx_out, int batch, int nq, int nt,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nq + kNnThreads - 1) / kNnThreads, batch);
  nn_select_batched_kernel<Select::kIndex>
      <<<grid, kNnThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          query, payload, active, d_out, nullptr, idx_out, nq, nt);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int scl_nn_select_batched_mxu(const float* query,
                                         const float* payload,
                                         const int32_t* active, float* d_out,
                                         float* sel_out, int batch, int nq,
                                         int nt, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((nq + kNnThreads - 1) / kNnThreads, batch);
  nn_select_batched_mxu_kernel<<<grid, kNnThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      query, payload, active, d_out, sel_out, nq, nt);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* scl_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
