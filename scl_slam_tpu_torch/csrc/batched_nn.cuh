// The streaming 1-NN loop shared by the batched kernels K1 (both bodies),
// K7 (csrc/nn_select_batched.cu) and K5 (csrc/icp_moments.cu).
//
// One thread per query keeps its running nearest target in registers; the
// lane's target streams through shared memory in [rows, kNnTile] tiles,
// which all threads of the block read as broadcasts (no bank conflicts).
// Every distance is ((dx*dx) + (dy*dy)) + (dz*dz) with each step rounded to
// f32 (_rn intrinsics; the build also passes -fmad=false), so d2 is
// bit-equal to the plain versions' and to the TPU kernels' exact
// per-coordinate f32. A NaN distance never wins (every compare is false).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace scl {

constexpr int kNnThreads = 64;   // queries per block: 128 blocks at 32 x 256
constexpr int kNnTile = 2048;    // targets per shared-memory tile
constexpr int kNnRows = 4;       // payload rows: target xyz + validity

// How the winner is chosen, and what is kept of it.
enum class Select {
  kMinEq,   // payload averaged over every target at exactly the min d2
  kArgmin,  // payload of the lowest-index target at the min d2
  kIndex,   // lowest index at the min d2, no payload
};

struct Nearest {
  float best;
  float s0, s1, s2, s3;  // payload (its sum for kMinEq)
  int cnt;               // tied targets (kMinEq)
  int idx;               // kArgmin, kIndex
};

// No target yet. (A free device function: CUDART_INF_F is a device
// intrinsic, which a constructor would also hand to the host compiler.)
__device__ __forceinline__ Nearest no_target() {
  Nearest r;
  r.best = CUDART_INF_F;
  r.s0 = r.s1 = r.s2 = r.s3 = 0.0f;
  r.cnt = 0;
  r.idx = 0;
  return r;
}

__device__ __forceinline__ float sq_dist(float qx, float qy, float qz,
                                         float tx, float ty, float tz) {
  const float dx = __fsub_rn(qx, tx);
  const float dy = __fsub_rn(qy, ty);
  const float dz = __fsub_rn(qz, tz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Streams the lane's payload pl [kNnRows, nt] past the query (qx, qy, qz).
// Every thread of the block must call it (it synchronises the block); a
// thread without a query passes any coordinates and ignores the result.
template <Select kSel>
__device__ void stream_nearest(float qx, float qy, float qz,
                               const float* __restrict__ pl, int nt,
                               float (*tile)[kNnTile], Nearest& r) {
  constexpr int kLoad = kSel == Select::kIndex ? 3 : kNnRows;
  for (int t0 = 0; t0 < nt; t0 += kNnTile) {
    const int n = min(kNnTile, nt - t0);
    __syncthreads();  // previous tile fully consumed
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
#pragma unroll
      for (int p = 0; p < kLoad; ++p) {
        tile[p][k] = pl[static_cast<size_t>(p) * nt + t0 + k];
      }
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float tx = tile[0][j];
      const float ty = tile[1][j];
      const float tz = tile[2][j];
      const float d = sq_dist(qx, qy, qz, tx, ty, tz);
      if constexpr (kSel == Select::kMinEq) {
        if (d < r.best) {
          r.best = d;
          r.s0 = tx;
          r.s1 = ty;
          r.s2 = tz;
          r.s3 = tile[3][j];
          r.cnt = 1;
        } else if (d == r.best && r.cnt > 0) {
          r.s0 = __fadd_rn(r.s0, tx);
          r.s1 = __fadd_rn(r.s1, ty);
          r.s2 = __fadd_rn(r.s2, tz);
          r.s3 = __fadd_rn(r.s3, tile[3][j]);
          ++r.cnt;
        }
      } else if (d < r.best) {  // strict: the lowest index keeps a tie
        r.best = d;
        r.idx = t0 + j;
        if constexpr (kSel == Select::kArgmin) {
          r.s0 = tx;
          r.s1 = ty;
          r.s2 = tz;
          r.s3 = tile[3][j];
        }
      }
    }
  }
}

// The selected payload column: the tie average for kMinEq (0 without a
// winner), the winner's column for kArgmin (0 without a winner).
template <Select kSel>
__device__ __forceinline__ void selected(const Nearest& r, float* s) {
  if constexpr (kSel == Select::kMinEq) {
    if (r.cnt > 0) {
      const float c = static_cast<float>(r.cnt);
      s[0] = __fdiv_rn(r.s0, c);
      s[1] = __fdiv_rn(r.s1, c);
      s[2] = __fdiv_rn(r.s2, c);
      s[3] = __fdiv_rn(r.s3, c);
    } else {
      s[0] = s[1] = s[2] = s[3] = 0.0f;
    }
  } else {
    s[0] = r.s0;
    s[1] = r.s1;
    s[2] = r.s2;
    s[3] = r.s3;
  }
}

}  // namespace scl
