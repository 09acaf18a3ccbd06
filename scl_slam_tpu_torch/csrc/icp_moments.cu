// K5: one whole batched ICP iteration per lane, reduced to 18 Kabsch
// moment sums.
//
// Replaces scl_slam_tpu/ops/pallas_kernels.py::icp_moments_batched_pallas,
// with its bodies _icp_moments_mineq_kernel (the default SELECT_VARIANT,
// "mineq") and _icp_moments_kernel ("argmin"). It runs in every iteration
// of the batched ICP under FUSED_ICP, and in its final fitness pass
// (ops/registration.py::_icp_stage_batched_fused and icp_batched), on the
// keyframe replay path and the fleet's intra ICP.
//
// Contract (the plain version is ops/kernels.py::icp_moments_batched_plain):
//   src4 [B, 4, Nq] (local source xyz rows + validity row), payload
//   [B, 4, Nt] (target xyz rows + validity row), R [B, 3, 3], t [B, 3],
//   active [B] int32, maxd2 f32 -> m [B, 18] f32 in the M_* layout of
//   ops/kernels.py (w, w*s, w*d, w*s_a*d_b row-major, w*d2, n_src).
//   Per query: s_i = ((R_i0*x + R_i1*y) + R_i2*z) + t_i, left to right as
//   the Pallas body writes it, each step rounded to f32; its 1-NN with
//   payload selection as K1 does (csrc/nn_split.cuh: mineq averages
//   exact-d2 ties, argmin takes the lowest index); good = the source point
//   is valid & the selected validity > 0.5 & d2 < maxd2; w = good. Lanes
//   with active == 0 return zeros (n_src too, as in the TPU kernel). The
//   sums are taken in a fixed order (below), not in the plain version's,
//   so the two agree to a stated relative tolerance, not bit for bit.
//   The TPU kernel's 128-lane pose rows and [8, 128] output block are its
//   tiling, not carried.
//
// What bounds it on the H100: instruction issue, as K1. Each (query,
// target) pair costs 9 FP32 operations, each its own instruction
// (-fmad=false); the transform, the gate and the 18 products per query are
// Nq-sized, the reduction too. The replay path's full-resolution iteration
// is 32 x 1024 x 8192 = 0.27 G pairs, the coarse one 1/16 of it.
//
// Design: K1's split-target walk (csrc/nn_split.cuh) with two policies of
// its own (MomentsOp). Its queries are the source points moved by the
// lane's pose as they are loaded (each warp of a block moves the block's
// queries the same way); its finish, in the block that finishes a query
// group (warp 0 with one slice, else the last block of the group to
// arrive), forms each query's 18 gated terms, sums a lane's kRq queries in
// order, then the 32 lanes by a fixed shuffle tree, into one row per
// (query group, lane). Spare queries (past Nq) and inactive lanes give
// zero terms, n_src included. The last group of a lane to arrive (a second
// arrival counter, which resets itself) sums the lane's rows in ascending
// group order: one launch (a second launch for that sum measured the same
// or slower on an H100, and was not kept). No float atomics: their order changes from run to run, and
// these sums feed an SVD whose result decides whether a loop closes.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "nn_split.cuh"

namespace {

using scl::Best;
using scl::Pick;
using scl::Query;

constexpr int kSlots = 18;

struct MomentArgs : scl::SplitArgs {
  const float* rot;          // [lanes, 3, 3]
  const float* trans;        // [lanes, 3]
  float maxd2;
  float* rows;               // [lanes, query groups, 18]: each group's sums
  uint32_t* group_arrivals;  // [lanes], zero between launches
  float* m_out;              // [lanes, 18]
};

__device__ __forceinline__ float rigid_row(const float* r, float x, float y,
                                           float z, float t) {
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(r[0], x), __fmul_rn(r[1], y)),
                __fmul_rn(r[2], z)),
      t);
}

struct MomentsOp : scl::NnOp {
  using Args = MomentArgs;

  // source point i of lane b, moved by the lane's pose; aux: its validity
  static __device__ __forceinline__ Query load_query(const MomentArgs& a, int b, int i) {
    const float* s4 = a.query + static_cast<size_t>(b) * 4 * a.nq;
    const float x = s4[i], y = s4[a.nq + i], z = s4[2 * a.nq + i];
    const float* R = a.rot + static_cast<size_t>(b) * 9;
    const float* t = a.trans + static_cast<size_t>(b) * 3;
    return {rigid_row(R, x, y, z, t[0]), rigid_row(R + 3, x, y, z, t[1]),
            rigid_row(R + 6, x, y, z, t[2]), s4[3 * a.nq + i] > 0.5f ? 1.0f : 0.0f};
  }

  // The group's 18 sums into rows[b, group], then, in the last group of
  // the lane to arrive, the lane's rows in ascending order into m_out[b]
  // (lane_on false: zero terms, n_src too).
  template <Pick kPick, int kRq>
  static __device__ __forceinline__ void finish_group(const MomentArgs& a, int b, int q0,
                                                      const Query* q, const Best* m,
                                                      bool lane_on = true) {
    float acc[kSlots];
#pragma unroll
    for (int r = 0; r < kRq; ++r) {
      const bool valid = lane_on && q0 + 32 * r < a.nq && q[r].aux > 0.5f;  // no spare
      float d[4];  // the selected payload column
      if constexpr (kPick == Pick::kTieMean) {
        const float c = static_cast<float>(m[r].i);
        const bool any = m[r].i > 0;
        d[0] = any ? __fdiv_rn(m[r].s0, c) : 0.0f;
        d[1] = any ? __fdiv_rn(m[r].s1, c) : 0.0f;
        d[2] = any ? __fdiv_rn(m[r].s2, c) : 0.0f;
        d[3] = any ? __fdiv_rn(m[r].s3, c) : 0.0f;
      } else {
        const bool found = valid && m[r].d < CUDART_INF_F;
#pragma unroll
        for (int p = 0; p < 4; ++p) d[p] = found ? *a.target.at(b, p, m[r].i) : 0.0f;
      }
      const bool good = valid && d[3] > 0.5f && m[r].d < a.maxd2;
      const float s[3] = {q[r].x, q[r].y, q[r].z};
      float v[kSlots];
      v[0] = good ? 1.0f : 0.0f;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        v[1 + i] = good ? s[i] : 0.0f;
        v[4 + i] = good ? d[i] : 0.0f;
#pragma unroll
        for (int j = 0; j < 3; ++j) v[7 + 3 * i + j] = good ? __fmul_rn(s[i], d[j]) : 0.0f;
      }
      v[16] = good ? m[r].d : 0.0f;
      v[17] = valid ? 1.0f : 0.0f;
#pragma unroll
      for (int k = 0; k < kSlots; ++k) acc[k] = r == 0 ? v[k] : __fadd_rn(acc[k], v[k]);
    }
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        acc[k] = __fadd_rn(acc[k], __shfl_down_sync(0xffffffffu, acc[k], off));
      }
    }
    const int lane = threadIdx.x & 31;
    const unsigned groups = gridDim.x;
    unsigned is_last = 0;
    if (lane == 0) {
      float* row = a.rows + (static_cast<size_t>(b) * groups + blockIdx.x) * kSlots;
#pragma unroll
      for (int k = 0; k < kSlots; ++k) row[k] = acc[k];
      __threadfence();  // the row is visible before the arrival counts
      is_last = atomicInc(a.group_arrivals + b, groups - 1) == groups - 1;
    }
    if (!__shfl_sync(0xffffffffu, is_last, 0)) return;
    __threadfence();
    if (lane < kSlots) {
      const float* col = a.rows + static_cast<size_t>(b) * groups * kSlots + lane;
      float sum = __ldcg(col);
      for (unsigned g = 1; g < groups; ++g) sum = __fadd_rn(sum, __ldcg(col + g * kSlots));
      a.m_out[static_cast<size_t>(b) * kSlots + lane] = sum;
    }
  }

  // An inactive lane: its group's row of zeros, and the lane's zero sums.
  template <Pick kPick, int kRq>
  static __device__ __forceinline__ void finish_inactive(const MomentArgs& a, int b, int q0) {
    Query q[kRq];
    Best none[kRq];
#pragma unroll
    for (int r = 0; r < kRq; ++r) {
      q[r] = {0.0f, 0.0f, 0.0f, 0.0f};
      none[r].d = CUDART_INF_F;
      none[r].i = 0;
      none[r].s0 = none[r].s1 = none[r].s2 = none[r].s3 = 0.0f;
    }
    finish_group<kPick, kRq>(a, b, q0, q, none, false);
  }
};

}  // namespace

// rows: scratch of [batch, query groups, 18] floats; group_arrivals:
// [batch] zeros, left zero. part_d, part_i: [batch, slices, nq]; part_s:
// [batch, slices, 4, nq] (mineq only); arrivals: [batch, query groups]
// zeros, left zero; all four may be null with one slice. variant 0: mineq,
// 1: argmin. One launch; returns its error.
extern "C" int scl_icp_moments_batched(
    const float* src4, const float* payload, const float* rot, const float* trans,
    const int32_t* active, float* part_d, int32_t* part_i, float* part_s,
    uint32_t* arrivals, float* rows, uint32_t* group_arrivals, float* m, int batch,
    int nq, int nt, float maxd2, int variant, int threads, int rq, int slice_len,
    int slices, int device, void* stream) {
  if (!scl::split_geometry_ok(nt, threads, slice_len, slices)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  MomentArgs a{};
  a.query = src4;
  a.target = {payload, static_cast<size_t>(4) * nt, static_cast<size_t>(nt), 1};
  a.active = active;
  a.nq = nq;
  a.nt = nt;
  a.slice_len = slice_len;
  a.slices = slices;
  a.part_d = part_d;
  a.part_i = part_i;
  a.part_s = part_s;
  a.arrivals = arrivals;
  a.rot = rot;
  a.trans = trans;
  a.maxd2 = maxd2;
  a.rows = rows;
  a.group_arrivals = group_arrivals;
  a.m_out = m;
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      variant == 0 ? scl::launch_split<Pick::kTieMean, MomentsOp>(a, batch, threads, rq, s)
                   : scl::launch_split<Pick::kLowest, MomentsOp>(a, batch, threads, rq, s));
}
