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
//   payload selection as K1 does (csrc/batched_nn.cuh: mineq averages
//   exact-d2 ties, argmin takes the lowest index); good = the source point
//   is valid & the selected validity > 0.5 & d2 < maxd2; w = good. Lanes
//   with active == 0 return zeros (n_src too, as in the TPU kernel). The
//   sums are taken in a fixed order (below), not in the plain version's,
//   so the two agree to a stated relative tolerance, not bit for bit.
//   The TPU kernel's 128-lane pose rows and [8, 128] output block are its
//   tiling, not carried.
//
// What bounds it on the H100: arithmetic, as K1. Each (query, target) pair
// costs 9 FP32 operations; the transform, the gate and the 18 products per
// query are Nq-sized, the reduction too. The replay path's full-resolution
// iteration is 32 x 1024 x 8192 = 0.27 G pairs, the coarse one 1/16 of it.
//
// Design: grid (query blocks, lanes), as K1 (one block per lane would give
// 32 blocks on 132 SMs at the replay path's shapes); one thread per query
// transforms it, streams the lane's target (csrc/batched_nn.cuh) and forms
// its 18 weighted values; the block reduces them with warp shuffles in a
// fixed tree, then across its warps in warp order, into one partial row
// [B, n_blocks, 18]. A second, small launch sums each lane's partial rows
// in block order. No atomics: their order changes from run to run, and
// these sums feed an SVD whose result decides whether a loop closes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "batched_nn.cuh"

namespace {

using scl::kNnRows;
using scl::kNnThreads;
using scl::kNnTile;
using scl::Select;

constexpr int kSlots = 18;
constexpr int kWarps = kNnThreads / 32;

__device__ __forceinline__ float rigid_row(const float* r, float x, float y,
                                           float z, float t) {
  return __fadd_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(r[0], x), __fmul_rn(r[1], y)),
                __fmul_rn(r[2], z)),
      t);
}

template <Select kSel>
__global__ void __launch_bounds__(kNnThreads)
icp_moments_partial_kernel(const float* __restrict__ src4,
                           const float* __restrict__ payload,
                           const float* __restrict__ rot,
                           const float* __restrict__ trans,
                           const int32_t* __restrict__ active,
                           float* __restrict__ partial, int nq, int nt,
                           float maxd2) {
  __shared__ float tile[kNnRows][kNnTile];
  __shared__ float red[kWarps][kSlots];
  const int b = blockIdx.y;
  const int i = blockIdx.x * kNnThreads + threadIdx.x;
  float* out =
      partial + (static_cast<size_t>(b) * gridDim.x + blockIdx.x) * kSlots;
  if (active[b] == 0) {  // uniform across the block
    if (threadIdx.x < kSlots) out[threadIdx.x] = 0.0f;
    return;
  }

  const bool in_range = i < nq;
  float x = 0.0f, y = 0.0f, z = 0.0f;
  bool valid = false;
  if (in_range) {
    const float* s4 = src4 + static_cast<size_t>(b) * 4 * nq;
    x = s4[i];
    y = s4[nq + i];
    z = s4[2 * nq + i];
    valid = s4[3 * nq + i] > 0.5f;
  }
  const float* R = rot + static_cast<size_t>(b) * 9;
  const float* t = trans + static_cast<size_t>(b) * 3;
  const float s[3] = {rigid_row(R, x, y, z, t[0]),
                      rigid_row(R + 3, x, y, z, t[1]),
                      rigid_row(R + 6, x, y, z, t[2])};

  scl::Nearest r = scl::no_target();
  scl::stream_nearest<kSel>(s[0], s[1], s[2],
                            payload + static_cast<size_t>(b) * kNnRows * nt,
                            nt, tile, r);
  float d[kNnRows];
  scl::selected<kSel>(r, d);
  const bool good = in_range && valid && d[3] > 0.5f && r.best < maxd2;

  float v[kSlots];
  v[0] = good ? 1.0f : 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    v[1 + a] = good ? s[a] : 0.0f;
    v[4 + a] = good ? d[a] : 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      v[7 + 3 * a + c] = good ? __fmul_rn(s[a], d[c]) : 0.0f;
    }
  }
  v[16] = good ? r.best : 0.0f;
  v[17] = in_range && valid ? 1.0f : 0.0f;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v[k] = __fadd_rn(v[k], __shfl_down_sync(0xffffffffu, v[k], off));
    }
    if (lane == 0) red[warp][k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < kSlots) {
    float acc = red[0][threadIdx.x];
    for (int w = 1; w < kWarps; ++w) acc = __fadd_rn(acc, red[w][threadIdx.x]);
    out[threadIdx.x] = acc;
  }
}

__global__ void icp_moments_sum_kernel(const float* __restrict__ partial,
                                       float* __restrict__ m, int n_blocks) {
  const int b = blockIdx.x;
  const int k = threadIdx.x;
  if (k >= kSlots) return;
  const float* p = partial + static_cast<size_t>(b) * n_blocks * kSlots + k;
  float acc = p[0];
  for (int j = 1; j < n_blocks; ++j) acc = __fadd_rn(acc, p[j * kSlots]);
  m[static_cast<size_t>(b) * kSlots + k] = acc;
}

}  // namespace

// partial: scratch of [batch, ceil(nq / 64), 18] floats. variant 0: mineq,
// 1: argmin. Two launches on the stream; returns the first error.
extern "C" int scl_icp_moments_batched(const float* src4, const float* payload,
                                       const float* rot, const float* trans,
                                       const int32_t* active, float* partial,
                                       float* m, int batch, int nq, int nt,
                                       float maxd2, int variant, int device,
                                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_blocks = (nq + kNnThreads - 1) / kNnThreads;
  const dim3 grid(n_blocks, batch);
  auto s = static_cast<cudaStream_t>(stream);
  if (variant == 0) {
    icp_moments_partial_kernel<Select::kMinEq><<<grid, kNnThreads, 0, s>>>(
        src4, payload, rot, trans, active, partial, nq, nt, maxd2);
  } else {
    icp_moments_partial_kernel<Select::kArgmin><<<grid, kNnThreads, 0, s>>>(
        src4, payload, rot, trans, active, partial, nq, nt, maxd2);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  icp_moments_sum_kernel<<<batch, 32, 0, s>>>(partial, m, n_blocks);
  return static_cast<int>(cudaGetLastError());
}
