// K6: batched RANSAC hypothesis scoring (inlier count per hypothesis).
//
// Replaces scl_slam_tpu/ops/pallas_kernels.py::ransac_counts_batched_pallas
// (kernel body _ransac_counts_kernel). It scores every hypothesis of the
// batched inter-robot verification of the centralized fleet
// (ops/registration.py::ransac_align_batched, called by
// runtime/fleet.py::_detect_verify_inter_block).
//
// Contract (the plain version is ops/kernels.py::ransac_counts_batched_plain):
//   source [B, N, 3], matched [B, N, 3] f32 (xyz interleaved), good [B, N]
//   bool, R [B, H, 9] (row-major 3x3), t [B, H, 3] f32, thr2 f32
//   -> counts [B, H] int32: the number of points n with good[b, n] and
//   res2 < thr2, where for each row i
//     m_i  = ((R_i0 * x + R_i1 * y) + R_i2 * z) + t_i,
//     res2 = ((dx * dx) + (dy * dy)) + (dz * dz),   d_i = m_i - matched_i,
//   every step rounded to f32 (the build passes -fmad=false and the
//   arithmetic is spelled with _rn intrinsics), so the counts are equal to
//   the plain version's. Any H >= 1 and N >= 1: the TPU kernel's H % 8 and
//   N % 128 limits, its [B, H, 128] pose rows and its lane-0 output are not
//   carried.
//
// What bounds it on the H100: arithmetic. Each (hypothesis, point) pair is
// 18 FP32 operations for the transform, then 3 subtracts, 3 multiplies, 2
// adds and a compare: 27 operations, 1.1e8 at the fleet's 16 lanes x 256
// hypotheses x 1,024 points, about 1.7 us at the FP32 peak; the bytes (each
// lane's points once, the poses and the counts) are a tenth of that. At such
// sizes one launch costs the host more than the card.
//
// Design: a grid of (hypothesis groups, lanes). A block stages its lane's
// points (source, matched, good) in shared memory, a tile at a time, and
// each of its warps scores kHypPerWarp hypotheses, whose poses it holds in
// registers: the lanes of the warp stride over the tile's points, and each
// step's inliers are counted with __ballot_sync / __popc, so the warp's
// count needs no reduction at the end.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                            // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kHypPerWarp = 2;
constexpr int kHypPerBlock = kWarps * kHypPerWarp;   // 16
constexpr int kTile = 1024;                          // points per tile (25 KB)

__global__ void __launch_bounds__(kThreads)
ransac_counts_kernel(const float* __restrict__ source,
                     const float* __restrict__ matched,
                     const uint8_t* __restrict__ good,
                     const float* __restrict__ rot,
                     const float* __restrict__ trans,
                     int32_t* __restrict__ counts, int n, int h, float thr2) {
  __shared__ float s_src[3][kTile];
  __shared__ float s_mt[3][kTile];
  __shared__ uint8_t s_good[kTile];
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // this warp's hypotheses: h0 + warp + kWarps * k
  const int h0 = blockIdx.x * kHypPerBlock;
  float p[kHypPerWarp][12];
  bool live[kHypPerWarp];
  int cnt[kHypPerWarp];
#pragma unroll
  for (int k = 0; k < kHypPerWarp; ++k) {
    const int hh = h0 + warp + kWarps * k;
    live[k] = hh < h;
    cnt[k] = 0;
    const size_t row = static_cast<size_t>(b) * h + (live[k] ? hh : 0);
#pragma unroll
    for (int e = 0; e < 9; ++e) p[k][e] = rot[row * 9 + e];
#pragma unroll
    for (int e = 0; e < 3; ++e) p[k][9 + e] = trans[row * 3 + e];
  }

  const size_t base = static_cast<size_t>(b) * n;
  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int m = min(kTile, n - t0);
    __syncthreads();  // the previous tile is consumed
    for (int j = threadIdx.x; j < m; j += kThreads) {
      const size_t g = (base + t0 + j) * 3;
      s_src[0][j] = source[g];
      s_src[1][j] = source[g + 1];
      s_src[2][j] = source[g + 2];
      s_mt[0][j] = matched[g];
      s_mt[1][j] = matched[g + 1];
      s_mt[2][j] = matched[g + 2];
      s_good[j] = good[base + t0 + j];
    }
    __syncthreads();
    // every lane of the warp takes each step (the ballot needs all 32)
    for (int j0 = 0; j0 < m; j0 += 32) {
      const int j = j0 + lane;
      const bool in = j < m;
      const float x = in ? s_src[0][j] : 0.0f;
      const float y = in ? s_src[1][j] : 0.0f;
      const float z = in ? s_src[2][j] : 0.0f;
      const float ux = in ? s_mt[0][j] : 0.0f;
      const float uy = in ? s_mt[1][j] : 0.0f;
      const float uz = in ? s_mt[2][j] : 0.0f;
      const bool ok = in && s_good[j];
#pragma unroll
      for (int k = 0; k < kHypPerWarp; ++k) {
        const float mx = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(p[k][0], x), __fmul_rn(p[k][1], y)),
                                             __fmul_rn(p[k][2], z)), p[k][9]);
        const float my = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(p[k][3], x), __fmul_rn(p[k][4], y)),
                                             __fmul_rn(p[k][5], z)), p[k][10]);
        const float mz = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(p[k][6], x), __fmul_rn(p[k][7], y)),
                                             __fmul_rn(p[k][8], z)), p[k][11]);
        const float dx = __fsub_rn(mx, ux);
        const float dy = __fsub_rn(my, uy);
        const float dz = __fsub_rn(mz, uz);
        const float res2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                     __fmul_rn(dz, dz));
        cnt[k] += __popc(__ballot_sync(0xffffffffu, ok && res2 < thr2));
      }
    }
  }
  if (lane != 0) return;
#pragma unroll
  for (int k = 0; k < kHypPerWarp; ++k) {
    if (live[k]) counts[static_cast<size_t>(b) * h + h0 + warp + kWarps * k] = cnt[k];
  }
}

}  // namespace

extern "C" int scl_ransac_counts_batched(const float* source, const float* matched,
                                         const uint8_t* good, const float* rot,
                                         const float* trans, int32_t* counts,
                                         int batch, int n, int h, float thr2,
                                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((h + kHypPerBlock - 1) / kHypPerBlock, batch);
  ransac_counts_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      source, matched, good, rot, trans, counts, n, h, thr2);
  return static_cast<int>(cudaGetLastError());
}
