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
// adds and a compare: 27 operations, 1.1e8 at the fleet bench's 16 lanes x
// 256 hypotheses x 1,024 points, about 1.7 us at the FP32 peak. Without
// multiply-adds each operation is one instruction, so the issue rate caps
// it at half of that peak. The bytes (each lane's points once, the poses
// and the counts) are a tenth of the operations' time. The fleet run steps
// one frame a robot, 2 lanes, so the grid has to fill the card from the
// points and the hypotheses, not the lanes.
//
// Design: a grid of (hypothesis groups, point chunks, lanes) blocks from
// ops/kernels.py::k6_geometry. Each thread holds kPts = 4 consecutive points
// of the chunk in registers (kVec: three 16-byte loads of the [N, 3] rows
// and the 4 good bytes as one word, where N % 4 == 0 and the rows are
// aligned; scalar loads elsewhere), with a threshold of its own a point: thr2, or -1 for a point
// that is not good (res2 >= 0 or NaN is never below it), so the count is a
// compare and an add a pair. The block's poses sit in shared memory as
// three float4 a hypothesis, read by every lane at once, and the block
// walks its hypotheses: a thread counts its inliers of each, the warp sums
// them with one __reduce_add_sync, and the block's warps meet in shared
// memory. Integer sums are exact in any order: with one chunk a lane the
// block stores its counts, else it adds them with atomicAdd into the
// output, which a memset queued by the same call zeroes first. The loop
// runs 32 instructions a pair (27 of them the contract's operations), and
// a launch at the fleet's shapes is held as much by its first loads and
// the launch itself as by the loop (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPts = 4;  // points a thread

__device__ __forceinline__ int inliers(const float4& pa, const float4& pb, const float4& pc,
                                       const float* src, const float* mt, const float* lim) {
  int cnt = 0;
#pragma unroll
  for (int j = 0; j < kPts; ++j) {
    const float x = src[3 * j], y = src[3 * j + 1], z = src[3 * j + 2];
    const float mx = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(pa.x, x), __fmul_rn(pa.y, y)),
                                         __fmul_rn(pa.z, z)), pc.y);
    const float my = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(pa.w, x), __fmul_rn(pb.x, y)),
                                         __fmul_rn(pb.y, z)), pc.z);
    const float mz = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(pb.z, x), __fmul_rn(pb.w, y)),
                                         __fmul_rn(pc.x, z)), pc.w);
    const float dx = __fsub_rn(mx, mt[3 * j]);
    const float dy = __fsub_rn(my, mt[3 * j + 1]);
    const float dz = __fsub_rn(mz, mt[3 * j + 2]);
    const float res2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
    cnt += res2 < lim[j] ? 1 : 0;
  }
  return cnt;
}

template <bool kVec>
__global__ void ransac_counts_kernel(const float* __restrict__ source,
                                     const float* __restrict__ matched,
                                     const uint8_t* __restrict__ good,
                                     const float* __restrict__ rot,
                                     const float* __restrict__ trans,
                                     int32_t* __restrict__ counts, int n, int h, int hyps,
                                     float thr2) {
  extern __shared__ float4 s_pose[];  // [hyps][3], then [warps][hyps] int
  int* s_part = reinterpret_cast<int*>(s_pose + 3 * hyps);
  const int b = blockIdx.z;
  const int h0 = blockIdx.x * hyps;
  const int hn = min(hyps, h - h0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // the poses: R00 R01 R02 R10 | R11 R12 R20 R21 | R22 t0 t1 t2
  float* sp = reinterpret_cast<float*>(s_pose);
  for (int e = threadIdx.x; e < hn * 12; e += blockDim.x) {
    const int g = e / 12, c = e % 12;
    const size_t row = static_cast<size_t>(b) * h + h0 + g;
    sp[e] = c < 9 ? __ldg(rot + row * 9 + c) : __ldg(trans + row * 3 + (c - 9));
  }

  // this thread's points: [p0, p0 + kPts) of the lane
  const int p0 = (blockIdx.y * blockDim.x + threadIdx.x) * kPts;
  const size_t base = static_cast<size_t>(b) * n;
  float src[3 * kPts], mt[3 * kPts], lim[kPts];
  if (kVec && p0 + kPts <= n) {  // 12 * kPts bytes from a 16-byte boundary
    const float4* s4 = reinterpret_cast<const float4*>(source + (base + p0) * 3);
    const float4* m4 = reinterpret_cast<const float4*>(matched + (base + p0) * 3);
#pragma unroll
    for (int v = 0; v < 3 * kPts / 4; ++v) {
      const float4 a = __ldg(s4 + v);
      const float4 c = __ldg(m4 + v);
      src[4 * v] = a.x; src[4 * v + 1] = a.y; src[4 * v + 2] = a.z; src[4 * v + 3] = a.w;
      mt[4 * v] = c.x; mt[4 * v + 1] = c.y; mt[4 * v + 2] = c.z; mt[4 * v + 3] = c.w;
    }
    const uint32_t* g4 = reinterpret_cast<const uint32_t*>(good + base + p0);
    const uint32_t word = __ldg(g4);
#pragma unroll
    for (int j = 0; j < kPts; ++j) lim[j] = ((word >> (8 * j)) & 0xffu) ? thr2 : -1.0f;
  } else {
#pragma unroll
    for (int j = 0; j < kPts; ++j) {
      const bool in = p0 + j < n;
      const size_t p = base + (in ? p0 + j : 0);
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        src[3 * j + c] = in ? __ldg(source + p * 3 + c) : 0.0f;
        mt[3 * j + c] = in ? __ldg(matched + p * 3 + c) : 0.0f;
      }
      lim[j] = in && __ldg(good + p) != 0 ? thr2 : -1.0f;
    }
  }
  __syncthreads();

  // every thread takes every hypothesis (the warp sum needs all 32 lanes)
  for (int g = 0; g < hn; ++g) {
    const int cnt = __reduce_add_sync(
        0xffffffffu,
        inliers(s_pose[3 * g], s_pose[3 * g + 1], s_pose[3 * g + 2], src, mt, lim));
    if (lane == 0) s_part[warp * hyps + g] = cnt;
  }
  __syncthreads();

  const int warps = blockDim.x / 32;
  for (int g = threadIdx.x; g < hn; g += blockDim.x) {
    int c = 0;
    for (int w = 0; w < warps; ++w) c += s_part[w * hyps + g];
    const size_t o = static_cast<size_t>(b) * h + h0 + g;
    if (gridDim.y == 1) {
      counts[o] = c;
    } else {
      atomicAdd(counts + o, c);
    }
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// Geometry (threads, hyps, groups, chunks) from
// ops/kernels.py::k6_geometry; vec asks for the 16-byte loads, which need
// n % 4 == 0 and aligned rows (refused otherwise).
extern "C" int scl_ransac_counts_batched(const float* source, const float* matched,
                                         const uint8_t* good, const float* rot,
                                         const float* trans, int32_t* counts, int batch,
                                         int n, int h, float thr2, int threads, int hyps,
                                         int groups, int chunks, int vec, int device,
                                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (vec && (n % 4 != 0 || !aligned(source, 16) || !aligned(matched, 16) ||
              !aligned(good, 4))) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (chunks > 1) {
    err = cudaMemsetAsync(counts, 0, static_cast<size_t>(batch) * h * sizeof(int32_t), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(groups, chunks, batch);
  const size_t smem =
      static_cast<size_t>(hyps) * (3 * sizeof(float4) + (threads / 32) * sizeof(int));
  if (vec) {
    ransac_counts_kernel<true><<<grid, threads, smem, s>>>(source, matched, good, rot, trans,
                                                           counts, n, h, hyps, thr2);
  } else {
    ransac_counts_kernel<false><<<grid, threads, smem, s>>>(source, matched, good, rot, trans,
                                                            counts, n, h, hyps, thr2);
  }
  return static_cast<int>(cudaGetLastError());
}
