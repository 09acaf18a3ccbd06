// K4: solo 1-NN + payload selection, lowest index on exact ties ("argmin"),
// and K3: solo 1-NN (distance and index), which shares K4's first pass.
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
// (xyz interleaved) where K4's payload is [P, Nt]: pass 1 reads either
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
// What bounds it on the H100: arithmetic. Each (query, target) pair costs
// three subtract-multiply steps, two adds and a compare in plain FP32; the
// live path's full-resolution pass is 1,024 x 16,384 = 16.8 M pairs, its
// coarse pass 256 x 4,096. With one thread per query that is only 8 blocks of
// 128 threads: 8 of the 132 SMs. K3's verification pass is 4,096 x 8,192 at
// the default configuration (33.6 M pairs, 32 query blocks).
//
// Design: split the targets as well as the queries. Pass 1 runs a grid of
// (query blocks x target chunks); each thread keeps its query's running
// (min d, argmin) over its chunk in registers, with the chunk streaming
// through shared memory in tiles read by all threads as broadcasts, and
// writes one (d, index) partial per chunk. Pass 2 (one thread per query)
// takes the minimum over the chunks in ascending chunk order with a strict <
// (smaller d, then lower index: chunks are ascending in target index, and
// within a chunk the first minimum is kept) and gathers the winner's payload
// column (K4) or writes its index (K3). Each wrapper counts its two launches
// as one call.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;   // queries per block of pass 1
constexpr int kTile = 1024;     // targets per shared-memory tile (12 KB)

__global__ void __launch_bounds__(kThreads)
nn_select_partial_kernel(const float* __restrict__ query,
                         const float* __restrict__ payload,
                         float* __restrict__ part_d,
                         int32_t* __restrict__ part_i,
                         int nq, int nt, int chunk,
                         size_t row_stride, size_t col_stride) {
  __shared__ float tile[3][kTile];
  const int c = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool in_range = i < nq;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (in_range) {
    qx = query[static_cast<size_t>(i) * 3 + 0];
    qy = query[static_cast<size_t>(i) * 3 + 1];
    qz = query[static_cast<size_t>(i) * 3 + 2];
  }
  const int c0 = c * chunk;
  const int c1 = min(nt, c0 + chunk);

  float best = CUDART_INF_F;
  int arg = -1;
  for (int t0 = c0; t0 < c1; t0 += kTile) {
    const int n = min(kTile, c1 - t0);
    __syncthreads();  // previous tile fully consumed
    for (int k = threadIdx.x; k < n; k += kThreads) {
      const size_t col = static_cast<size_t>(t0 + k) * col_stride;
      tile[0][k] = payload[col];
      tile[1][k] = payload[row_stride + col];
      tile[2][k] = payload[2 * row_stride + col];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float dx = __fsub_rn(qx, tile[0][j]);
      const float dy = __fsub_rn(qy, tile[1][j]);
      const float dz = __fsub_rn(qz, tile[2][j]);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      if (d < best) {  // strict: the first (lowest) index keeps a tie
        best = d;
        arg = t0 + j;
      }
    }
  }
  if (!in_range) return;
  part_d[static_cast<size_t>(c) * nq + i] = best;
  part_i[static_cast<size_t>(c) * nq + i] = arg;
}

__global__ void nn_select_finish_kernel(const float* __restrict__ part_d,
                                        const int32_t* __restrict__ part_i,
                                        const float* __restrict__ payload,
                                        float* __restrict__ d_out,
                                        float* __restrict__ sel_out,
                                        int nq, int nt, int rows, int chunks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  float best = CUDART_INF_F;
  int arg = -1;
  for (int c = 0; c < chunks; ++c) {
    const float d = part_d[static_cast<size_t>(c) * nq + i];
    if (d < best) {
      best = d;
      arg = part_i[static_cast<size_t>(c) * nq + i];
    }
  }
  d_out[i] = arg >= 0 ? fmaxf(best, 0.0f) : CUDART_INF_F;
  for (int p = 0; p < rows; ++p) {
    sel_out[static_cast<size_t>(p) * nq + i] =
        arg >= 0 ? payload[static_cast<size_t>(p) * nt + arg] : 0.0f;
  }
}

// K3's pass 2: the same ascending strict-< minimum over the chunks as K4's,
// writing the winner's index (0 where no target beat inf) instead of a
// payload column.
__global__ void nearest_neighbors_finish_kernel(const float* __restrict__ part_d,
                                                const int32_t* __restrict__ part_i,
                                                float* __restrict__ d_out,
                                                int32_t* __restrict__ idx_out,
                                                int nq, int chunks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nq) return;
  float best = CUDART_INF_F;
  int arg = -1;
  for (int c = 0; c < chunks; ++c) {
    const float d = part_d[static_cast<size_t>(c) * nq + i];
    if (d < best) {
      best = d;
      arg = part_i[static_cast<size_t>(c) * nq + i];
    }
  }
  d_out[i] = arg >= 0 ? fmaxf(best, 0.0f) : CUDART_INF_F;
  idx_out[i] = arg >= 0 ? arg : 0;
}

}  // namespace

extern "C" int scl_nn_select(const float* query, const float* payload,
                             float* part_d, int32_t* part_i, float* d_out,
                             float* sel_out, int nq, int nt, int rows,
                             int chunk, int chunks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((nq + kThreads - 1) / kThreads, chunks);
  nn_select_partial_kernel<<<grid, kThreads, 0, s>>>(
      query, payload, part_d, part_i, nq, nt, chunk, static_cast<size_t>(nt), 1);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int finish_threads = 128;
  nn_select_finish_kernel<<<(nq + finish_threads - 1) / finish_threads,
                            finish_threads, 0, s>>>(part_d, part_i, payload,
                                                    d_out, sel_out, nq, nt,
                                                    rows, chunks);
  return static_cast<int>(cudaGetLastError());
}

// K3: target [Nt, 3] (row stride 1, column stride 3 in pass 1's terms).
extern "C" int scl_nearest_neighbors(const float* query, const float* target,
                                     float* part_d, int32_t* part_i,
                                     float* d_out, int32_t* idx_out, int nq,
                                     int nt, int chunk, int chunks, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((nq + kThreads - 1) / kThreads, chunks);
  nn_select_partial_kernel<<<grid, kThreads, 0, s>>>(
      query, target, part_d, part_i, nq, nt, chunk, 1, 3);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int finish_threads = 128;
  nearest_neighbors_finish_kernel<<<(nq + finish_threads - 1) / finish_threads,
                                    finish_threads, 0, s>>>(
      part_d, part_i, d_out, idx_out, nq, chunks);
  return static_cast<int>(cudaGetLastError());
}
