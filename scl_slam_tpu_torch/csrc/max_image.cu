// K2: exact bin-wise max image (the Scan Context polar max-height image).
//
// Replaces scl_slam_tpu/ops/pallas_kernels.py::max_image_pallas (kernel body
// _max_image_kernel). The TPU kernel is a 4-pass quantized max that lands up
// to span / 9^4 below the true maximum and was never wired in; the JAX replay
// path builds the image with ops/pointcloud.py::scatter_max_image instead.
// This kernel computes that function exactly, and the port's Scan Context
// build (descriptors/scan_context.py::make) runs through it.
//
// Contract (the plain version is ops/kernels.py::max_image_plain):
//   values [B, N] f32, ring / sector [B, N] int32, valid [B, N] bool
//   -> out [B, R, S]: out[b, r, s] = max(0, max of values[b, k] over the
//   valid points k in bin (r, s)). Empty bins read 0; points with an
//   out-of-range bin are ignored.
//
// Exactness: only values > 0 take part, and for non-negative IEEE floats the
// order of their bit patterns read as uint32 equals the order of the values.
// So an integer atomicMax on the bits gives the float maximum bit for bit,
// whatever order the atomics land in, and the all-zero initial image is the
// float 0.0 that empty bins and non-positive values read.
//
// What bounds it on the H100: reading B x N x (4 + 4 + 4 + 1) bytes (27.3 MB
// at the replay path's 32 x 65,536 points) plus shared-memory atomics, which
// serialize when many points of one warp hit one bin. Design: one block per
// frame holds the frame's R x S image (at most 4096 bins, 16 KB) as uint32 in
// shared memory; its threads walk the frame's points with coalesced loads.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
max_image_kernel(const float* __restrict__ values,
                 const int32_t* __restrict__ ring,
                 const int32_t* __restrict__ sector,
                 const uint8_t* __restrict__ valid,
                 float* __restrict__ out, int n, int rings, int sectors) {
  extern __shared__ unsigned int img[];
  const int bins = rings * sectors;
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  for (int k = threadIdx.x; k < bins; k += kThreads) img[k] = 0u;
  __syncthreads();
  for (int k = threadIdx.x; k < n; k += kThreads) {
    const float v = values[base + k];
    if (valid[base + k] && v > 0.0f) {
      const int r = ring[base + k];
      const int s = sector[base + k];
      if (r >= 0 && r < rings && s >= 0 && s < sectors) {
        atomicMax(&img[r * sectors + s], __float_as_uint(v));
      }
    }
  }
  __syncthreads();
  float* o = out + static_cast<size_t>(blockIdx.x) * bins;
  for (int k = threadIdx.x; k < bins; k += kThreads) o[k] = __uint_as_float(img[k]);
}

}  // namespace

extern "C" int scl_max_image(const float* values, const int32_t* ring,
                             const int32_t* sector, const uint8_t* valid,
                             float* out, int batch, int n, int rings,
                             int sectors, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(rings) * sectors * sizeof(unsigned int);
  max_image_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      values, ring, sector, valid, out, n, rings, sectors);
  return static_cast<int>(cudaGetLastError());
}
