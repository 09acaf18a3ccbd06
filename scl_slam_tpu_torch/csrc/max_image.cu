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
// whatever order the atomics land in (in shared memory and across blocks
// alike), and the all-zero initial image is the float 0.0 that empty bins
// and non-positive values read.
//
// What bounds it on the H100: reading B x N x (4 + 4 + 4 + 1) bytes (27.3 MB
// at the replay path's 32 x 65,536 points, 1.7 MB at the live path's one
// frame of 131,072) plus shared-memory atomics, which serialize when many
// points of one warp hit one bin. The live path launches it one frame at a
// time, so a block per frame would leave all but one SM idle.
//
// Design: a grid of (chunks, frames) blocks, the chunks of a frame
// contiguous, a multiple of 4 points long and at least the split's points
// a block (ops/kernels.py::k2_geometry). A block clears its R x S image
// as uint32 in shared memory (Scan Context's 20 x 60 bins take 4.7 KB,
// LiDAR-Iris's 80 x 360 take 113 KB: above 48 KB the launch opts in to the
// card's larger shared memory a block, 227 KB or ~58,000 bins on an H100,
// which scl_max_image_max_bins reports), walks its chunk
// (where N % 4 == 0 and the rows are 16-byte aligned, with 16-byte loads:
// float4 values, int4 ring and sector, 4 valid bytes as one word; with a
// scalar loop elsewhere), and applies atomicMax on the bits. Then it
// merges its non-zero bins into the frame's image: with one chunk a frame
// by plain stores, else by a global atomicMax into the output, which a
// memset queued by the same call zeroes first. Every chunk costs its block
// a clear, a scan and up to R x S global atomics, which the frame's other
// chunks aim at the same addresses: so the chunks are long (4,096 points
// and more) and a one-frame launch runs on a few dozen SMs, near the
// floor of a launch (scripts/torch_k2_k6_sweep.py; PERF.md). A large image
// makes the clear and the flush cost more than a short chunk's scan, so
// k2_geometry lengthens the chunks with the bin count.
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

__device__ __forceinline__ void put(unsigned int* img, float v, int r, int s, bool ok,
                                    int rings, int sectors) {
  if (ok && v > 0.0f && static_cast<unsigned>(r) < static_cast<unsigned>(rings) &&
      static_cast<unsigned>(s) < static_cast<unsigned>(sectors)) {
    atomicMax(&img[r * sectors + s], __float_as_uint(v));
  }
}

template <bool kVec>
__global__ void max_image_kernel(const float* __restrict__ values,
                                 const int32_t* __restrict__ ring,
                                 const int32_t* __restrict__ sector,
                                 const uint8_t* __restrict__ valid,
                                 float* __restrict__ out, int n, int rings, int sectors,
                                 int chunk_len) {
  extern __shared__ unsigned int img[];
  const int bins = rings * sectors;
  const int b = blockIdx.y;
  const int k0 = blockIdx.x * chunk_len;
  const int k1 = min(n, k0 + chunk_len);
  const size_t row = static_cast<size_t>(b) * n;
  for (int k = threadIdx.x; k < bins; k += blockDim.x) img[k] = 0u;
  __syncthreads();

  if constexpr (kVec) {  // k0, k1 and row are multiples of 4
    const float4* v4 = reinterpret_cast<const float4*>(values + row);
    const int4* r4 = reinterpret_cast<const int4*>(ring + row);
    const int4* s4 = reinterpret_cast<const int4*>(sector + row);
    const uint32_t* m4 = reinterpret_cast<const uint32_t*>(valid + row);
    for (int g = k0 / 4 + threadIdx.x; g < k1 / 4; g += blockDim.x) {
      const float4 v = __ldg(v4 + g);
      const int4 r = __ldg(r4 + g);
      const int4 s = __ldg(s4 + g);
      const uint32_t m = __ldg(m4 + g);
      put(img, v.x, r.x, s.x, (m & 0xffu) != 0u, rings, sectors);
      put(img, v.y, r.y, s.y, (m & 0xff00u) != 0u, rings, sectors);
      put(img, v.z, r.z, s.z, (m & 0xff0000u) != 0u, rings, sectors);
      put(img, v.w, r.w, s.w, (m & 0xff000000u) != 0u, rings, sectors);
    }
  } else {
    for (int k = k0 + threadIdx.x; k < k1; k += blockDim.x) {
      put(img, __ldg(values + row + k), __ldg(ring + row + k), __ldg(sector + row + k),
          __ldg(valid + row + k) != 0, rings, sectors);
    }
  }
  __syncthreads();

  float* o = out + static_cast<size_t>(b) * bins;
  if (gridDim.x == 1) {
    for (int k = threadIdx.x; k < bins; k += blockDim.x) o[k] = __uint_as_float(img[k]);
    return;
  }
  unsigned int* dst = reinterpret_cast<unsigned int*>(o);
  for (int k = threadIdx.x; k < bins; k += blockDim.x) {
    const unsigned int u = img[k];
    if (u != 0u) atomicMax(dst + k, u);
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// the default dynamic shared memory a block; more needs the opt-in
constexpr size_t kDefaultSmem = 48 * 1024;

// Opts a kernel in to all the shared memory a block that the device allows,
// once a process and device (the attribute holds for the current device
// only; a later call on that device, under CUDA-graph capture too, sets
// nothing; the limit is only ever raised, so concurrent callers cannot
// lower it). done is null for a device past kMaxDevices: set every call.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, int device, std::atomic<bool>* done) {
  if (smem <= kDefaultSmem || (done != nullptr && done->load())) return cudaSuccess;
  int optin = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess && done != nullptr) done->store(true);
  return err;
}

constexpr int kMaxDevices = 64;
// per device and template instance (kVec), false
std::atomic<bool> g_smem_optin[kMaxDevices][2];

std::atomic<bool>* optin_flag(int device, int vec) {
  return device >= 0 && device < kMaxDevices ? &g_smem_optin[device][vec ? 1 : 0] : nullptr;
}

}  // namespace

// Geometry (threads, chunk_len, chunks) from ops/kernels.py::k2_geometry;
// vec asks for the 16-byte loads, which need n % 4 == 0, chunk_len % 4 == 0
// and aligned rows (refused otherwise).
extern "C" int scl_max_image(const float* values, const int32_t* ring,
                             const int32_t* sector, const uint8_t* valid,
                             float* out, int batch, int n, int rings, int sectors,
                             int threads, int chunk_len, int chunks, int vec, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (vec && (n % 4 != 0 || chunk_len % 4 != 0 || !aligned(values, 16) ||
              !aligned(ring, 16) || !aligned(sector, 16) || !aligned(valid, 4))) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bins = static_cast<size_t>(rings) * sectors;
  if (chunks > 1) {
    err = cudaMemsetAsync(out, 0, static_cast<size_t>(batch) * bins * sizeof(float), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(chunks, batch);
  const size_t smem = bins * sizeof(unsigned int);
  err = vec ? allow_smem(max_image_kernel<true>, smem, device, optin_flag(device, 1))
            : allow_smem(max_image_kernel<false>, smem, device, optin_flag(device, 0));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (vec) {
    max_image_kernel<true><<<grid, threads, smem, s>>>(values, ring, sector, valid, out, n,
                                                       rings, sectors, chunk_len);
  } else {
    max_image_kernel<false><<<grid, threads, smem, s>>>(values, ring, sector, valid, out, n,
                                                        rings, sectors, chunk_len);
  }
  return static_cast<int>(cudaGetLastError());
}

// The most bins an image may have on this device: its opt-in shared memory
// a block over 4 bytes a bin; -1 on an error.
extern "C" int scl_max_image_max_bins(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess) {
    return -1;
  }
  return optin / static_cast<int>(sizeof(unsigned int));
}
