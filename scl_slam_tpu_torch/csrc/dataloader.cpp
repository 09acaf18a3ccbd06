// Prefetching KITTI .bin scan reader and host Scan Context binning, built
// for ctypes (the port's copy of the JAX package's native/dataloader.cpp).
//
// A worker pool reads velodyne .bin files (interleaved float32 x, y, z,
// reflectance), pads or truncates each into a fixed-capacity [capacity, 3]
// buffer (the static-shape contract of the pipeline), and hands them over
// in index order through a bounded queue, so that disk reads overlap the
// device's work.
//
// Workers claim only indices below next_to_pop + max_queue: at most
// max_queue scans are read or waiting at any time, so a finished scan is
// always pushed at once. (Where a worker instead waits for room in a full
// queue after its read, a worker that falls max_queue scans behind holds
// the index the consumer waits for while the others fill the queue, and
// both sides wait forever.)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Scan {
  int64_t index = -1;
  int32_t n_points = 0;   // valid points (<= capacity), -1 on a read error
  std::vector<float> xyz;  // [capacity * 3], padded with pad_value
};

struct Loader {
  std::vector<std::string> paths;
  int capacity;
  float pad_value;
  int n_workers;

  std::mutex mu;
  std::condition_variable cv_ready;  // a scan was pushed
  std::condition_variable cv_claim;  // the claim window moved, or stop
  // min-heap by index so that scans pop in order
  struct Cmp {
    bool operator()(const Scan* a, const Scan* b) const {
      return a->index > b->index;
    }
  };
  std::priority_queue<Scan*, std::vector<Scan*>, Cmp> ready;
  int64_t next_to_read = 0;  // next file index to claim
  int64_t next_to_pop = 0;   // next index the consumer expects
  int64_t max_queue;
  std::atomic<bool> stop{false};
  std::vector<std::thread> workers;

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop.store(true);
    }
    cv_claim.notify_all();
    for (auto& t : workers)
      if (t.joinable()) t.join();
    while (!ready.empty()) {
      delete ready.top();
      ready.pop();
    }
  }
};

void read_scan(const Loader* L, Scan* scan) {
  scan->xyz.assign((size_t)L->capacity * 3, L->pad_value);
  FILE* f = fopen(L->paths[scan->index].c_str(), "rb");
  if (!f) {
    scan->n_points = -1;
    return;
  }
  std::vector<float> buf(4096 * 4);
  int32_t count = 0;
  size_t got;
  while (count < L->capacity &&
         (got = fread(buf.data(), sizeof(float), buf.size(), f)) > 0) {
    size_t pts = got / 4;
    for (size_t p = 0; p < pts && count < L->capacity; ++p, ++count) {
      scan->xyz[(size_t)count * 3 + 0] = buf[p * 4 + 0];
      scan->xyz[(size_t)count * 3 + 1] = buf[p * 4 + 1];
      scan->xyz[(size_t)count * 3 + 2] = buf[p * 4 + 2];
    }
  }
  fclose(f);
  scan->n_points = count;
}

void worker_main(Loader* L) {
  const int64_t n = (int64_t)L->paths.size();
  for (;;) {
    int64_t idx;
    {
      std::unique_lock<std::mutex> lk(L->mu);
      L->cv_claim.wait(lk, [&] {
        return L->stop.load() || L->next_to_read >= n ||
               L->next_to_read < L->next_to_pop + L->max_queue;
      });
      if (L->stop.load() || L->next_to_read >= n) return;
      idx = L->next_to_read++;
    }
    auto* scan = new Scan();
    scan->index = idx;
    read_scan(L, scan);
    std::lock_guard<std::mutex> lk(L->mu);
    if (L->stop.load()) {
      delete scan;
      return;
    }
    L->ready.push(scan);
    L->cv_ready.notify_all();
  }
}

}  // namespace

extern "C" {

void* loader_create(const char** paths, int n_paths, int capacity,
                    float pad_value, int n_workers, int queue_depth) {
  auto* L = new Loader();
  L->paths.assign(paths, paths + n_paths);
  L->capacity = capacity;
  L->pad_value = pad_value;
  L->n_workers = n_workers > 0 ? n_workers : 2;
  L->max_queue = queue_depth > 0 ? queue_depth : 4;
  for (int i = 0; i < L->n_workers; ++i)
    L->workers.emplace_back(worker_main, L);
  return L;
}

// Blocking in-order pop. Returns the valid point count, -1 on a read
// error, -2 when the sequence is exhausted. out_xyz holds capacity * 3
// floats.
int loader_next(void* handle, float* out_xyz) {
  auto* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->next_to_pop >= (int64_t)L->paths.size()) return -2;
  L->cv_ready.wait(lk, [&] {
    return !L->ready.empty() && L->ready.top()->index == L->next_to_pop;
  });
  Scan* s = L->ready.top();
  L->ready.pop();
  L->next_to_pop++;
  lk.unlock();
  L->cv_claim.notify_all();
  std::memcpy(out_xyz, s->xyz.data(), s->xyz.size() * sizeof(float));
  int n = s->n_points;
  delete s;
  return n;
}

int loader_capacity(void* handle) {
  return static_cast<Loader*>(handle)->capacity;
}

void loader_destroy(void* handle) { delete static_cast<Loader*>(handle); }

}  // extern "C"

// ---------------------------------------------------------------------------
// Host Scan Context binning (the replay's host_descriptors input mode).
//
// The per-bin max-height image as descriptors/scan_context.make builds it
// (ops/pointcloud.polar_bins + scatter_max_image): f32 sqrt and atan2,
// truncating int casts clipped to [0, bins - 1], the r < max_radius gate
// (min_radius = 0), the max of z + lidar_height over an image that starts
// at 0. One pass over the points, threaded over frames, so that a chunk's
// images are built on the host while the card runs the chunk before it.
//
// The atan2 is a polynomial (below), so a point within ~2e-7 rad of a
// sector boundary may land one sector over from torch.atan2's; the tests
// bound the images' disagreement. The library is built with
// -ffp-contract=off: no product and sum is fused into an FMA, on any host
// CPU, so its bins do not depend on the machine that built it.

namespace {

// atan on [0, 1]: odd minimax polynomial of degree 11, max error ~2e-7
// rad. Branchless, so the binning loop vectorizes (atan2f is a libm call).
inline float atan_poly01(float t) {
  float t2 = t * t;
  float p = -0.01172120f;
  p = p * t2 + 0.05265332f;
  p = p * t2 + -0.11643287f;
  p = p * t2 + 0.19354346f;
  p = p * t2 + -0.33262347f;
  p = p * t2 + 0.99997726f;
  return p * t;
}

void sc_bin_frames(const float* xyz, const unsigned char* mask, int64_t b0,
                   int64_t b1, int64_t n, int num_rings, int num_sectors,
                   float max_radius, float lidar_height, float* out) {
  const float kPi = 3.14159274101257324f;     // f32(pi)
  const float kTwoPi = 6.28318548202514648f;  // f32(2 pi)
  const float kHalfPi = 1.57079632679489662f;
  constexpr int64_t kBlock = 4096;
  std::vector<int32_t> idx(kBlock);
  std::vector<float> val(kBlock);
  for (int64_t b = b0; b < b1; ++b) {
    float* img = out + b * num_rings * num_sectors;
    std::memset(img, 0, sizeof(float) * num_rings * num_sectors);
    const float* pts = xyz + b * n * 3;
    const unsigned char* mk = mask ? mask + b * n : nullptr;
    for (int64_t q0 = 0; q0 < n; q0 += kBlock) {
      int64_t m = std::min(kBlock, n - q0);
      // pass 1: each point's bin (-1 where it is masked or out of range)
      for (int64_t i = 0; i < m; ++i) {
        int64_t p = q0 + i;
        float x = pts[p * 3 + 0];
        float y = pts[p * 3 + 1];
        float z = pts[p * 3 + 2];
        float r = sqrtf(x * x + y * y);
        // atan2(y, x) from atan on [0, 1] by octant
        float ax = fabsf(x), ay = fabsf(y);
        float num = fminf(ax, ay), den = fmaxf(fmaxf(ax, ay), 1e-30f);
        float a = atan_poly01(num / den);
        a = (ay > ax) ? (kHalfPi - a) : a;
        a = (x < 0.0f) ? (kPi - a) : a;
        a = (y < 0.0f) ? -a : a;
        float frac = (a + kPi) / kTwoPi;
        int sector = (int)(frac * (float)num_sectors);
        sector = sector < 0 ? 0 : sector;
        sector = sector >= num_sectors ? num_sectors - 1 : sector;
        int ring = (int)(r / max_radius * (float)num_rings);
        ring = ring < 0 ? 0 : ring;
        ring = ring >= num_rings ? num_rings - 1 : ring;
        bool ok = (r < max_radius) && (!mk || mk[p]);
        idx[i] = ok ? ring * num_sectors + sector : -1;
        val[i] = z + lidar_height;
      }
      // pass 2: the scatter-max
      for (int64_t i = 0; i < m; ++i) {
        int32_t k = idx[i];
        if (k >= 0 && val[i] > img[k]) img[k] = val[i];
      }
    }
  }
}

}  // namespace

extern "C" {

// Batched images: xyz [B, N, 3] f32, mask [B, N] u8 (null: every point
// valid), out_images [B, num_rings, num_sectors] f32; the frames are split
// over n_threads threads.
void sc_images_batch(const float* xyz, const unsigned char* mask,
                     int64_t batch, int64_t n, int num_rings, int num_sectors,
                     float max_radius, float lidar_height, float* out_images,
                     int n_threads) {
  if (n_threads < 1) n_threads = 1;
  if ((int64_t)n_threads > batch) n_threads = (int)batch;
  if (n_threads <= 1) {
    sc_bin_frames(xyz, mask, 0, batch, n, num_rings, num_sectors, max_radius,
                  lidar_height, out_images);
    return;
  }
  std::vector<std::thread> ts;
  int64_t per = (batch + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t b0 = t * per, b1 = std::min<int64_t>(batch, b0 + per);
    if (b0 >= b1) break;
    ts.emplace_back(sc_bin_frames, xyz, mask, b0, b1, n, num_rings,
                    num_sectors, max_radius, lidar_height, out_images);
  }
  for (auto& t : ts) t.join();
}

}  // extern "C"
