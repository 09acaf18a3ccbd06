// Prefetching KITTI .bin scan reader, built for ctypes (the loader half of
// the JAX package's native/dataloader.cpp; its host Scan Context binning
// is not carried).
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

#include <atomic>
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
