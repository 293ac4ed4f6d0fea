// Parallel blob I/O for checkpoint shards: a std::thread pool that
// writes or reads every shard of an array concurrently, without Python
// in the loop. The port's own copy of the blob functions of
// spartan_tpu/native/spartan_native.cpp, behind the same C interface
// (bound through ctypes by spartan_tpu_torch/native/__init__.py).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread blob_io.cpp -o lib.so

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <thread>
#include <vector>

namespace {

int write_one(const char* path, const uint8_t* data, int64_t size) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  size_t wrote = std::fwrite(data, 1, (size_t)size, f);
  int closed = std::fclose(f);
  return (wrote == (size_t)size && closed == 0) ? 0 : -2;
}

int read_one(const char* path, uint8_t* data, int64_t size) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  size_t got = std::fread(data, 1, (size_t)size, f);
  std::fclose(f);
  return got == (size_t)size ? 0 : -2;
}

// Runs job(i) for i in [0, n) on up to nthreads threads. Returns 0, or
// the status of the first job that failed; *failed gets its index.
template <typename Job>
int32_t run_pool(int64_t n, int32_t nthreads, int64_t* failed,
                        Job job) {
  if (nthreads < 1) nthreads = 1;
  std::atomic<int64_t> next(0);
  std::atomic<int32_t> status(0);
  std::atomic<int64_t> first(-1);
  auto work = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) break;
      int rc = job(i);
      if (rc != 0) {
        int32_t expected = 0;
        if (status.compare_exchange_strong(expected, rc)) first.store(i);
      }
    }
  };
  std::vector<std::thread> threads;
  int32_t tcount = (int32_t)(n < nthreads ? n : nthreads);
  threads.reserve(tcount);
  for (int32_t t = 0; t < tcount; ++t) threads.emplace_back(work);
  for (auto& th : threads) th.join();
  *failed = first.load();
  return status.load();
}

}  // namespace

extern "C" {

int32_t blob_write_parallel(const char** paths, const uint8_t** ptrs,
                            const int64_t* sizes, int64_t n,
                            int32_t nthreads, int64_t* failed) {
  return run_pool(n, nthreads, failed, [&](int64_t i) {
    return write_one(paths[i], ptrs[i], sizes[i]);
  });
}

int32_t blob_read_parallel(const char** paths, uint8_t** ptrs,
                           const int64_t* sizes, int64_t n,
                           int32_t nthreads, int64_t* failed) {
  return run_pool(n, nthreads, failed, [&](int64_t i) {
    return read_one(paths[i], ptrs[i], sizes[i]);
  });
}

}  // extern "C"
