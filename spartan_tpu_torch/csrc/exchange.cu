// Sample-sort send-buffer pack for Hopper (sm_90a).
//
// partition_pack replaces spartan_tpu/kernels/exchange.py::partition_pack
// (the Pallas TPU kernel behind ops/sort.py's padded transport). Each
// logical shard i holds its locally sorted stream xs[i, 0:m); the
// splitters cut it into p contiguous runs, run j starting at
// starts[i, j] with counts[i, j] elements. The send buffer is
//
//   out[i, j, t] = xs[i, starts[i, j] + t]   for t < counts[i, j]
//   out[i, j, t] = 0                         for counts[i, j] <= t < m
//
// The TPU kernel rolls lanes with a one-hot permutation matmul on the
// MXU, split into 16-bit halves so that every 32-bit pattern survives
// the float product; none of that carries over. Here the kernel moves
// raw 32-bit words, so any 4-byte dtype, NaN payloads and -0.0 included,
// is copied bit for bit by construction.
//
// Design: a 1-D grid over (shard i, destination j, tile of the row);
// thread t of a CTA copies words t, t + 256, ... of its tile, so a warp
// reads 32 consecutive source words and writes 32 consecutive output
// words. starts/counts are clamped into the source row, so a malformed
// run can never read outside it.
//
// Bound on an H100 SXM at the sort phase's shape (n = 2^26 f32 keys over
// p = 8 logical shards, m = 2^23): the function reads 4 p m bytes and
// writes 4 p p m bytes, 2.4 GB over 3.35 TB/s ~ 0.72 ms; it does no
// arithmetic. So it is bound by bytes, and by the writes: the padded
// transport's static (p, m) rows are the price of static shapes.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWordsPerThread = 8;
constexpr long long kTile = kThreads * kWordsPerThread;  // words per CTA

__global__ void __launch_bounds__(kThreads)
partition_pack_kernel(const uint32_t* __restrict__ xs,
                      const int* __restrict__ starts,
                      const int* __restrict__ counts,
                      uint32_t* __restrict__ out, int p, long long m,
                      long long tiles) {
  const long long blk = blockIdx.x;
  const long long tile = blk % tiles;
  const long long run = blk / tiles;  // shard * p + destination
  const long long shard = run / p;
  long long s = starts[run];
  s = s < 0 ? 0 : (s > m ? m : s);
  long long c = counts[run];
  c = c < 0 ? 0 : (c > m - s ? m - s : c);
  const uint32_t* src = xs + shard * m + s;
  uint32_t* dst = out + run * m;
  const long long t0 = tile * kTile + threadIdx.x;
#pragma unroll
  for (int u = 0; u < kWordsPerThread; ++u) {
    const long long t = t0 + static_cast<long long>(u) * kThreads;
    if (t < m) dst[t] = t < c ? src[t] : 0u;
  }
}

}  // namespace

extern "C" {

// Pack the send buffers of `shards` logical shards. xs: (shards, m)
// 32-bit words; starts, counts: (shards, p) int32; out: (shards, p, m)
// words. Launches on `stream`, does not synchronise, returns
// cudaGetLastError().
int spartan_partition_pack(const void* xs, const void* starts,
                           const void* counts, void* out, long long shards,
                           int p, long long m, void* stream) {
  if (shards < 0 || p <= 0 || m < 0) return cudaErrorInvalidValue;
  if (shards == 0 || m == 0) return cudaSuccess;
  const long long tiles = (m + kTile - 1) / kTile;
  const long long blocks = shards * p * tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  partition_pack_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(xs), static_cast<const int*>(starts),
      static_cast<const int*>(counts), static_cast<uint32_t*>(out), p, m,
      tiles);
  return cudaGetLastError();
}

}  // extern "C"
