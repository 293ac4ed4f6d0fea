// Per-shard top-k selection for Hopper (sm_90a).
//
// shard_topk replaces spartan_tpu/kernels/topk.py::shard_topk (the
// Pallas TPU kernel behind ops/sort.py distributed_topk's local stage).
// For each row b of keys (rows, m), f32 or int32, and k <= 128 it
// returns the k best keys and their local int32 indices, best first.
// The order is lax.top_k's, and it is total: a larger key wins, and of
// two equal keys the lower index wins. f32 keys compare by their raw
// bits in IEEE total order (+NaN above +inf, +0.0 above -0.0, -NaN below
// -inf), which is how lax.top_k orders them; int32 keys compare as
// integers, never through float. The TPU kernel extracts the maximum k
// times per block with VPU reductions; none of that carries over.
//
// Design: every candidate is one 64-bit word, its order key in the high
// half and the complement of its index in the low half, so one unsigned
// compare carries the whole order and no two candidates are equal. A
// CTA keeps its best k words sorted in shared memory, at the front of a
// 1024-word buffer. It reads its chunk 256 words at a time; a word that
// beats the current k-th best is appended behind them, and when the next
// tile might not fit, the CTA bitonic-sorts the buffer (descending) and
// keeps the first k. Pass 1 runs one CTA per chunk of a row; pass 2 runs
// one CTA per row over the chunks' candidates, in chunk order, with the
// same code; a last kernel turns each row's k words back into keys (read
// from the input by index) and indices. No atomics but the append slot,
// and because the order is total the result is one exact answer.
//
// Empty slots (a row of fewer than k keys) get (sentinel, 2^30), and
// returned indices are clamped to m - 1, as in the TPU kernel.
//
// Bound on an H100 SXM at the topk phase's shape (2^26 keys over p = 8
// logical shards, k = 128): the function must read 4 p m bytes and
// write 8 p k, 268 MB over 3.35 TB/s ~ 0.080 ms; the compares are
// nothing beside that. So it is bound by bytes. This first version
// spends its time in the bitonic merges, not in the reads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBuffer = 1024;  // words of the candidate buffer
constexpr int kMaxK = 128;

enum Kind { kF32 = 0, kI32 = 1, kWords = 2 };

__device__ __forceinline__ uint32_t order_f32(uint32_t bits) {
  // IEEE total order as an unsigned key: negatives reversed below
  // positives
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

__device__ __forceinline__ uint32_t order_i32(uint32_t bits) {
  return bits ^ 0x80000000u;
}

template <int KIND>
__device__ __forceinline__ uint64_t candidate(const void* in, long long row,
                                              long long len, long long i) {
  if (KIND == kWords)
    return static_cast<const uint64_t*>(in)[row * len + i];
  const uint32_t bits = static_cast<const uint32_t*>(in)[row * len + i];
  const uint32_t key = KIND == kF32 ? order_f32(bits) : order_i32(bits);
  return (static_cast<uint64_t>(key) << 32) |
         static_cast<uint32_t>(~static_cast<uint32_t>(i));
}

// Sort buf[0:kBuffer) descending; every thread takes part.
__device__ void bitonic_desc(uint64_t* buf) {
  for (int size = 2; size <= kBuffer; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < kBuffer / 2; t += kThreads) {
        const int i = 2 * stride * (t / stride) + (t % stride);
        const int j = i + stride;
        const bool desc = (i & size) == 0;
        const uint64_t a = buf[i];
        const uint64_t b = buf[j];
        if ((a < b) == desc) {
          buf[i] = b;
          buf[j] = a;
        }
      }
      __syncthreads();
    }
  }
}

// Merge the appended words into the best k: sort, keep the first k,
// clear the rest.
__device__ void merge(uint64_t* buf, int* n_new, int k) {
  bitonic_desc(buf);
  for (int j = k + threadIdx.x; j < kBuffer; j += kThreads) buf[j] = 0;
  if (threadIdx.x == 0) *n_new = 0;
  __syncthreads();
}

// The best k of in[row, lo:hi) for each (chunk, row) = (blockIdx.x,
// blockIdx.y), written to cand[row, chunk, 0:k) best first (0: empty).
template <int KIND>
__global__ void __launch_bounds__(kThreads)
topk_chunks_kernel(const void* __restrict__ in, uint64_t* __restrict__ cand,
                   long long len, long long chunk, int k) {
  __shared__ uint64_t buf[kBuffer];
  __shared__ int n_new;
  for (int j = threadIdx.x; j < kBuffer; j += kThreads) buf[j] = 0;
  if (threadIdx.x == 0) n_new = 0;
  __syncthreads();
  const long long row = blockIdx.y;
  const long long lo = static_cast<long long>(blockIdx.x) * chunk;
  const long long hi = lo + chunk < len ? lo + chunk : len;
  for (long long base = lo; base < hi; base += kThreads) {
    const int pending = n_new;
    __syncthreads();  // every thread has read n_new before any append
    if (k + pending + kThreads > kBuffer) merge(buf, &n_new, k);
    const uint64_t thr = buf[k - 1];  // 0 until k candidates are held
    const long long i = base + threadIdx.x;
    if (i < hi) {
      const uint64_t c = candidate<KIND>(in, row, len, i);
      if (c > thr) buf[k + atomicAdd(&n_new, 1)] = c;
    }
    __syncthreads();
  }
  if (n_new > 0) merge(buf, &n_new, k);
  const long long out = (row * gridDim.x + blockIdx.x) * k;
  for (int j = threadIdx.x; j < k; j += kThreads) cand[out + j] = buf[j];
}

// Words back to (key, index): the key is read from the input by index.
__global__ void topk_finish_kernel(const uint32_t* __restrict__ keys,
                                   const uint64_t* __restrict__ cand,
                                   uint32_t* __restrict__ out_keys,
                                   int* __restrict__ out_idx, long long m,
                                   int k, uint32_t sentinel) {
  const long long row = blockIdx.x;
  const int j = threadIdx.x;
  if (j >= k) return;
  const uint64_t c = cand[row * k + j];
  long long idx = 1LL << 30;
  uint32_t key = sentinel;
  if (c != 0) {
    idx = static_cast<uint32_t>(~static_cast<uint32_t>(c));
    key = keys[row * m + idx];
  }
  out_keys[row * k + j] = key;
  out_idx[row * k + j] = static_cast<int>(idx < m - 1 ? idx : m - 1);
}

template <int KIND>
cudaError_t launch_chunks(const void* in, uint64_t* cand, long long rows,
                          long long len, long long chunk, long long chunks,
                          int k, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(chunks),
                  static_cast<unsigned>(rows));
  topk_chunks_kernel<KIND><<<grid, kThreads, 0, stream>>>(in, cand, len,
                                                          chunk, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Top-k of each row of keys (rows, m): f32 when is_float, else int32.
// cand1 holds rows * chunks * k uint64 words of scratch and cand2 rows * k;
// a CTA of pass 1 takes `chunk` keys of a row. out_keys: (rows, k) 32-bit
// words, out_idx: (rows, k) int32. Launches on `stream`, does not
// synchronise, returns cudaGetLastError().
int spartan_shard_topk(const void* keys, void* cand1, void* cand2,
                       void* out_keys, void* out_idx, long long rows,
                       long long m, int k, int is_float, long long chunk,
                       long long chunks, unsigned sentinel, void* stream) {
  if (rows <= 0 || m <= 0 || k < 1 || k > kMaxK || chunk <= 0 ||
      chunks <= 0 || chunks > 0x7fffffffLL || rows > 65535 ||
      (chunks - 1) * chunk >= m || m >= (1LL << 31))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint64_t* c1 = static_cast<uint64_t*>(cand1);
  uint64_t* c2 = static_cast<uint64_t*>(cand2);
  cudaError_t err = is_float
      ? launch_chunks<kF32>(keys, c1, rows, m, chunk, chunks, k, s)
      : launch_chunks<kI32>(keys, c1, rows, m, chunk, chunks, k, s);
  if (err != cudaSuccess) return err;
  const uint64_t* best = c1;
  if (chunks > 1) {
    // pass 2: one CTA per row over its chunks' candidates, in chunk order
    const long long len = chunks * k;
    err = launch_chunks<kWords>(c1, c2, rows, len, len, 1, k, s);
    if (err != cudaSuccess) return err;
    best = c2;
  }
  topk_finish_kernel<<<static_cast<unsigned>(rows), kMaxK, 0, s>>>(
      static_cast<const uint32_t*>(keys), best,
      static_cast<uint32_t*>(out_keys), static_cast<int*>(out_idx), m, k,
      sentinel);
  return cudaGetLastError();
}

}  // extern "C"
