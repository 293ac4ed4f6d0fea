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
// Bound on an H100 SXM at the topk phase's shape (2^26 keys over p = 8
// logical shards, k = 128): the function must read 4 p m bytes and
// write 8 p k, 268 MB over 3.35 TB/s ~ 0.080 ms; the compares are
// nothing beside that. So it is bound by bytes, and the design's aim is
// to stream every key once at the card's rate and to spend little else.
//
// Every candidate is one 64-bit word, its order key in the high half
// and the complement of its index in the low half, so one unsigned
// compare carries the whole order and no two keys give equal words.
//
// Pass 1 runs one CTA per chunk of a row; the wrapper sizes the chunks
// so that all rows' chunks make about four CTAs per SM, one wave. A CTA
// keeps its best k words sorted in shared memory and the k-th of them
// in a register as the threshold:
//   * Seed. Before the scan it takes the best k words of a sample, 8
//     runs of 128 keys spread from the chunk's first key to its last
//     (every key when the chunk holds at most 1024). The k-th best of a
//     subset is never above the chunk's, so the threshold is sound from
//     the start; with runs at both ends, an ascending or descending
//     chunk has its answer in the sample and appends nearly nothing.
//     The scan skips the sampled keys, so every key is weighed once.
//   * Stream. Each thread reads four 16-byte vectors per step (16 keys,
//     4096 per CTA) with the next step's vectors already in flight, and
//     compares each key's word with the threshold. A warp appends its
//     survivors with one shared atomic (ballot and popc give the
//     offsets). An unaligned head and tail of the chunk (odd row
//     lengths) take scalar loads.
//   * Merge only what is new, and seldom. Once more than 256 survivors
//     wait after a step (or at the chunk's end) the CTA sorts just
//     those words (a bitonic network over the next power of two; one
//     warp alone up to 64 words), merges them into the sorted best k
//     by rank (each word's place is its index in its own list plus the
//     count of greater words in the other, by binary search) and takes
//     the new threshold. On uniform keys that is about 4 merges a
//     chunk instead of one after nearly every step. The append area
//     holds the waiting words and one step's keys, so it never
//     overflows; a merge sorts them 4096 at a time, so the network's
//     power-of-two padding never runs past the area either (a burst of
//     a step's keys, every one above the threshold, after a few
//     waiting words gives up to 4352).
// Pass 2 runs the same code over the chunks' candidate words, 1024
// words a CTA, level by level until one list of k is left a row (at
// the topk shape 64 lists of 128 a row: 8 CTAs a row, then one); a
// last kernel turns each row's k words back into keys (read from the
// input by index) and indices. No atomics but the append slot, and
// because the order is total the result is one exact answer, the same
// on every run.
//
// Empty slots (a row of fewer than k keys) get (sentinel, 2^30), and
// returned indices are clamped to m - 1, as in the TPU kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;         // 16-byte vectors per thread per step
constexpr int kMaxK = 128;
constexpr int kRunLen = 128;    // sampled keys per warp: 32 lanes x 4
constexpr int kSample = kWarps * kRunLen;
constexpr int kStepKeys = kThreads * kVec * 4;  // 32-bit keys a step
constexpr int kSlack = 256;     // appended words that may wait a merge
constexpr int kAppend = kStepKeys + kSlack;  // the waiting words + a step's
// A merge sorts at most kStepKeys words at once, rounded up to a power of
// two; the last piece (at most kSlack words) then still ends in the area.
static_assert((kSlack & (kSlack - 1)) == 0, "kSlack is a power of two");

enum Kind { kF32 = 0, kI32 = 1, kWords = 2 };

template <int KIND>
struct Elem {
  using T = uint32_t;
};
template <>
struct Elem<kWords> {
  using T = uint64_t;
};

struct Shared {
  uint64_t add[kAppend];       // survivors waiting for a merge
  uint64_t best[2][kMaxK];     // the best k so far, sorted; two halves
  int run[kWarps];             // chunk-relative starts of the sampled runs
  int n_add;
};

__device__ __forceinline__ uint32_t order_f32(uint32_t bits) {
  // IEEE total order as an unsigned key: negatives reversed below
  // positives
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

template <int KIND>
__device__ __forceinline__ uint64_t word(typename Elem<KIND>::T e,
                                         uint32_t idx) {
  if constexpr (KIND == kWords) {
    return e;
  } else {
    const uint32_t key = KIND == kF32 ? order_f32(e) : (e ^ 0x80000000u);
    return (static_cast<uint64_t>(key) << 32) | static_cast<uint32_t>(~idx);
  }
}

// Key q of a 16-byte vector (q is a constant once the loops unroll).
template <int KIND>
__device__ __forceinline__ typename Elem<KIND>::T key_of(const uint4& v,
                                                         int q) {
  if constexpr (KIND == kWords) {
    return q == 0 ? (static_cast<uint64_t>(v.y) << 32 | v.x)
                  : (static_cast<uint64_t>(v.w) << 32 | v.z);
  } else {
    return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
  }
}

// Append w where p holds; every lane of the warp calls this.
__device__ __forceinline__ void append(Shared& sh, bool p, uint64_t w) {
  const unsigned mask = __ballot_sync(0xffffffffu, p);
  if (mask == 0) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(mask) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(&sh.n_add, __popc(mask));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (p) sh.add[base + __popc(mask & ((1u << lane) - 1u))] = w;
}

__device__ __forceinline__ void compare_swap(uint64_t* a, int t, int stride,
                                             int size) {
  // stride is a power of two
  const int i = ((t & ~(stride - 1)) << 1) | (t & (stride - 1));
  const int j = i + stride;
  const bool desc = (i & size) == 0;
  const uint64_t x = a[i];
  const uint64_t y = a[j];
  if ((x < y) == desc) {
    a[i] = y;
    a[j] = x;
  }
}

// Sort a[0:n) descending, n a power of two; every thread calls this.
__device__ void bitonic_desc(uint64_t* a, int n) {
  if (n <= 64) {
    if (threadIdx.x < 32) {
      for (int size = 2; size <= n; size <<= 1)
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
          if (threadIdx.x < n / 2) compare_swap(a, threadIdx.x, stride, size);
          __syncwarp();
        }
    }
  } else {
    for (int size = 2; size <= n; size <<= 1)
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int t = threadIdx.x; t < n / 2; t += kThreads)
          compare_swap(a, t, stride, size);
        __syncthreads();
      }
  }
  __syncthreads();
}

// How many of the descending a[0:n) are greater than x.
__device__ __forceinline__ int count_above(const uint64_t* a, int n,
                                           uint64_t x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] > x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Merge the n words at a (nonzero, distinct, none of them among the best
// k; n <= kStepKeys) into the best k; flips `cur`. Every thread calls
// this.
__device__ void merge_piece(Shared& sh, int& cur, uint64_t* a, int n,
                            int k) {
  int n2 = 2;
  while (n2 < n) n2 <<= 1;
  for (int j = n + threadIdx.x; j < n2; j += kThreads) a[j] = 0;
  __syncthreads();
  bitonic_desc(a, n2);
  const uint64_t* b = sh.best[cur];
  uint64_t* out = sh.best[cur ^ 1];
  // a word's place among both lists: its index in its own list plus the
  // greater words of the other (an empty slot, 0, counts no new word)
  for (int i = threadIdx.x; i < k; i += kThreads) {
    const int r = i + count_above(a, n2, b[i]);
    if (r < k) out[r] = b[i];
  }
  const int top = n < k ? n : k;
  for (int j = threadIdx.x; j < top; j += kThreads) {
    const uint64_t w = a[j];
    const int r = j + count_above(b, k, w);
    if (r < k) out[r] = w;
  }
  __syncthreads();
  cur ^= 1;
}

// Merge the n_new appended words into the best k, kStepKeys at a time
// (the waiting words and a step's survivors may exceed kStepKeys). Every
// thread calls this, after every thread has read n_add.
__device__ void merge(Shared& sh, int& cur, int n_new, int k) {
  if (threadIdx.x == 0) sh.n_add = 0;  // the pieces' barriers order this
  for (int off = 0; off < n_new; off += kStepKeys)
    merge_piece(sh, cur, sh.add + off,
                n_new - off < kStepKeys ? n_new - off : kStepKeys, k);
}

// After a step's appends: merge them once more than `slack` wait.
__device__ __forceinline__ void settle(Shared& sh, int& cur, int k,
                                       int slack) {
  __syncthreads();
  const int n_new = sh.n_add;
  __syncthreads();  // every thread has read n_add before the merge resets it
  if (n_new > slack) merge(sh, cur, n_new, k);
}

// Whether chunk key i was in the seed's sample (a chunk of more than
// kSample keys).
__device__ __forceinline__ bool sampled(const Shared& sh, int i) {
#pragma unroll
  for (int r = 0; r < kWarps; ++r)
    if (static_cast<unsigned>(i - sh.run[r]) < static_cast<unsigned>(kRunLen))
      return true;
  return false;
}

// The best k of in[row, lo:lo+n) for each (chunk, row) = (blockIdx.x,
// blockIdx.y), written to cand[row, chunk, 0:k) best first (0: empty).
template <int KIND>
__global__ void __launch_bounds__(kThreads, 4)
topk_chunks_kernel(const void* __restrict__ in, uint64_t* __restrict__ cand,
                   long long len, long long chunk, int k) {
  using E = typename Elem<KIND>::T;
  constexpr int kPer = 16 / static_cast<int>(sizeof(E));  // keys a vector
  constexpr int kStep = kThreads * kVec;                  // vectors a step
  __shared__ Shared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long row = blockIdx.y;
  const long long lo = static_cast<long long>(blockIdx.x) * chunk;
  const int n = static_cast<int>(lo + chunk < len ? chunk : len - lo);
  const E* src = static_cast<const E*>(in) + row * len + lo;
  const uint32_t lo32 = static_cast<uint32_t>(lo);

  // the aligned body [head, head + nvec * kPer) takes 16-byte loads
  int head = static_cast<int>(
      ((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15) / sizeof(E));
  if (head > n) head = n;
  const int nvec = n > kSample ? (n - head) / kPer : 0;
  const int tail = head + nvec * kPer;
  const uint4* vsrc = reinterpret_cast<const uint4*>(src + head);
  const int nsteps = (nvec + kStep - 1) / kStep;

  uint4 cur_v[kVec], next_v[kVec];
  const uint4 zero = make_uint4(0, 0, 0, 0);
#pragma unroll
  for (int u = 0; u < kVec; ++u) {
    const int v = u * kThreads + tid;
    cur_v[u] = v < nvec ? __ldg(vsrc + v) : zero;
  }

  for (int j = tid; j < kMaxK; j += kThreads) sh.best[0][j] = 0;
  if (tid < kWarps)
    sh.run[tid] = static_cast<int>(static_cast<long long>(tid) *
                                   (n - kRunLen) / (kWarps - 1));
  if (tid == 0) sh.n_add = 0;
  __syncthreads();
  int cur = 0;

  // seed: the sample, or the whole chunk when it is small
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = n > kSample ? sh.run[warp] + lane * 4 + u
                              : u * kThreads + tid;
    bool p = false;
    uint64_t w = 0;
    if (i < n) {
      w = word<KIND>(src[i], lo32 + static_cast<uint32_t>(i));
      p = w != 0;
    }
    append(sh, p, w);
  }
  settle(sh, cur, k, 0);

  if (n > kSample) {
    {
      // the scalar head and tail (at most 3 keys each)
      const uint64_t thr = sh.best[cur][k - 1];
      const int i = tid < head ? tid : tail + (tid - head);
      bool p = false;
      uint64_t w = 0;
      if (tid < head + (n - tail)) {
        w = word<KIND>(src[i], lo32 + static_cast<uint32_t>(i));
        p = w > thr && !sampled(sh, i);
      }
      append(sh, p, w);
      settle(sh, cur, k, kSlack);
    }

    for (int s = 0; s < nsteps; ++s) {
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        const int v = (s + 1) * kStep + u * kThreads + tid;
        next_v[u] = v < nvec ? __ldg(vsrc + v) : zero;
      }
      const uint64_t thr = sh.best[cur][k - 1];
      bool any = false;
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        const int v = s * kStep + u * kThreads + tid;
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
          const int i = head + v * kPer + q;
          const uint64_t w = word<KIND>(key_of<KIND>(cur_v[u], q),
                                        lo32 + static_cast<uint32_t>(i));
          any |= v < nvec && w > thr;  // a hint: sampled keys are rare
        }
      }
      if (__any_sync(0xffffffffu, any)) {
#pragma unroll
        for (int u = 0; u < kVec; ++u) {
          const int v = s * kStep + u * kThreads + tid;
#pragma unroll
          for (int q = 0; q < kPer; ++q) {
            const int i = head + v * kPer + q;
            const uint64_t w = word<KIND>(key_of<KIND>(cur_v[u], q),
                                          lo32 + static_cast<uint32_t>(i));
            append(sh, v < nvec && w > thr && !sampled(sh, i), w);
          }
        }
      }
      settle(sh, cur, k, s + 1 < nsteps ? kSlack : 0);
#pragma unroll
      for (int u = 0; u < kVec; ++u) cur_v[u] = next_v[u];
    }
  }

  const long long out = (row * gridDim.x + blockIdx.x) * k;
  for (int j = tid; j < k; j += kThreads) cand[out + j] = sh.best[cur][j];
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
// cand1 holds rows * chunks * k uint64 words of scratch and cand2
// rows * ceil(chunks * k / 1024) * k; a CTA of pass 1 takes `chunk` keys
// of a row. out_keys: (rows, k) 32-bit words, out_idx: (rows, k) int32.
// Launches on `stream`, does not synchronise, returns cudaGetLastError().
int spartan_shard_topk(const void* keys, void* cand1, void* cand2,
                       void* out_keys, void* out_idx, long long rows,
                       long long m, int k, int is_float, long long chunk,
                       long long chunks, unsigned sentinel, void* stream) {
  if (rows <= 0 || m <= 0 || k < 1 || k > kMaxK || chunk <= 0 ||
      chunks <= 0 || chunks * k >= (1LL << 31) || rows > 65535 ||
      (chunks - 1) * chunk >= m || m >= (1LL << 31))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint64_t* c1 = static_cast<uint64_t*>(cand1);
  uint64_t* c2 = static_cast<uint64_t*>(cand2);
  cudaError_t err = is_float
      ? launch_chunks<kF32>(keys, c1, rows, m, chunk, chunks, k, s)
      : launch_chunks<kI32>(keys, c1, rows, m, chunk, chunks, k, s);
  if (err != cudaSuccess) return err;
  // pass 2: the chunks' candidate words, kSample a CTA, level by level
  // (8 lists of 128 become one) until one list of k is left a row; the
  // levels write to cand2 and cand1 in turn
  uint64_t* src = c1;
  uint64_t* dst = c2;
  for (long long lists = chunks; lists > 1;) {
    const long long len = lists * k;
    const long long subs = (len + kSample - 1) / kSample;
    err = launch_chunks<kWords>(src, dst, rows, len, kSample, subs, k, s);
    if (err != cudaSuccess) return err;
    lists = subs;
    uint64_t* done = dst;
    dst = src;
    src = done;
  }
  topk_finish_kernel<<<static_cast<unsigned>(rows), kMaxK, 0, s>>>(
      static_cast<const uint32_t*>(keys), src,
      static_cast<uint32_t*>(out_keys), static_cast<int*>(out_idx), m, k,
      sentinel);
  return cudaGetLastError();
}

}  // extern "C"
