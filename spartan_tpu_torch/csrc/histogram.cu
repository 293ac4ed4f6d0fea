// Integer histogram (bincount) for Hopper (sm_90a).
//
// bincount_block replaces spartan_tpu/kernels/histogram.py::bincount_block
// and the per-shard part of bincount_sharded (the Pallas TPU kernel
// behind BincountExpr: st.bincount, histogram, unique_counts and
// unique(return_counts=True)). For int32 ids (e,) and length <= 4096 it
// counts, for every bucket b in [0, length), the ids equal to b, with
// negative ids counted in bucket 0 and ids >= length dropped (jnp.bincount
// parity). The TPU kernel reduces a (512, length) f32 one-hot per id block
// into a VMEM-resident counts row, then psums the shards' rows; none of
// that carries over. All logical shards' ids are counted in one launch:
// the psum of per-shard counts is the count of all ids.
//
// Bound on an H100 SXM at the histogram phase's shape (2^26 ids, 64
// buckets): the function reads 4 e bytes and writes 4 length, 268 MB over
// 3.35 TB/s ~ 0.080 ms. So it is bound by bytes, and the design's aim is
// to stream the ids at the card's rate and to spend at most a few
// instructions, and at most one shared atomic, on each: at best as fast
// as a torch reduction that reads the same ids (chip_smoke.py prints
// both).
//
// Stream. The wrapper (kernels/histogram.py::_plan) splits the ids into a
// scalar head up to the first 16-byte boundary, a body of 16-byte
// vectors and a scalar tail of at most 3, and sizes the grid to the
// CTAs that fit the card at once. CTA b walks chunks b, b + grid, ... of
// kThreads * kVecs vectors; each thread issues its kVecs loads (32 ids)
// before it counts any of them. Head and tail go to CTA 0.
//
// Count. Each CTA holds `copies` int32 sub-histograms in shared memory
// (the wrapper picks one per warp where they fit its budget, fewer where
// they do not; the entry point sizes the shared memory from them), added
// to with shared atomics. Each thread adds each run of equal ids in its
// vector with one atomic, and a warp whose 128 ids are all one bucket
// adds them with one: sorted ranks (unique's launch) and one hot bucket
// then cost about one atomic per 128 ids, with no __match_any_sync, and
// uniform ids over 64 buckets spread their atomics over eight copies.
// Per-thread 8-bit counters (the CUDA samples' histogram64) ran no
// faster at 64 buckets on the card (PERF.md, Findings), so this route
// counts every length. A CTA counts fewer than 2^31 ids (the wrapper
// refuses more), so no int32 counter wraps.
// Each CTA then adds its nonzero buckets into the int32 output with
// global atomicAdd. Integer addition does not depend on order, so every
// run gives the same bits. Counting in int32 instead of the TPU's f32
// gives the same result wherever the TPU's count is exact (below 2^24
// per bucket per shard).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 8;                   // 16-byte vectors a thread a chunk
constexpr int kChunk = kThreads * kVecs;   // vectors per chunk
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPast = 0x7fffffff;          // a vector slot past the body

struct Args {
  const int* ids;  // e ids: head, then 4 * nvec in vectors, then tail
  int head;
  int nvec;
  int tail;
  int length;
  int copies;      // sub-histograms a CTA
  int* out;
};

// negatives count in bucket 0; a bucket >= length is dropped
__device__ __forceinline__ unsigned bucket(int id) {
  return id < 0 ? 0u : static_cast<unsigned>(id);
}

__device__ __forceinline__ void add_run(int* h, unsigned b, unsigned n,
                                        unsigned length) {
  if (b < length) atomicAdd(&h[b], static_cast<int>(n));
}

// one vector's 4 ids: one atomic for the warp when its 128 ids are one
// bucket, else one per run of equal ids in the vector
__device__ __forceinline__ void count_vec(int* h, int4 v, unsigned length) {
  const unsigned x = bucket(v.x), y = bucket(v.y), z = bucket(v.z),
                 w = bucket(v.w);
  const unsigned x0 = __shfl_sync(kFull, x, 0);
  if (__all_sync(kFull, x == x0 && y == x && z == x && w == x)) {
    if ((threadIdx.x & 31) == 0) add_run(h, x, 4 * 32, length);
    return;
  }
  unsigned cur = x, n = 1;
  if (y == cur) { ++n; } else { add_run(h, cur, n, length); cur = y; n = 1; }
  if (z == cur) { ++n; } else { add_run(h, cur, n, length); cur = z; n = 1; }
  if (w == cur) { ++n; } else { add_run(h, cur, n, length); cur = w; n = 1; }
  add_run(h, cur, n, length);
}

__global__ void __launch_bounds__(kThreads)
bincount_kernel(Args a) {
  extern __shared__ int hist[];                      // (copies, length)
  const int n = a.copies * a.length;
  for (int i = threadIdx.x; i < n; i += kThreads) hist[i] = 0;
  __syncthreads();
  int* h = hist + ((threadIdx.x >> 5) % a.copies) * a.length;
  const unsigned length = a.length;
  const int4* body = reinterpret_cast<const int4*>(a.ids + a.head);
  const int chunks = (a.nvec + kChunk - 1) / kChunk;
  // the trip count is the CTA's, so a warp's lanes vote together
  for (int c = blockIdx.x; c < chunks; c += gridDim.x) {
    int4 r[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int i = c * kChunk + u * kThreads + threadIdx.x;
      r[u] = i < a.nvec ? __ldg(body + i)
                        : make_int4(kPast, kPast, kPast, kPast);
    }
#pragma unroll
    for (int u = 0; u < kVecs; ++u) count_vec(h, r[u], length);
  }
  // the head's and the tail's ids (at most 3 each), in CTA 0
  if (blockIdx.x == 0) {
    const unsigned t = threadIdx.x;
    if (t < static_cast<unsigned>(a.head)) add_run(hist, bucket(a.ids[t]), 1,
                                                   length);
    if (t < static_cast<unsigned>(a.tail))
      add_run(hist, bucket(a.ids[a.head + 4LL * a.nvec + t]), 1, length);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < a.length; b += kThreads) {
    int s = 0;
    for (int c = 0; c < a.copies; ++c) s += hist[c * a.length + b];
    if (s != 0) atomicAdd(&a.out[b], s);
  }
}

// the dynamic shared memory of `copies` int32 rows of `length`, allowed
// for the kernel; refuses a layout it cannot hold
cudaError_t allow_smem(int length, int copies, int* smem) {
  if (length <= 0 || copies < 1 || copies > kWarps ||
      static_cast<long long>(length) * copies > (1 << 20))
    return cudaErrorInvalidValue;
  *smem = 4 * length * copies;
  return cudaFuncSetAttribute(
      bincount_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
}

}  // namespace

extern "C" {

// CTAs of `copies` sub-histograms of `length` buckets that one SM holds
// at once, into *out (0 when none fits).
int spartan_bincount_ctas_per_sm(int length, int copies, int* out) {
  int smem = 0;
  const cudaError_t err = allow_smem(length, copies, &smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, bincount_kernel, kThreads, smem);
}

// Add the counts of int32 ids into out (length,) int32, which the caller
// zeroes. The ids are `head` scalars, then `nvec` 16-byte vectors (the
// first at a 16-byte boundary), then `tail` scalars. `ctas` CTAs of
// kThreads threads count into `copies` sub-histograms each (1 to
// kWarps); the shared memory they need is sized here, and a layout a
// block cannot hold, or a misaligned body, is refused. Launches on
// `stream`, does not synchronise, returns cudaGetLastError().
int spartan_bincount(const void* ids, int head, long long nvec, int tail,
                     int length, void* out, int copies, int ctas,
                     void* stream) {
  if (head < 0 || head > 3 || tail < 0 || tail > 3 || nvec < 0 ||
      nvec >= (1LL << 29) || ctas <= 0)
    return cudaErrorInvalidValue;
  int smem = 0;
  cudaError_t err = allow_smem(length, copies, &smem);
  if (err != cudaSuccess) return err;
  const int* p = static_cast<const int*>(ids);
  if (nvec > 0 && (reinterpret_cast<uintptr_t>(p + head) & 15) != 0)
    return cudaErrorMisalignedAddress;
  if (head + nvec + tail == 0) return cudaSuccess;
  const Args a{p, head, static_cast<int>(nvec), tail, length, copies,
               static_cast<int*>(out)};
  bincount_kernel<<<ctas, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      a);
  return cudaGetLastError();
}

}  // extern "C"
