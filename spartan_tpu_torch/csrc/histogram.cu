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
// Design: every CTA keeps an int32 histogram of `length` buckets in
// shared memory (16 KB at 4096) and walks the ids grid-stride. The lanes
// of a warp that hold the same id are grouped with __match_any_sync and
// their leader adds the group's size with one shared-memory atomicAdd, so
// sorted ids (unique's ranks) cost one atomic per warp and scattered ids
// one per lane. Each CTA then adds its nonzero buckets into the int32
// output with global atomicAdd. Integer addition does not depend on
// order, so every run gives the same bits. Counting in int32 instead of
// the TPU's f32 gives the same result wherever the TPU's count is exact
// (below 2^24 per bucket per shard).
//
// Bound on an H100 SXM at the histogram phase's shape (2^26 ids, 64
// buckets): the function reads 4 e bytes and writes 4 length, 268 MB over
// 3.35 TB/s ~ 0.080 ms. So it is bound by bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
bincount_kernel(const int* __restrict__ ids, long long e, int length,
                int* __restrict__ out) {
  extern __shared__ int hist[];
  for (int b = threadIdx.x; b < length; b += kThreads) hist[b] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  // the loop bound is uniform over the CTA, so every lane of a warp
  // reaches __match_any_sync together
  for (long long base = static_cast<long long>(blockIdx.x) * kThreads;
       base < e; base += step) {
    const long long i = base + threadIdx.x;
    int id = length;  // past the end: dropped
    if (i < e) {
      id = ids[i];
      id = id < 0 ? 0 : id;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, id);
    if (lane == __ffs(peers) - 1 && id < length)
      atomicAdd(&hist[id], __popc(peers));
  }
  __syncthreads();
  for (int b = threadIdx.x; b < length; b += kThreads)
    if (hist[b] != 0) atomicAdd(&out[b], hist[b]);
}

}  // namespace

extern "C" {

// Add the counts of int32 ids (e,) into out (length,) int32, which the
// caller zeroes. `ctas` CTAs of 512 threads each hold a 4 * length byte
// histogram. Launches on `stream`, does not synchronise, returns
// cudaGetLastError().
int spartan_bincount(const void* ids, long long e, int length, void* out,
                     int ctas, void* stream) {
  if (e < 0 || length <= 0 || ctas <= 0) return cudaErrorInvalidValue;
  if (e == 0) return cudaSuccess;
  const size_t smem = sizeof(int) * static_cast<size_t>(length);
  cudaError_t err = cudaFuncSetAttribute(
      bincount_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  bincount_kernel<<<ctas, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), e, length, static_cast<int*>(out));
  return cudaGetLastError();
}

}  // extern "C"
