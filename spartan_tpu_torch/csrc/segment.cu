// Segment sums for Hopper (sm_90a): the two kernels of the sparse slice.
//
// 1. windowed_segsum replaces spartan_tpu/kernels/segment.py::windowed_segsum
//    (the Pallas TPU kernel behind ops/segment.py SegmentPlan.segment_sum,
//    which carries every PageRank iteration). SegmentPlan lays a sorted
//    id stream out on the host: the entries of each 1024-slot output
//    window w fill a region of whole 1024-entry subblocks, real entries
//    first (sorted by their local id 0..1023), sentinel ids (1024) in the
//    tail. out[w * 1024 + t] is the sum of the values whose local id is t.
//    The TPU kernel keeps the whole output in VMEM and contracts two
//    one-hots per subblock on the MXU; none of that carries over.
//
//    Design: one CTA of 1024 threads per output window, thread t owns
//    slot t. The CTA first marks, in shared memory, where each slot's run
//    starts: entry i of the region writes lb[s] = i for every slot s in
//    (id[i-1], id[i]], so lb[s] is the first entry whose id is >= s (each
//    slot has exactly one writer: no atomics, no race). Then thread t sums
//    the values of [lb[t], lb[t+1]) in order and writes its slot once.
//    Windows are found from the plan's per-window subblock offsets
//    (`starts`), not from the per-subblock window index, so the trailing
//    all-sentinel padding subblocks belong to no window and are never read.
//    CTAs past the last window, and windows without entries, write zeros.
//    The result is the same on every run.
//
//    Bound on an H100 SXM at the PageRank plan (n = 1M pages, P ~ 16.5M
//    plan entries): the function reads P f32 values and P int32 ids and
//    writes rows_pad * 128 f32: ~140 MB over 3.35 TB/s ~ 0.04 ms; its
//    P additions are nothing beside that. So it is bound by bytes. This
//    first version is latency-bound instead: each thread walks its own
//    run, and neighbouring threads read ~16 floats apart.
//
// 2. segment_sum_block replaces spartan_tpu/kernels/segment.py::
//    segment_sum_block (the blocked one-hot Pallas kernel behind
//    ops/segment.py segment_sum(impl="pallas")). For f32 vals (e, d) and
//    ids (e,) it computes out[s, :] = sum of the rows whose id is s, for
//    s in [0, k); rows whose id lies outside [0, k) are dropped. The TPU
//    carries the (k, d) output in VMEM across a sequential grid and
//    multiplies by a one-hot on the MXU; here blocks run in parallel.
//
//    Design (the k-means kernel's, csrc/kmeans.cu): the grid is (row
//    chunks) x (column tiles). A CTA holds a (k, d_tile) partial in
//    shared memory; thread c owns column c of the tile and adds the
//    chunk's rows to it in row order (the warp reads one 128-byte run of
//    a row per load, and every lane of a warp shares the row's id, so the
//    shared-memory adds hit 32 consecutive words). A second kernel sums
//    the per-chunk partials in chunk order. No atomics: the same bits on
//    every run. The work is e * d additions in IEEE f32 (no TF32, no
//    tensor cores); the one-hot product's 2 e k d is the TPU's
//    formulation, not the work.
//
//    Bound on an H100 SXM at 1M x 128, k = 64: reading 4 e d + 4 e bytes
//    and writing 4 k d, ~516 MB over 3.35 TB/s ~ 0.154 ms; e d = 128M
//    additions over 67 TFLOP/s FP32 ~ 0.002 ms. So it is bound by bytes.
//    Limit (kernels/segment.py cuda_limits): a (k, 1) column of partial
//    sums, 4 k bytes, must fit the 227 KB of shared memory of one block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWindow = 1024;       // slots per output window (SegmentPlan.W)
constexpr int kSubblock = 1024;     // entries per subblock (SegmentPlan.EB)
constexpr int kSentinel = kWindow;  // local id of a padding entry
constexpr int kUnroll = 16;         // rows in flight per thread

__global__ void __launch_bounds__(kWindow)
windowed_segsum_kernel(const float* __restrict__ vals,
                       const int* __restrict__ ids,
                       const int* __restrict__ starts,
                       float* __restrict__ out, int n_windows) {
  __shared__ int lb[kWindow + 1];
  const int w = blockIdx.x;
  const int t = threadIdx.x;
  float acc = 0.f;
  if (w < n_windows) {  // uniform over the CTA
    const long long base = static_cast<long long>(starts[w]) * kSubblock;
    const int len = (starts[w + 1] - starts[w]) * kSubblock;
    for (int s = t; s <= kWindow; s += kWindow) lb[s] = len;
    __syncthreads();
    for (int i = t; i < len; i += kWindow) {
      // clamped to [-1, kSentinel]: a malformed id cannot write outside lb
      const int id = min(max(ids[base + i], -1), kSentinel);
      const int prev = i ? min(max(ids[base + i - 1], -1), kSentinel) : -1;
      for (int s = prev + 1; s <= id; ++s) lb[s] = i;
    }
    __syncthreads();
    const int hi = lb[t + 1];
    for (int i = lb[t]; i < hi; ++i) acc += vals[base + i];
  }
  out[static_cast<long long>(w) * kWindow + t] = acc;
}

template <typename Id>
__device__ __forceinline__ void add_row(float* __restrict__ col_acc, Id id,
                                        float v, int k, int d_tile) {
  if (id >= 0 && id < k) col_acc[static_cast<int>(id) * d_tile] += v;
}

template <typename Id>
__global__ void segment_block_kernel(const float* __restrict__ vals,
                                     const Id* __restrict__ ids,
                                     float* __restrict__ part, long long e,
                                     int d, int k, int d_tile,
                                     long long chunk_rows) {
  extern __shared__ float s_acc[];  // (k, d_tile) partial sums
  const int c = threadIdx.x;
  const int kt = k * d_tile;
  for (int i = c; i < kt; i += blockDim.x) s_acc[i] = 0.f;
  __syncthreads();

  const int col = blockIdx.y * d_tile + c;
  const long long r0 = static_cast<long long>(blockIdx.x) * chunk_rows;
  const long long r1 = r0 + chunk_rows < e ? r0 + chunk_rows : e;
  if (c < d_tile && col < d) {
    float* my = s_acc + c;
    const float* vcol = vals + col;
    long long r = r0;
    for (; r + kUnroll <= r1; r += kUnroll) {
      Id id[kUnroll];
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        id[u] = ids[r + u];
        v[u] = vcol[(r + u) * d];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add_row(my, id[u], v[u], k, d_tile);
    }
    for (; r < r1; ++r) add_row(my, ids[r], vcol[r * d], k, d_tile);
  }
  __syncthreads();

  float* p = part + static_cast<long long>(blockIdx.x) * k * d;
  for (int i = c; i < kt; i += blockDim.x) {
    const int seg = i / d_tile;
    const int cw = blockIdx.y * d_tile + i % d_tile;
    if (cw < d) p[static_cast<long long>(seg) * d + cw] = s_acc[i];
  }
}

__global__ void reduce_chunks_kernel(const float* __restrict__ part,
                                     float* __restrict__ out, int n_chunks,
                                     long long kd) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= kd) return;
  float acc = 0.f;
  for (int b = 0; b < n_chunks; ++b) acc += part[b * kd + i];
  out[i] = acc;
}

template <typename Id>
cudaError_t launch_block(const float* vals, const Id* ids, float* part,
                         float* out, long long e, int d, int k, int d_tile,
                         int threads, int n_chunks, long long chunk_rows,
                         cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(k) * d_tile;
  cudaError_t err = cudaFuncSetAttribute(
      segment_block_kernel<Id>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n_chunks, (d + d_tile - 1) / d_tile);
  segment_block_kernel<Id><<<grid, threads, smem, stream>>>(
      vals, ids, part, e, d, k, d_tile, chunk_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long kd = static_cast<long long>(k) * d;
  const int rthreads = 256;
  const long long rblocks = (kd + rthreads - 1) / rthreads;
  reduce_chunks_kernel<<<static_cast<unsigned>(rblocks), rthreads, 0,
                         stream>>>(part, out, n_chunks, kd);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// SegmentPlan's sorted-segment sum. vals: plan-ordered f32 stream; ids:
// the plan's local ids (int32, same length); starts: (n_windows + 1,)
// int32 subblock offsets of each window's region; out: n_out_windows *
// 1024 f32 (rows_pad * 128). Launches on `stream`, does not synchronise,
// returns cudaGetLastError().
int spartan_windowed_segsum(const void* vals, const void* ids,
                            const void* starts, void* out, int n_windows,
                            int n_out_windows, void* stream) {
  if (n_windows < 0 || n_out_windows <= 0 || n_windows > n_out_windows)
    return cudaErrorInvalidValue;
  windowed_segsum_kernel<<<n_out_windows, kWindow, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(vals), static_cast<const int*>(ids),
      static_cast<const int*>(starts), static_cast<float*>(out), n_windows);
  return cudaGetLastError();
}

// Blocked segment sum of f32 vals (e, d) by ids (e,) (int32 when id_bytes
// is 4, int64 when 8) into out (k, d); part holds n_chunks * k * d f32 of
// scratch. A CTA takes chunk_rows rows and d_tile columns with `threads`
// threads (threads >= d_tile, a multiple of 32). Launches on `stream`,
// does not synchronise, returns cudaGetLastError().
int spartan_segment_sum_block(const void* vals, const void* ids,
                              int id_bytes, void* part, void* out,
                              long long e, int d, int k, int d_tile,
                              int threads, int n_chunks,
                              long long chunk_rows, void* stream) {
  if (e < 0 || d <= 0 || k <= 0 || d_tile <= 0 || threads < d_tile ||
      threads % 32 != 0 || n_chunks <= 0 || chunk_rows <= 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vals);
  float* p = static_cast<float*>(part);
  float* o = static_cast<float*>(out);
  if (id_bytes == 4)
    return launch_block(v, static_cast<const int32_t*>(ids), p, o, e, d, k,
                        d_tile, threads, n_chunks, chunk_rows, s);
  if (id_bytes == 8)
    return launch_block(v, static_cast<const int64_t*>(ids), p, o, e, d, k,
                        d_tile, threads, n_chunks, chunk_rows, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
