// Fused k-means pass for Hopper (sm_90a): assignment + accumulation.
//
// Replaces spartan_tpu/kernels/kmeans.py::_block_kernel (the Pallas TPU
// kernel wrapped by assign_accumulate / step / run). For f32 points
// (m, d) and centers (k, d) it computes, for every row below
// `valid_rows`:
//   score[c] = |c|^2 - 2 p.c        (|p|^2 is dropped, as on the TPU)
//   a        = argmin_c score[c]    (first index wins ties)
// and returns the (k, d) f32 sums of the rows assigned to each center
// and the (k,) f32 counts.
//
// Bound on an H100 SXM at 1M x 128, k = 64, f32 (data-sheet peaks):
//   Gram 2*m*k*d = 16.4 GFLOP over 67 TFLOP/s FP32 (no tensor cores)
//     -> 0.25 ms: the bound;
//   reading the 512 MB of points once over 3.35 TB/s -> 0.15 ms.
// So the pass is bound by FP32 operations, not bytes: the design's aim
// is to keep the FMA pipes busy. The card these numbers were checked on
// names itself "NVIDIA H100 80GB HBM3" (the SXM part, power limit
// 700 W). On an H100 PCIe (51 TFLOP/s, 2.0 TB/s) the same counts give
// 0.32 ms and 0.26 ms; chip_smoke.py recomputes the bound for the card
// it runs on.
//
// Design: the Gram tile as a register-tiled product on the CUDA cores,
// in IEEE f32 FMAs (no TF32, no tensor cores), with no shuffles inside
// the d loop.
//   * One persistent CTA per SM walks tiles of kTile = 128 rows (grid
//     stride). It stages the centers once in shared memory, each row's
//     16-byte groups XOR-swizzled by the row (group q of row c sits at
//     q ^ (c & 7)) so that neighbouring centers' reads fall in distinct
//     banks without padding, and their squared norms.
//   * Point tiles arrive through cp.async in a 2-stage ring, so the
//     next tile's copy runs under this tile's arithmetic. A tile row is
//     padded by one 16-byte group: the two rows a warp reads at once
//     fall in neighbouring banks, and a column's offset is a constant
//     of the unrolled loop. Where two tiles do not fit beside the
//     centers and the partial sums (d > 128, or large k), the CTA reads
//     the rows from global memory (L1/L2) instead; the arithmetic is
//     the same.
//   * Phase 1: each thread holds an 8-row x 4-center block of the Gram
//     tile in 32 accumulators; per 4 columns of d it reads 8 + 4
//     16-byte groups from shared memory for 128 FMAs, the next step's
//     groups loaded while this step's are multiplied (d is a template
//     parameter, so the loop unrolls with fixed offsets). Centers go in
//     blocks of 64 (16 threads x 4), each thread's 4 centers 16 apart;
//     centers past k read the last center and score +inf, so every k
//     runs the same code. Each thread then forms |c|^2 - 2 acc, keeps
//     the least per row, and a 4-step shuffle over the 16 threads that
//     share a row gives the argmin, comparing (score, index) pairs so
//     that the first index wins ties; once per row per tile, not once
//     per center.
//   * Phase 2: the CTA's (k, d) partial sums live in shared memory; a
//     thread owns one 16-byte column group of the centers a % G == h
//     (G groups of d / 4 threads, G = 8 at d = 128), and adds the
//     tile's rows from the staged tile in row order; a warp finds its
//     rows by ballot and visits only those. No atomics, so a CTA's
//     partial is the same on every run.
//   * A second kernel sums the per-CTA partials in CTA order: the
//     result is identical from run to run on the same card and grid.
// Limits (kernels/kmeans.py cuda_limits): d % 128 == 0, d <= 1024, and
// 4 * (2*k*d + roundup(k, 64) + k + kTile) bytes of shared memory per
// CTA, plus 2 * kTile * (d + 4) * 4 for the staged ring.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 128;   // rows per tile
constexpr int kRows = 8;     // rows per thread: tr + 16 i
constexpr int kCols = 4;     // centers per thread: cb + tc + 16 j
constexpr int kCBlock = 64;  // centers per block: 16 threads x kCols
constexpr int kStages = 2;   // point tiles in the cp.async ring

// A staged tile row holds d + 4 floats: the pad puts neighbouring rows'
// same columns in neighbouring banks, and keeps each column's offset a
// constant of the unrolled loop.
size_t smem_bytes(int d, int k, int stages) {
  const size_t kp = (k + kCBlock - 1) / kCBlock * kCBlock;
  return sizeof(float) * (2 * static_cast<size_t>(k) * d +
                          static_cast<size_t>(stages) * kTile * (d + 4) + kp +
                          k + kTile);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  // bytes == 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                   "r"(smem_addr(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Rows [t * kTile, +kTile) of the points into a tile of rows D4 + 1
// groups apart; rows at or past lim are zeros. Thread (r0, q) copies
// group q of rows r0, r0 + kThreads / D4, ...
template <int D4>
__device__ __forceinline__ void load_tile(float4* dst, const float4* src4,
                                          long long t, long long lim) {
  constexpr int kRowsPer = kThreads / D4;
  const int r0 = threadIdx.x / D4, q = threadIdx.x % D4;
  if (r0 >= kRowsPer) return;
  for (int r = r0; r < kTile; r += kRowsPer) {
    const long long row = t * kTile + r;
    const bool ok = row < lim;
    cp_async16(dst + r * (D4 + 1) + q, src4 + (ok ? row : 0) * D4 + q,
               ok ? 16 : 0);
  }
}

__device__ __forceinline__ void fma4(float& acc, const float4& a,
                                     const float4& b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  acc = fmaf(a.w, b.w, acc);
}

// d = 4 * D4 = 128 * NQ. STAGED: point tiles through the cp.async ring
// (only d = 128 fits it); else rows straight from global memory.
template <int NQ, bool STAGED>
__global__ void __launch_bounds__(kThreads, 1)
assign_accumulate_kernel(const float* __restrict__ points,
                         const float* __restrict__ centers,
                         float* __restrict__ part_sums,
                         float* __restrict__ part_cnt,
                         long long m, int k, long long valid) {
  constexpr int D4 = 32 * NQ;
  constexpr int P4 = D4 + 1;  // groups per staged tile row
  // thread groups of phase 2: a power of two, each D4 threads
  constexpr int kGroups = kThreads / D4 >= 8   ? 8
                          : kThreads / D4 >= 4 ? 4
                          : kThreads / D4 >= 2 ? 2
                                               : 1;
  extern __shared__ float4 smem4[];
  const int kp = (k + kCBlock - 1) / kCBlock * kCBlock;
  float4* s_c = smem4;                                  // (k, D4) swizzled
  float4* s_p = s_c + k * D4;                           // ring of tiles
  float4* s_sum = s_p + (STAGED ? kStages * kTile * P4 : 0);  // (k, D4)
  float* s_cn = reinterpret_cast<float*>(s_sum + k * D4);
  float* s_cnt = s_cn + kp;                             // (k,) counts
  int* s_asg = reinterpret_cast<int*>(s_cnt + k);       // (kTile,)

  const int tid = threadIdx.x, lane = tid & 31;
  const int tr = (tid >> 5) * 2 + ((tid >> 4) & 1);  // rows tr + 16 i
  const int tc = tid & 15;                           // centers tc + 16 j
  // centers cb + tc + 16 j share the swizzle tc & 7 (cb is a multiple
  // of 64)
  const int sc = tc & 7;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);

  const float4* c4 = reinterpret_cast<const float4*>(centers);
  for (int i = tid; i < k * D4; i += kThreads) {
    const int c = i / D4, q = i % D4;
    s_c[c * D4 + (q ^ (c & 7))] = c4[i];
    s_sum[i] = zero4;
  }
  for (int c = tid; c < k; c += kThreads) s_cnt[c] = 0.f;
  __syncthreads();
  for (int c = tid; c < kp; c += kThreads) {
    float acc = INFINITY;  // centers past k never win
    if (c < k) {
      acc = 0.f;
      for (int q = 0; q < D4; ++q) {
        const float4 v = s_c[c * D4 + (q ^ (c & 7))];
        fma4(acc, v, v);
      }
    }
    s_cn[c] = acc;
  }

  const long long lim = valid < m ? valid : m;
  const long long ntiles = (lim + kTile - 1) / kTile;
  const float4* p4 = reinterpret_cast<const float4*>(points);
  int stage = 0;
  if (STAGED) {
    if (blockIdx.x < ntiles) load_tile<D4>(s_p, p4, blockIdx.x, lim);
    cp_async_commit();
  }
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long row0 = t * kTile;
    const float4* tile = s_p + stage * kTile * P4;
    if (STAGED) {
      if (t + gridDim.x < ntiles)
        load_tile<D4>(s_p + (stage ^ 1) * kTile * P4, p4, t + gridDim.x,
                      lim);
      cp_async_commit();
      cp_async_wait_one();
    }
    __syncthreads();

    // phase 1: the Gram tile by 8 x 4 register blocks, each step's
    // operands loaded while the step before is multiplied; then the
    // argmin
    float best[kRows];
    int best_c[kRows];
    const float4* prow[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      best[i] = INFINITY;
      best_c[i] = 0x7fffffff;
      const long long row = row0 + tr + 16 * i;
      prow[i] = STAGED ? tile + (tr + 16 * i) * P4
                       : p4 + (row < lim ? row : lim - 1) * D4;
    }
    for (int cb = 0; cb < k; cb += kCBlock) {
      const float4* crow[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        crow[j] = s_c + min(cb + tc + 16 * j, k - 1) * D4;
      float acc[kRows][kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
      float4 cv[kCols], pv[kRows];
#pragma unroll
      for (int j = 0; j < kCols; ++j) cv[j] = crow[j][sc];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pv[i] = STAGED ? prow[i][0] : __ldg(prow[i]);
#pragma unroll 4
      for (int q = 0; q < D4; ++q) {
        const int qn = q + 1 < D4 ? q + 1 : q;
        float4 cn[kCols], pn[kRows];
        const int cq = qn ^ sc;
#pragma unroll
        for (int j = 0; j < kCols; ++j) cn[j] = crow[j][cq];
#pragma unroll
        for (int i = 0; i < kRows; ++i)
          pn[i] = STAGED ? prow[i][qn] : __ldg(prow[i] + qn);
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) fma4(acc[i][j], pv[i], cv[j]);
#pragma unroll
        for (int j = 0; j < kCols; ++j) cv[j] = cn[j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) pv[i] = pn[i];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int c = cb + tc + 16 * j;
        const float cn = s_cn[c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float s = cn - 2.0f * acc[i][j];
          if (s < best[i]) {  // strict: the first index wins ties
            best[i] = s;
            best_c[i] = c;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        const float s = __shfl_xor_sync(0xffffffffu, best[i], off);
        const int c = __shfl_xor_sync(0xffffffffu, best_c[i], off);
        if (s < best[i] || (s == best[i] && c < best_c[i])) {
          best[i] = s;
          best_c[i] = c;
        }
      }
      if (tc == 0) {
        const int r = tr + 16 * i;
        // no score below +inf (NaN data): center 0, as a running
        // strict minimum from +inf gives
        s_asg[r] = row0 + r < lim ? (best_c[i] == 0x7fffffff ? 0 : best_c[i])
                                  : -1;
      }
    }
    __syncthreads();

    // phase 2: thread (h, q) owns column group q of the centers with
    // a % kGroups == h and adds the tile's rows in row order; a warp
    // finds its rows by ballot and visits only those
    const int h = tid / D4, q = tid % D4;
    if (h < kGroups) {
      for (int base = 0; base < kTile; base += 32) {
        const int a = s_asg[base + lane];
        unsigned mask =
            __ballot_sync(0xffffffffu, a >= 0 && (a & (kGroups - 1)) == h);
        while (mask) {
          const int src = __ffs(mask) - 1;
          mask &= mask - 1;
          const int r = base + src;
          const int ar = __shfl_sync(0xffffffffu, a, src);
          const float4 v = STAGED ? tile[r * P4 + q]
                                  : __ldg(p4 + (row0 + r) * D4 + q);
          float4& sum = s_sum[ar * D4 + q];
          sum.x += v.x;
          sum.y += v.y;
          sum.z += v.z;
          sum.w += v.w;
          if (q == 0) s_cnt[ar] += 1.0f;
        }
      }
    }
    __syncthreads();
    stage ^= 1;
  }

  const int kd4 = k * D4;
  float4* ps = reinterpret_cast<float4*>(part_sums) +
               static_cast<size_t>(blockIdx.x) * kd4;
  for (int i = tid; i < kd4; i += kThreads) ps[i] = s_sum[i];
  float* pc = part_cnt + static_cast<size_t>(blockIdx.x) * k;
  for (int i = tid; i < k; i += kThreads) pc[i] = s_cnt[i];
}

__global__ void reduce_partials_kernel(const float* __restrict__ part_sums,
                                       const float* __restrict__ part_cnt,
                                       float* __restrict__ sums,
                                       float* __restrict__ cnt,
                                       int nparts, int kd, int k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < kd) {
    float acc = 0.f;
#pragma unroll 8
    for (int b = 0; b < nparts; ++b)
      acc += part_sums[static_cast<size_t>(b) * kd + i];
    sums[i] = acc;
  } else if (i < kd + k) {
    const int c = i - kd;
    float acc = 0.f;
    for (int b = 0; b < nparts; ++b)
      acc += part_cnt[static_cast<size_t>(b) * k + c];
    cnt[c] = acc;
  }
}

template <int NQ, bool STAGED>
cudaError_t prepare(int k) {
  return cudaFuncSetAttribute(
      assign_accumulate_kernel<NQ, STAGED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(128 * NQ, k, STAGED ? kStages : 0)));
}

template <int NQ, bool STAGED>
cudaError_t blocks_per_sm(int k, int* out) {
  cudaError_t err = prepare<NQ, STAGED>(k);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out, assign_accumulate_kernel<NQ, STAGED>, kThreads,
      smem_bytes(128 * NQ, k, STAGED ? kStages : 0));
}

struct Args {
  const float* points;
  const float* centers;
  float* part_sums;
  float* part_cnt;
  float* sums;
  float* cnt;
  long long m;
  int k;
  long long valid;
  int grid;
  cudaStream_t stream;
};

template <int NQ, bool STAGED>
cudaError_t launch(const Args& a) {
  cudaError_t err = prepare<NQ, STAGED>(a.k);
  if (err != cudaSuccess) return err;
  assign_accumulate_kernel<NQ, STAGED>
      <<<a.grid, kThreads, smem_bytes(128 * NQ, a.k, STAGED ? kStages : 0),
         a.stream>>>(a.points, a.centers, a.part_sums, a.part_cnt, a.m, a.k,
                     a.valid);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int kd = a.k * 128 * NQ;
  const int blocks = (kd + a.k + kThreads - 1) / kThreads;
  reduce_partials_kernel<<<blocks, kThreads, 0, a.stream>>>(
      a.part_sums, a.part_cnt, a.sums, a.cnt, a.grid, kd, a.k);
  return cudaGetLastError();
}

bool bad_shape(int d, int k) {
  return d <= 0 || d % 128 != 0 || d > 1024 || k <= 0;
}

// Whether (d, k) takes the cp.async ring of point tiles: only at d = 128
// (two tiles of wider rows do not fit), and where the ring fits beside
// the centers and partial sums in the current device's shared memory.
cudaError_t staged(int d, int k, bool* out) {
  int dev = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  *out = d == 128 && smem_bytes(d, k, kStages) <= static_cast<size_t>(limit);
  return err;
}

#define SPARTAN_NQ_SWITCH(NQ_VALUE, CALL) \
  switch (NQ_VALUE) {                     \
    case 1: return CALL(1);               \
    case 2: return CALL(2);               \
    case 3: return CALL(3);               \
    case 4: return CALL(4);               \
    case 5: return CALL(5);               \
    case 6: return CALL(6);               \
    case 7: return CALL(7);               \
    case 8: return CALL(8);               \
    default: return cudaErrorInvalidValue; \
  }

}  // namespace

extern "C" {

// Resident CTAs per SM for (d, k) on the current device; sets the
// kernel's dynamic shared-memory limit first. Returns a cudaError_t.
int spartan_kmeans_blocks_per_sm(int d, int k, int* out) {
  if (bad_shape(d, k)) return cudaErrorInvalidValue;
  bool ring = false;
  const cudaError_t err = staged(d, k, &ring);
  if (err != cudaSuccess) return err;
  if (ring) return blocks_per_sm<1, true>(k, out);
#define SPARTAN_BPS(NQ) blocks_per_sm<NQ, false>(k, out)
  SPARTAN_NQ_SWITCH(d / 128, SPARTAN_BPS)
#undef SPARTAN_BPS
}

// One fused pass: per-CTA partials, then their reduction into sums
// (k, d) and cnt (k,). All pointers are device pointers; scratch holds
// grid*(k*d) and grid*k floats. Launches on `stream`, does not
// synchronise, returns cudaGetLastError().
int spartan_kmeans_assign_accumulate(const void* points, const void* centers,
                                     void* part_sums, void* part_cnt,
                                     void* sums, void* cnt, long long m,
                                     int d, int k, long long valid, int grid,
                                     void* stream) {
  if (bad_shape(d, k) || grid <= 0) return cudaErrorInvalidValue;
  bool ring = false;
  const cudaError_t err = staged(d, k, &ring);
  if (err != cudaSuccess) return err;
  const Args a{static_cast<const float*>(points),
               static_cast<const float*>(centers),
               static_cast<float*>(part_sums),
               static_cast<float*>(part_cnt),
               static_cast<float*>(sums),
               static_cast<float*>(cnt),
               m, k, valid, grid, static_cast<cudaStream_t>(stream)};
  if (ring) return launch<1, true>(a);
#define SPARTAN_LAUNCH(NQ) launch<NQ, false>(a)
  SPARTAN_NQ_SWITCH(d / 128, SPARTAN_LAUNCH)
#undef SPARTAN_LAUNCH
}

}  // extern "C"
