// Fixed-order float32 vector products for Hopper (sm_90a).
//
// fixed_order_dot replaces no Pallas kernel: the JAX package leaves a
// vector product to XLA (spartan_tpu/expr/dot.py, DotExpr._lower). The
// port adds it so that a product restricted to a window of its output
// (the incremental engine, expr/incremental.py) gives every element of
// the window the bits the whole product gives it. cuBLAS picks its GEMV
// kernel and its split of the contraction from the output's width, so a
// narrower product may sum in another order; this kernel's order is its
// contract, and nothing but K and KS shapes it:
//
//   slice s covers k in [s*KS, min(K, (s+1)*KS))
//   part[s, m] = fold from 0.0 over that slice's k, ascending,
//                of x[k] * A[k, m]
//   out[m]     = fold from 0.0 over s, ascending, of part[s, m]
//
// Every product and every sum is rounded on its own (__fmul_rn,
// __fadd_rn: no contraction into an FMA), so the kernel gives the bits
// of its plain torch version (kernels/gemv.py) on any device, and a
// column window (vector-matrix, A[:, lo:hi] as a strided view) or a row
// window (matrix-vector, A[lo:hi]) gives the whole product's bits in it.
// The grid, the window's offset, M and the SM count change which thread
// computes an element, never the order it is computed in.
//
// Two entry points over one order:
//
// * vector-matrix, x (K,) @ A (K, M), A with row stride lda and unit
//   column stride: a thread owns a column (four columns where A's rows
//   are 16-byte aligned) and a slice, and walks the slice's rows; a warp
//   reads consecutive columns of one row.
// * matrix-vector, A (M, K) @ x (K,), A with row stride lda and unit
//   stride along K: a warp owns 32 rows and a slice; it copies the
//   slice's rows 32 columns at a time into its shared-memory tile,
//   coalesced, and each lane folds its row from there.
//
// Where K > KS the slices' sums go to an (S, M) buffer the wrapper
// allocates and a second pass folds them per column (the block stages
// 64 slices of 32 columns in shared memory so that its folding warp
// reads them at shared-memory latency); a single slice is folded into
// the output directly. No atomics: they would break the order.
//
// Bound on an H100 SXM: the product reads A once (4 K M bytes) and does
// 2 K M float32 operations, so it is bound by bytes: 0.32 ms at 16,384^2
// and 1.28 ms at 32,768^2 at 3.35 TB/s. The slice buffer adds 4 S M bytes
// written and read (S = K / 256: 1/64 of A's bytes at K = 16,384).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the contraction slice: the order's one constant (kernels/gemv.py::KS)
constexpr int KS = 256;
constexpr int kThreads = 256;
// matrix-vector: warps a block (each folds 32 rows of one slice) and
// columns a shared-memory chunk holds
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;
// the slice fold: slices and columns a block stages at a time
constexpr int kFoldRows = 64;
constexpr int kFoldCols = 32;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

// Write a slice's sum: into the output where there is one slice (the
// fold over slices from 0.0 is then 0.0 + sum), else into part[s, col].
__device__ __forceinline__ void put(float acc, long long s, long long S,
                                    long long col, long long M,
                                    float* __restrict__ part,
                                    float* __restrict__ out) {
  if (S == 1) {
    out[col] = add(0.0f, acc);
  } else {
    part[s * M + col] = acc;
  }
}

// vector-matrix, one column a thread: block (bx, by) covers bx columns
// and by slices; the 1-D grid walks column blocks fastest.
__global__ void __launch_bounds__(kThreads)
vecmat_partial(const float* __restrict__ x, const float* __restrict__ a,
               long long lda, long long K, long long M, long long S,
               long long col_blocks, float* __restrict__ part,
               float* __restrict__ out) {
  const long long blk = blockIdx.x;
  const long long col = (blk % col_blocks) * blockDim.x + threadIdx.x;
  const long long s = (blk / col_blocks) * blockDim.y + threadIdx.y;
  if (col >= M || s >= S) return;
  const long long k0 = s * KS;
  const long long k1 = K < k0 + KS ? K : k0 + KS;
  const float* p = a + k0 * lda + col;
  float acc = 0.0f;
#pragma unroll 8
  for (long long k = k0; k < k1; ++k, p += lda) {
    acc = add(acc, mul(__ldg(x + k), __ldg(p)));
  }
  put(acc, s, S, col, M, part, out);
}

// vector-matrix, four columns a thread with 16-byte loads (A's base
// 16-byte aligned, lda and M multiples of 4): four independent folds,
// each in the one order.
__global__ void __launch_bounds__(kThreads)
vecmat_partial4(const float* __restrict__ x, const float* __restrict__ a,
                long long lda, long long K, long long M, long long S,
                long long col_blocks, float* __restrict__ part,
                float* __restrict__ out) {
  const long long blk = blockIdx.x;
  const long long col =
      4 * ((blk % col_blocks) * blockDim.x + threadIdx.x);
  const long long s = (blk / col_blocks) * blockDim.y + threadIdx.y;
  if (col >= M || s >= S) return;
  const long long k0 = s * KS;
  const long long k1 = K < k0 + KS ? K : k0 + KS;
  const float* p = a + k0 * lda + col;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
  for (long long k = k0; k < k1; ++k, p += lda) {
    const float xk = __ldg(x + k);
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    acc.x = add(acc.x, mul(xk, v.x));
    acc.y = add(acc.y, mul(xk, v.y));
    acc.z = add(acc.z, mul(xk, v.z));
    acc.w = add(acc.w, mul(xk, v.w));
  }
  put(acc.x, s, S, col, M, part, out);
  put(acc.y, s, S, col + 1, M, part, out);
  put(acc.z, s, S, col + 2, M, part, out);
  put(acc.w, s, S, col + 3, M, part, out);
}

// matrix-vector: each warp owns 32 rows and a slice (a block holds
// kWarps such tasks, the row groups of a slice side by side); lane j
// copies column j of each of the warp's rows into the warp's tile, 32
// columns of the slice at a time (a row's 32 consecutive floats a warp
// instruction), and lane i then folds row i of the tile. The tile's
// pitch of kChunk + 1 keeps both the copy's row writes and the fold's
// column reads free of bank conflicts.
__global__ void __launch_bounds__(kThreads)
matvec_partial(const float* __restrict__ a, long long lda,
               const float* __restrict__ x, long long K, long long M,
               long long S, long long row_groups, float* __restrict__ part,
               float* __restrict__ out) {
  __shared__ float tile[kWarps][32][kChunk + 1];
  __shared__ float xs[kWarps][kChunk];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long task =
      static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (task >= row_groups * S) return;  // the whole warp: no block barrier
  const long long r0 = (task % row_groups) * 32;
  const long long s = task / row_groups;
  const long long k0 = s * KS;
  const long long k1 = K < k0 + KS ? K : k0 + KS;
  float(*t)[kChunk + 1] = tile[warp];
  float acc = 0.0f;
  for (long long kc = k0; kc < k1; kc += kChunk) {
    const long long left = k1 - kc;
    const int n = left < kChunk ? static_cast<int>(left) : kChunk;
#pragma unroll 8
    for (int i = 0; i < 32; ++i) {
      const long long r = r0 + i;
      t[i][lane] = (r < M && lane < n) ? __ldg(a + r * lda + kc + lane)
                                       : 0.0f;
    }
    xs[warp][lane] = lane < n ? __ldg(x + kc + lane) : 0.0f;
    __syncwarp();
    for (int j = 0; j < n; ++j) acc = add(acc, mul(xs[warp][j], t[lane][j]));
    __syncwarp();
  }
  const long long r = r0 + lane;
  if (r < M) put(acc, s, S, r, M, part, out);
}

// out[m] = fold from 0.0 over s ascending of part[s, m]: a block owns 32
// columns; all its warps stage kFoldRows slices of them in shared memory,
// then warp 0 folds them in order.
__global__ void __launch_bounds__(kThreads)
fold_slices(const float* __restrict__ part, long long S, long long M,
            float* __restrict__ out) {
  __shared__ float tile[kFoldRows][kFoldCols + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long col = static_cast<long long>(blockIdx.x) * kFoldCols +
                        lane;
  float acc = 0.0f;
  for (long long s0 = 0; s0 < S; s0 += kFoldRows) {
#pragma unroll
    for (int u = 0; u < kFoldRows / (kThreads / 32); ++u) {
      const int i = warp + u * (kThreads / 32);
      const long long s = s0 + i;
      tile[i][lane] = (s < S && col < M) ? part[s * M + col] : 0.0f;
    }
    __syncthreads();
    if (warp == 0) {
      const long long left = S - s0;
      const int n = left < kFoldRows ? static_cast<int>(left) : kFoldRows;
      for (int i = 0; i < n; ++i) acc = add(acc, tile[i][lane]);
    }
    __syncthreads();
  }
  if (warp == 0 && col < M) out[col] = acc;
}

long long slices(long long K) { return (K + KS - 1) / KS; }

int fold(const float* part, long long S, long long M, float* out,
         cudaStream_t stream) {
  if (S == 1) return cudaSuccess;
  const long long blocks = (M + kFoldCols - 1) / kFoldCols;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  fold_slices<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      part, S, M, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The contraction slice the order is built on (the wrapper checks it
// against its own constant).
int spartan_gemv_slice(void) { return KS; }

// out (M,) = x (K,) @ A (K, M); A's rows lda floats apart, its columns
// adjacent. part: (ceil(K / KS), M) floats, unused (may be null) when
// K <= KS. K, M > 0. Launches on `stream`, does not synchronise,
// returns cudaGetLastError().
int spartan_vecmat(const void* x, const void* a, long long lda, long long K,
                   long long M, void* part, void* out, void* stream) {
  if (K <= 0 || M <= 0 || lda < M) return cudaErrorInvalidValue;
  const long long S = slices(K);
  if (S > 1 && part == nullptr) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = (reinterpret_cast<uintptr_t>(a) % 16 == 0) &&
                    lda % 4 == 0 && M % 4 == 0;
  const long long units = wide ? M / 4 : M;  // threads along the columns
  long long bx = ((units + 31) / 32) * 32;
  if (bx > kThreads) bx = kThreads;
  const long long by = kThreads / bx;
  const long long col_blocks = (units + bx - 1) / bx;
  const long long blocks = col_blocks * ((S + by - 1) / by);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const dim3 block(static_cast<unsigned>(bx), static_cast<unsigned>(by));
  const float* xf = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(a);
  float* pf = static_cast<float*>(part);
  float* of = static_cast<float*>(out);
  if (wide) {
    vecmat_partial4<<<static_cast<unsigned>(blocks), block, 0, st>>>(
        xf, af, lda, K, M, S, col_blocks, pf, of);
  } else {
    vecmat_partial<<<static_cast<unsigned>(blocks), block, 0, st>>>(
        xf, af, lda, K, M, S, col_blocks, pf, of);
  }
  const int err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return fold(pf, S, M, of, st);
}

// out (M,) = A (M, K) @ x (K,); A's rows lda floats apart, each row's K
// floats adjacent. part as for spartan_vecmat.
int spartan_matvec(const void* a, long long lda, const void* x, long long K,
                   long long M, void* part, void* out, void* stream) {
  if (K <= 0 || M <= 0 || lda < K) return cudaErrorInvalidValue;
  const long long S = slices(K);
  if (S > 1 && part == nullptr) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long row_groups = (M + 31) / 32;
  const long long blocks = (row_groups * S + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  float* pf = static_cast<float*>(part);
  float* of = static_cast<float*>(out);
  matvec_partial<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      static_cast<const float*>(a), lda, static_cast<const float*>(x), K, M,
      S, row_groups, pf, of);
  const int err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return fold(pf, S, M, of, st);
}

}  // extern "C"
