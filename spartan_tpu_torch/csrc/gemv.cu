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
// computes an element and when, never the order it is computed in. No
// atomics touch a value: they would break the order.
//
// Bound on an H100 SXM: the product reads A once (4 K M bytes) and does
// 2 K M float32 operations, so it is bound by bytes: 0.32 ms at 16,384^2,
// 1.28 ms at 32,768^2 and 0.165 ms at (2^22, 32), at 3.35 TB/s. The
// slice buffer adds 4 S M bytes written and read (S = K / 256).
//
// Pass 1 computes the slices' sums; where K > KS they go to a slice
// buffer the wrapper allocates, tiled by 32 columns (tile b holds the
// S x 32 sums of columns 32 b .. 32 b + 31, slice-major, so a run of a
// tile's slices is one contiguous span), and the fold folds them per
// column. A single slice is folded into the output directly.
//
// * vector-matrix, x (K,) @ A (K, M), A with row stride lda and unit
//   column stride: a thread owns a column unit (four columns with
//   16-byte loads where A's rows are 16-byte aligned, else one, in the
//   same order) and a slice, and walks the slice's rows in batches of
//   kRowsAhead, the next batch's loads in flight while this one's
//   products are added (only the adds chain). A block is sized to the
//   columns, units x slices, so no thread starts idle at a narrow M (32
//   columns: 8 units x 32 slices a block).
// * matrix-vector, A (M, K) @ x (K,), A with row stride lda and unit
//   stride along K: a warp owns 32 rows and a slice; cp.async copies the
//   slice's rows into the warp's tile kChunk columns at a time (16-byte
//   copies, a warp instruction taking 512 contiguous bytes of one row,
//   where the rows are 16-byte aligned; 4-byte ones in the same order
//   elsewhere), double-buffered, so chunk c + 1 lands while lane i folds
//   row i of chunk c.
// * the fold, launched after pass 1 in the same stream: a warp owns a
//   tile of 32 columns; lane 0 brings its slices into a ring of stages
//   of kFoldRows slices in shared memory with 1-D bulk copies (TMA, one
//   contiguous span a stage, completion on an mbarrier), so the next
//   stages are in flight while the lanes add the current one. A stage is
//   one large copy because each stage has a fixed cost beside its
//   kFoldRows dependent adds.
//
// No block waits on another: the fold starts once pass 1 has ended (the
// stream orders them), so every launch runs to its end. The fold's chain
// of S adds a column is the floor of a narrow product with a long
// contraction (16,384 adds at (2^22, 32)); it is not started early,
// since no product the port runs has both a narrow output and S >> 64.
//
// fixed_order_reduce (kernels/reduce.py) is the same design without the
// vector: a float32 sum, mean or product along a run of axes, replacing
// no Pallas kernel either (the JAX package leaves a reduction to XLA,
// spartan_tpu/expr/reduce.py). The wrapper views the operand as
// (P, R, Q): P the kept axes before the reduced run, R the reduced axes
// (flattened in ascending order), Q the kept axes after them. Its order:
//
//   slice s covers r in [s*KS, min(R, (s+1)*KS))
//   part[s, p, q] = fold from the identity over that slice's r,
//                   ascending, of A[p, r, q]
//   out[p, q]     = fold from the identity over s, ascending
//
// with the identity 0.0 and __fadd_rn for a sum, 1.0 and __fmul_rn for
// a product (the wrapper divides a mean's sum by R once). Pass 1 and the
// fold are the GEMV's, templated on the op (DotOp, SumOp, ProdOp below):
// Q >= 2 takes the vector-matrix pass with P in the grid (block t =
// (p, column block, slice group)), Q = 1 the matrix-vector pass with
// rows = P. Only R and KS shape an element's order, so a window of the
// kept axes gives the whole reduction's bits in it, and a sum along
// axis 0 of a matrix gives the bits of fixed_order_dot(ones, A)
// (1.0 * a is exact). Bound: the operand read
// once, 4 P R Q bytes at 3.35 TB/s (0.32 ms at 16,384^2, 0.16 ms at
// 1,048,576 x 128); the slice buffer adds 4 S P Q bytes written and read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the contraction slice: the order's one constant (kernels/gemv.py::KS)
constexpr int KS = 256;
// vector-matrix: threads a block; rows a load batch holds (a thread
// issues batch b + 1's loads before batch b's adds)
constexpr int kThreads = 256;
constexpr int kRowsAhead = 8;
// matrix-vector: warps a block (each a slice of the block's 32 rows);
// columns a chunk holds (16-byte copies: kChunk / 4 lanes a row, so a
// warp instruction copies kChunk * 4 contiguous bytes of each of
// 128 / kChunk rows); the tile's row pitch (16-byte reads of a row free
// of bank conflicts); floats of a warp's tile and its chunk of x; tiles
// a warp double-buffers
constexpr int kMvWarps = 2;
constexpr int kChunk = 128;
constexpr int kLanesPerRow = kChunk / 4;
constexpr int kRowsPerCopy = 32 / kLanesPerRow;
constexpr int kPitch = kChunk + 4;
constexpr int kTileFloats = 32 * kPitch + kChunk;
constexpr int kMatvecSmem = kMvWarps * 2 * kTileFloats * 4;
// the fold: slices a stage holds (a 64 KB bulk copy: a stage's fixed
// cost is paid once per kFoldRows adds), and the most stages of its
// ring (fewer where the tile has fewer stages)
constexpr int kFoldRows = 512;
constexpr int kStageBytes = kFoldRows * 32 * 4;
constexpr int kRing = 3;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}

// The ops pass 1 and the fold are templated on: a slice folds
// step(acc, x[k], A[k, m]) from init(), the fold folds the slices' values
// with fold(acc, v) from init(). Only DotOp reads the vector.
struct DotOp {
  static constexpr bool kVector = true;
  static __device__ __forceinline__ float init() { return 0.0f; }
  static __device__ __forceinline__ float step(float acc, float x, float v) {
    return add(acc, mul(x, v));
  }
  static __device__ __forceinline__ float fold(float acc, float v) {
    return add(acc, v);
  }
};

struct SumOp {
  static constexpr bool kVector = false;
  static __device__ __forceinline__ float init() { return 0.0f; }
  static __device__ __forceinline__ float step(float acc, float, float v) {
    return add(acc, v);
  }
  static __device__ __forceinline__ float fold(float acc, float v) {
    return add(acc, v);
  }
};

struct ProdOp {
  static constexpr bool kVector = false;
  static __device__ __forceinline__ float init() { return 1.0f; }
  static __device__ __forceinline__ float step(float acc, float, float v) {
    return mul(acc, v);
  }
  static __device__ __forceinline__ float fold(float acc, float v) {
    return mul(acc, v);
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// bytes < 16 (0 included) reads that many and fills the rest with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                   "r"(smem_addr(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::
                   "r"(smem_addr(dst)), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

// one arrival that also expects `bytes` of bulk copies
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  return done != 0;
}

// `bytes` (a multiple of 16) from global to shared memory by the TMA,
// completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)), "l"(src),
      "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// The slice buffer's place of (slice s, column col): tiles of 32 columns,
// each S x 32 slice-major (a batch's tiles follow the previous batch's).
__device__ __forceinline__ long long tiled(long long s, long long col,
                                           long long S) {
  return (col >> 5) * S * 32 + s * 32 + (col & 31);
}

// Write W adjacent slice values from column col (W divides 32 and col):
// into the output where there is one slice (the fold over slices from
// the identity is then init() op value), else into the slice buffer.
template <int W, class Op>
__device__ __forceinline__ void put(const float (&acc)[W], long long s,
                                    long long S, long long col,
                                    float* __restrict__ part,
                                    float* __restrict__ out) {
  float v[W];
#pragma unroll
  for (int c = 0; c < W; ++c)
    v[c] = S == 1 ? Op::fold(Op::init(), acc[c]) : acc[c];
  float* dst = S == 1 ? out + col : part + tiled(s, col, S);
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    dst[0] = v[0];
  }
}

template <int W>
__device__ __forceinline__ void load_row(const float* p, float (&v)[W]) {
  if constexpr (W == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
    v[0] = __ldg(p);
  }
}

// out[p, m] = fold from init() over s ascending of the slice values of
// batch p's column m. Block b (one warp) folds tile b of the slice
// buffer: batch b / tiles, columns 32 (b % tiles) .. + 31, lane l the
// tile's column l. Lane 0 copies stage st (`rows` slices of the tile,
// contiguous) into slot st % ring of a ring of `ring` stages with an
// mbarrier each, keeping ring - 1 stages in flight; the lanes fold each
// stage as it lands.
template <class Op>
__global__ void __launch_bounds__(32)
fold_slices(const float* __restrict__ part, long long S, long long M,
            long long tiles, int rows, int ring,
            float* __restrict__ out) {
  extern __shared__ __align__(128) float slots[];
  __shared__ __align__(8) uint64_t landed[kRing];
  const int lane = threadIdx.x;
  const long long b = blockIdx.x;
  const long long p = b / tiles;
  const long long c0 = (b - p * tiles) * 32;
  const float* tile = part + b * S * 32;
  const long long stages = (S + rows - 1) / rows;
  if (lane == 0) {
    for (int i = 0; i < ring; ++i) mbar_init(&landed[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  auto issue = [&](long long st) {
    if (lane != 0 || st >= stages) return;
    const long long s0 = st * rows;
    const int n = static_cast<int>(S - s0 < rows ? S - s0 : rows);
    uint64_t* bar = &landed[st % ring];
    // the lanes' last reads of this slot before the copy rewrites it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect(bar, n * 128);
    bulk_copy(slots + (st % ring) * rows * 32, tile + s0 * 32, n * 128, bar);
  };
  for (int st = 0; st < ring - 1; ++st) issue(st);
  float acc = Op::init();
  for (long long st = 0; st < stages; ++st) {
    __syncwarp();  // every lane is done with the slot issue() refills
    issue(st + ring - 1);
    const int parity = static_cast<int>((st / ring) & 1);
    while (!mbar_try_wait(&landed[st % ring], parity)) {
    }
    const float* src = slots + (st % ring) * rows * 32 + lane;
    const long long left = S - st * rows;
    if (left >= kFoldRows) {  // a full stage: rows == kFoldRows
#pragma unroll
      for (int i = 0; i < kFoldRows; ++i) acc = Op::fold(acc, src[i * 32]);
    } else {
      for (int i = 0; i < left; ++i) acc = Op::fold(acc, src[i * 32]);
    }
  }
  if (c0 + lane < M) out[p * M + c0 + lane] = acc;
}

// kRowsAhead rows of A from p (lda apart) and, for DotOp, their x values,
// loaded
template <int W, class Op>
__device__ __forceinline__ void load_batch(const float* __restrict__ x,
                                           const float* __restrict__ p,
                                           long long lda,
                                           float (&v)[kRowsAhead][W],
                                           float (&xv)[kRowsAhead]) {
#pragma unroll
  for (int i = 0; i < kRowsAhead; ++i) {
    load_row<W>(p + i * lda, v[i]);
    xv[i] = Op::kVector ? __ldg(x + i) : 0.0f;
  }
}

// a loaded batch folded onto acc, row by row in ascending k
template <int W, class Op>
__device__ __forceinline__ void add_batch(const float (&v)[kRowsAhead][W],
                                          const float (&xv)[kRowsAhead],
                                          float (&acc)[W]) {
#pragma unroll
  for (int i = 0; i < kRowsAhead; ++i) {
#pragma unroll
    for (int c = 0; c < W; ++c) acc[c] = Op::step(acc[c], xv[i], v[i][c]);
  }
}

// vector-matrix pass 1 over P batches of A (batch p at a + p * sp, its
// output at out + p * M). Block t = (batch, column block, slice group),
// slice group fastest; its thread (x, y) owns column unit
// cb * blockDim.x + x (W columns) and slice sg * blockDim.y + y.
template <int W, class Op>
__global__ void __launch_bounds__(kThreads)
vecmat_pass1(const float* __restrict__ x, const float* __restrict__ a,
             long long lda, long long sp, long long K, long long M,
             long long S, long long units, long long col_blocks,
             long long slice_groups, float* __restrict__ part,
             float* __restrict__ out) {
  long long t = blockIdx.x;
  const long long batch = t / (col_blocks * slice_groups);
  t -= batch * col_blocks * slice_groups;
  const long long u = (t / slice_groups) * blockDim.x + threadIdx.x;
  const long long s = (t % slice_groups) * blockDim.y + threadIdx.y;
  if (u < units && s < S) {
    a += batch * sp;
    out += batch * M;
    if (S > 1) part += batch * ((M + 31) / 32) * S * 32;
    const long long col = u * W;
    const long long k0 = s * KS;
    const long long k1 = K < k0 + KS ? K : k0 + KS;
    const float* p = a + k0 * lda + col;
    float acc[W];
#pragma unroll
    for (int c = 0; c < W; ++c) acc[c] = Op::init();
    // batches of kRowsAhead rows, two register buffers: the next
    // batch's loads are in flight while this one is folded
    const int batches = static_cast<int>((k1 - k0) / kRowsAhead);
    float va[kRowsAhead][W], vb[kRowsAhead][W];
    float xa[kRowsAhead], xb[kRowsAhead];
    if (batches > 0) load_batch<W, Op>(x + k0, p, lda, va, xa);
    int b = 0;
    for (; b + 1 < batches; b += 2) {
      load_batch<W, Op>(x + k0 + (b + 1) * kRowsAhead,
                        p + (b + 1) * kRowsAhead * lda, lda, vb, xb);
      add_batch<W, Op>(va, xa, acc);
      if (b + 2 < batches)
        load_batch<W, Op>(x + k0 + (b + 2) * kRowsAhead,
                          p + (b + 2) * kRowsAhead * lda, lda, va, xa);
      add_batch<W, Op>(vb, xb, acc);
    }
    if (b < batches) add_batch<W, Op>(va, xa, acc);  // an odd count's last
    long long k = k0 + static_cast<long long>(batches) * kRowsAhead;
    p += (k - k0) * lda;
    for (; k < k1; ++k, p += lda) {
      float v[W];
      load_row<W>(p, v);
      const float xk = Op::kVector ? __ldg(x + k) : 0.0f;
#pragma unroll
      for (int c = 0; c < W; ++c) acc[c] = Op::step(acc[c], xk, v[c]);
    }
    put<W, Op>(acc, s, S, col, part, out);
  }
}

// Rows r0 .. r0 + 31 of A's columns [kc, kc + n) into a warp's tile
// (pitch kPitch) and, for DotOp, x[kc, kc + n) after it, by cp.async;
// rows at or past M and columns past n are zeros. V = 4: 16-byte copies
// (A's base 16-byte aligned, lda a multiple of 4), lane l copying floats
// 4 (l % kLanesPerRow) .. + 3 of rows l / kLanesPerRow + kRowsPerCopy j;
// V = 1: 4-byte copies, lane l copying columns l, l + 32, ... of each row.
template <int V, class Op>
__device__ __forceinline__ void copy_chunk(float* tile,
                                           const float* __restrict__ a,
                                           long long lda,
                                           const float* __restrict__ x,
                                           long long r0, long long M,
                                           long long kc, int n, int lane) {
  if constexpr (V == 4) {
    const int q = 4 * (lane % kLanesPerRow);
    const int left = n - q;
    const int valid = left < 0 ? 0 : (left > 4 ? 4 : left);
#pragma unroll
    for (int j = 0; j < 32 / kRowsPerCopy; ++j) {
      const int i = kRowsPerCopy * j + lane / kLanesPerRow;
      const long long r = r0 + i;
      const bool ok = r < M && valid > 0;
      cp_async16(tile + i * kPitch + q, ok ? a + r * lda + kc + q : a,
                 ok ? 4 * valid : 0);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < 32; ++i) {
      const long long r = r0 + i;
#pragma unroll
      for (int c = lane; c < kChunk; c += 32) {
        const bool ok = r < M && c < n;
        cp_async4(tile + i * kPitch + c, ok ? a + r * lda + kc + c : a,
                  ok ? 4 : 0);
      }
    }
  }
  if constexpr (Op::kVector) {
#pragma unroll
    for (int c = lane; c < kChunk; c += 32) {
      const bool ok = c < n;
      cp_async4(tile + 32 * kPitch + c, ok ? x + kc + c : x, ok ? 4 : 0);
    }
  }
}

// Lane i's row of a landed tile folded onto acc, columns 0 .. n - 1 in
// order (16-byte reads of the row, and of x for DotOp, where four
// remain).
template <class Op>
__device__ __forceinline__ float fold_chunk(const float* tile, int n,
                                            int lane, float acc) {
  const float* row = tile + lane * kPitch;
  const float* xs = tile + 32 * kPitch;
  int j = 0;
  for (; j + 4 <= n; j += 4) {
    const float4 v = *reinterpret_cast<const float4*>(row + j);
    float4 w = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if constexpr (Op::kVector) w = *reinterpret_cast<const float4*>(xs + j);
    acc = Op::step(acc, w.x, v.x);
    acc = Op::step(acc, w.y, v.y);
    acc = Op::step(acc, w.z, v.z);
    acc = Op::step(acc, w.w, v.w);
  }
  for (; j < n; ++j) acc = Op::step(acc, Op::kVector ? xs[j] : 0.0f, row[j]);
  return acc;
}

// matrix-vector pass 1. Block t = (row block t / slice_groups, slice
// group t % slice_groups); its warp w owns the block's 32 rows and slice
// sg * kMvWarps + w.
template <int V, class Op>
__global__ void __launch_bounds__(kMvWarps * 32)
matvec_pass1(const float* __restrict__ a, long long lda,
             const float* __restrict__ x, long long K, long long M,
             long long S, long long slice_groups,
             float* __restrict__ part, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* tiles = smem + warp * 2 * kTileFloats;
  const long long t = blockIdx.x;
  const long long r0 = (t / slice_groups) * 32;
  const long long s = (t % slice_groups) * kMvWarps + warp;
  if (s < S) {
    const long long k0 = s * KS;
    const long long k1 = K < k0 + KS ? K : k0 + KS;
    const int chunks = static_cast<int>((k1 - k0 + kChunk - 1) / kChunk);
    float acc = Op::init();
    copy_chunk<V, Op>(tiles, a, lda, x, r0, M, k0,
                      static_cast<int>(k1 - k0 < kChunk ? k1 - k0 : kChunk),
                      lane);
    cp_async_commit();
    for (int c = 0; c < chunks; ++c) {
      if (c + 1 < chunks) {
        const long long kn = k0 + static_cast<long long>(c + 1) * kChunk;
        copy_chunk<V, Op>(tiles + ((c + 1) & 1) * kTileFloats, a, lda, x,
                          r0, M, kn,
                          static_cast<int>(k1 - kn < kChunk ? k1 - kn
                                                            : kChunk),
                          lane);
      }
      cp_async_commit();  // empty past the last chunk: one group a step
      cp_async_wait<1>();
      __syncwarp();
      const long long kc = k0 + static_cast<long long>(c) * kChunk;
      acc = fold_chunk<Op>(tiles + (c & 1) * kTileFloats,
                           static_cast<int>(k1 - kc < kChunk ? k1 - kc
                                                             : kChunk),
                           lane, acc);
      __syncwarp();  // the tile is free for chunk c + 2
    }
    const long long r = r0 + lane;
    if (r < M) {
      const float one[1] = {acc};
      put<1, Op>(one, s, S, r, part, out);
    }
  }
}

long long slices(long long K) { return (K + KS - 1) / KS; }

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The fold of P batches' slice buffers (each ceil(M / 32) tiles) into
// out (P, M), launched after pass 1 in the same stream.
template <class Op>
int fold(const float* part, long long S, long long P, long long M,
         float* out, cudaStream_t stream) {
  if (S == 1) return cudaSuccess;
  const long long tiles = (M + 31) / 32;
  const long long blocks = P * tiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  // a stage of at most kFoldRows slices, the ring no deeper than the
  // tile's stages
  const int rows = static_cast<int>(S < kFoldRows ? S : kFoldRows);
  const long long stages = (S + rows - 1) / rows;
  const int ring = static_cast<int>(stages < kRing ? stages : kRing);
  fold_slices<Op><<<static_cast<unsigned>(blocks), 32, ring * rows * 128,
                    stream>>>(part, S, M, tiles, rows, ring, out);
  return cudaGetLastError();
}

// Once a device: the opt-in to the dynamic shared memory of the
// matrix-vector tiles and of the fold's ring, for every op.
int allow_smem() {
  static bool done[kMaxDevices];
  int dev = 0;
  int err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < kMaxDevices && done[dev]) return cudaSuccess;
  const struct {
    const void* kernel;
    int bytes;
  } sets[] = {
      {reinterpret_cast<const void*>(matvec_pass1<4, DotOp>), kMatvecSmem},
      {reinterpret_cast<const void*>(matvec_pass1<1, DotOp>), kMatvecSmem},
      {reinterpret_cast<const void*>(matvec_pass1<4, SumOp>), kMatvecSmem},
      {reinterpret_cast<const void*>(matvec_pass1<1, SumOp>), kMatvecSmem},
      {reinterpret_cast<const void*>(matvec_pass1<4, ProdOp>), kMatvecSmem},
      {reinterpret_cast<const void*>(matvec_pass1<1, ProdOp>), kMatvecSmem},
      {reinterpret_cast<const void*>(fold_slices<DotOp>), kRing * kStageBytes},
      {reinterpret_cast<const void*>(fold_slices<SumOp>), kRing * kStageBytes},
      {reinterpret_cast<const void*>(fold_slices<ProdOp>),
       kRing * kStageBytes},
  };
  for (const auto& set : sets) {
    err = cudaFuncSetAttribute(
        set.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, set.bytes);
    if (err != cudaSuccess) return err;
  }
  if (dev >= 0 && dev < kMaxDevices) done[dev] = true;
  return cudaSuccess;
}

// Pass 1 and the fold of P batches of x (K,) @ A (K, M) (Op's view of
// it): A's rows lda floats apart, its columns adjacent, batch p at
// a + p * sp. K, M, P > 0.
template <class Op>
int vecmat(const float* x, const float* a, long long lda, long long sp,
           long long P, long long K, long long M, float* part,
           float* out, cudaStream_t st) {
  const long long S = slices(K);
  if (S > 1 && part == nullptr) return cudaErrorInvalidValue;
  const bool wide = aligned16(a) && lda % 4 == 0 && M % 4 == 0 &&
                    (P == 1 || sp % 4 == 0);
  const long long units = wide ? M / 4 : M;  // threads along the columns
  const long long bx = units < kThreads ? units : kThreads;
  const long long by = kThreads / bx;
  const long long slice_groups = (S + by - 1) / by;
  const long long col_blocks = (units + bx - 1) / bx;
  const long long blocks = P * col_blocks * slice_groups;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  int err = allow_smem();
  if (err != cudaSuccess) return err;
  const dim3 g(static_cast<unsigned>(blocks));
  const dim3 block(static_cast<unsigned>(bx), static_cast<unsigned>(by));
  if (wide) {
    vecmat_pass1<4, Op><<<g, block, 0, st>>>(x, a, lda, sp, K, M, S, units,
                                             col_blocks, slice_groups, part,
                                             out);
  } else {
    vecmat_pass1<1, Op><<<g, block, 0, st>>>(x, a, lda, sp, K, M, S, units,
                                             col_blocks, slice_groups, part,
                                             out);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return fold<Op>(part, S, P, M, out, st);
}

// Pass 1 and the fold of A (M, K) @ x (K,) (Op's view of it): A's rows
// lda floats apart, each row's K floats adjacent. K, M > 0.
template <class Op>
int matvec(const float* a, long long lda, const float* x, long long K,
           long long M, float* part, float* out,
           cudaStream_t st) {
  const long long S = slices(K);
  if (S > 1 && part == nullptr) return cudaErrorInvalidValue;
  const long long slice_groups = (S + kMvWarps - 1) / kMvWarps;
  const long long blocks = ((M + 31) / 32) * slice_groups;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  int err = allow_smem();
  if (err != cudaSuccess) return err;
  const unsigned g = static_cast<unsigned>(blocks);
  if (aligned16(a) && lda % 4 == 0) {
    matvec_pass1<4, Op><<<g, kMvWarps * 32, kMatvecSmem, st>>>(
        a, lda, x, K, M, S, slice_groups, part, out);
  } else {
    matvec_pass1<1, Op><<<g, kMvWarps * 32, kMatvecSmem, st>>>(
        a, lda, x, K, M, S, slice_groups, part, out);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return fold<Op>(part, S, 1, M, out, st);
}

// the reduction codes of kernels/reduce.py (a mean is a sum there)
enum ReduceCode { kSum = 0, kProd = 1 };

}  // namespace

extern "C" {

// The contraction slice the order is built on (the wrapper checks it
// against its own constant).
int spartan_gemv_slice(void) { return KS; }

// out (M,) = x (K,) @ A (K, M); A's rows lda floats apart, its columns
// adjacent. part: the slice buffer, ceil(K / KS) * ceil(M / 32) * 32
// floats (tiles of 32 columns), unused (may be null) when K <= KS.
// K, M > 0. Launches on `stream`, does not synchronise, returns the
// first CUDA error.
int spartan_vecmat(const void* x, const void* a, long long lda, long long K,
                   long long M, void* part, void* out, void* stream) {
  if (K <= 0 || M <= 0 || lda < M) return cudaErrorInvalidValue;
  return vecmat<DotOp>(static_cast<const float*>(x),
                       static_cast<const float*>(a), lda, 0, 1, K, M,
                       static_cast<float*>(part), static_cast<float*>(out),
                       static_cast<cudaStream_t>(stream));
}

// out (M,) = A (M, K) @ x (K,); A's rows lda floats apart, each row's K
// floats adjacent. part as for spartan_vecmat.
int spartan_matvec(const void* a, long long lda, const void* x, long long K,
                   long long M, void* part, void* out, void* stream) {
  if (K <= 0 || M <= 0 || lda < K) return cudaErrorInvalidValue;
  return matvec<DotOp>(static_cast<const float*>(a), lda,
                       static_cast<const float*>(x), K, M,
                       static_cast<float*>(part), static_cast<float*>(out),
                       static_cast<cudaStream_t>(stream));
}

// out (P, Q) = the reduction `op` (ReduceCode) of A (P, R, Q) over R:
// batch p at a + p * sp, its rows sr floats apart, its Q floats
// adjacent. part: ceil(R / KS) * P * ceil(Q / 32) * 32 floats, unused
// (may be null) when R <= KS. P, R, Q > 0.
int spartan_reduce_outer(const void* a, long long sp, long long sr,
                         long long P, long long R, long long Q, int op,
                         void* part, void* out, void* stream) {
  if (P <= 0 || R <= 0 || Q <= 0 || (R > 1 && sr < Q)) {
    return cudaErrorInvalidValue;
  }
  const float* af = static_cast<const float*>(a);
  float* pf = static_cast<float*>(part);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kSum:
      return vecmat<SumOp>(nullptr, af, sr, sp, P, R, Q, pf, of, st);
    case kProd:
      return vecmat<ProdOp>(nullptr, af, sr, sp, P, R, Q, pf, of, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// out (P,) = the reduction `op` of A (P, R) over R: its rows lda floats
// apart, each row's R floats adjacent. part: ceil(R / KS) * ceil(P / 32)
// * 32 floats, unused (may be null) when R <= KS. P, R > 0.
int spartan_reduce_inner(const void* a, long long lda, long long P,
                         long long R, int op, void* part, void* out,
                         void* stream) {
  if (P <= 0 || R <= 0 || (P > 1 && lda < R)) return cudaErrorInvalidValue;
  const float* af = static_cast<const float*>(a);
  float* pf = static_cast<float*>(part);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kSum:
      return matvec<SumOp>(af, lda, nullptr, R, P, pf, of, st);
    case kProd:
      return matvec<ProdOp>(af, lda, nullptr, R, P, pf, of, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
