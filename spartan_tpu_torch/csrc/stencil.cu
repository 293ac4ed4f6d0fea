// NHWC convolution (the stencil's conv_block) for Hopper (sm_90a).
//
// conv_block replaces spartan_tpu/kernels/stencil.py::conv_block, the Pallas
// TPU kernel that halo_stencil runs on every H-shard's halo-padded block
// (StencilExpr: st.stencil on an operand whose H axis is tiled). For each
// block b it computes the VALID convolution
//   out[b, oh, ow, o] = sum_{dh, dw, c} x[b, oh + dh, ow + dw, c] * w[dh, dw, c, o]
// in f32. The TPU kernel runs KH*KW shifted-slice matrix products at
// Precision.HIGHEST over a grid of (image, H row block), accumulating in a
// VMEM tile; none of that carries over. Here every block of every logical
// H-shard is convolved in one launch, and the output is written straight
// into (image, shard * ho + oh, ow, o), the layout of the unsharded result.
// Two routes, chosen by a static rule on C (kernels/stencil.py::route):
//
// C <= 4, SIMT (conv_kernel): a direct conv with FP32 FMAs on the CUDA
// cores. A CTA computes an 8 x 32 tile of output pixels for 64 output
// channels; per chunk of 4 input channels it stages the tile's input rows
// and the chunk's filter taps in shared memory, then each of its 256
// threads accumulates 8 pixels x 8 output channels in registers. At C = 3
// (VGG conv1_1) the work is bound by bytes, and this beats cuDNN.
//
// C > 4, tensor cores (conv_mma_kernel): an implicit GEMM with M = a CTA's
// 4 x 32 output pixels, N = 64 output channels and K = KH*KW*C, walked as
// chunks of 8 input channels, every tap of the filter within a chunk. The
// A operand of tap (dh, dw) is read from the staged input rows shifted by
// (dh, dw): im2col in the addressing, not in memory. Four warps each own
// 64 pixels x 32 channels (4 x 4 mma tiles of m16n8k8, 64 accumulators a
// thread) and issue mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32.
//   Precision: the TPU kernel's products are Precision.HIGHEST, and plain
// TF32 keeps 10 mantissa bits (~5e-4 relative), far outside the 1e-5 the
// VGG check holds against float64. So each operand v is split as
// hi = tf32_rna(v), lo = tf32_rna(v - hi), and every product is taken as
// a_lo*b_hi + a_hi*b_lo (first) + a_hi*b_hi, all summed in f32 (3xTF32).
// The dropped a_lo*b_lo and the rounding of the two lo parts each stay
// below 2^-22 |a||b|: at most 12 * 2^-24 |a||b| per product on top of
// f32 summation, hence the route's tolerance against the plain version,
// (2 + 12) * K * 2^-24 * max conv(|x|, |w|). The tensor cores truncate
// where they add into the accumulator, so each chunk's mma results go to
// a zeroed register tile first and are added to the running sum with one
// rounded f32 add per chunk: the truncations of a whole K do not pile up
// in one running sum. The filter's fragments are split after their
// shared-memory load like the input's; each input fragment is split once
// and used by 4 n-tiles, each filter fragment by 4 m-tiles. The split is
// the loop's largest cost in issue slots, so hi is rounded with integer
// arithmetic (add half a TF32 ulp to the magnitude, clear the 13 low
// bits), the same result as cvt.rna; lo keeps cvt.rna, which carries a
// NaN through. An infinite input gives NaN (inf - inf in the split),
// where the plain version gives +-inf.
//   Staging: cp.async.cg 16-byte copies (4-byte cp.async.ca where C or O
// is not a multiple of 4) into a ring of 2 stages (1 where a large filter
// leaves no room), each holding the chunk's input rows (4 + KH - 1) x
// (32 + KW - 1) x 8 and its filter taps KH x KW x 8 x 64. One
// cp.async.wait_group and one __syncthreads() per chunk; the next chunk's
// copies run under this chunk's mma. Two stages leave room, in shared
// memory and in registers, for 3 CTAs (12 warps) on an SM. A staged
// pixel's 8 channels sit at a pitch of 12 floats, and the filter's rows
// of 64 output channels are XOR-swizzled by 8 * (k mod 4), so neither
// fragment load has a bank conflict. Zero-fill (the src-size operand of
// cp.async) covers the tile's ragged edges, the chunk past C and the
// channel tile past O; the input is already SAME-padded by halo_exchange.
//
// Both routes sum every output in one fixed order -- chunk, then dh, then
// dw, then the channel within the chunk -- with no atomics, so each run
// gives the same bits. Ragged tiles (W, H, O) are masked at the store.
//
// Bounds on an H100 SXM at the VGG-16 block-1 shapes (32 images, 224 x
// 224, 8 H-shards): conv1_2 (C = O = 64) does 2 * 32 * 224 * 224 * 64 *
// 576 = 118.4 GFLOP. In IEEE FP32 on the CUDA cores that is 1.77 ms at
// 67 TFLOP/s; as 3xTF32 it is three TF32 products, 0.72 ms at 495 TFLOP/s
// dense TF32, the least time for f32-accurate work on this card. It moves
// 0.86 GB (0.26 ms at 3.35 TB/s), so it is bound by operations. conv1_1
// (C = 3) does 5.55 GFLOP (0.083 ms) and moves 0.43 GB (0.129 ms): bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// -- SIMT route (C <= 4) ------------------------------------------------------

constexpr int kTH = 8;    // output rows per CTA
constexpr int kTW = 32;   // output columns per CTA
constexpr int kTO = 64;   // output channels per CTA
constexpr int kCK = 4;    // input channels per staged chunk
constexpr int kPix = 8;   // consecutive output columns per thread
constexpr int kOut = 8;   // consecutive output channels per thread
constexpr int kGroupsO = kTO / kOut;                  // 8
constexpr int kGroupsW = kTW / kPix;                  // 4
constexpr int kThreads = kTH * kGroupsW * kGroupsO;   // 256

__global__ void __launch_bounds__(kThreads, 2)
conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
            float* __restrict__ out, int images, int shards, int hp, int wp,
            int c, int kh, int kw, int o, int tiles_w) {
  extern __shared__ float4 smem4[];
  const int taps = kh * kw;
  const int thp = kTH + kh - 1;
  const int twp = kTW + kw - 1;
  const int plane = thp * twp;
  float* w_s = reinterpret_cast<float*>(smem4);  // [tap][kCK][kTO]
  float* x_s = w_s + taps * kCK * kTO;            // [kCK][thp][twp]

  const int ho = hp - kh + 1;
  const int wo = wp - kw + 1;
  const int b = blockIdx.z;  // block = shard * images + image
  const int oh0 = (blockIdx.x / tiles_w) * kTH;
  const int ow0 = (blockIdx.x % tiles_w) * kTW;
  const int o0 = blockIdx.y * kTO;

  const int og = threadIdx.x % kGroupsO;
  const int g = threadIdx.x / kGroupsO;
  const int row = g / kGroupsW;
  const int col0 = (g % kGroupsW) * kPix;

  float acc[kPix][kOut] = {};
  const float* xb = x + static_cast<long long>(b) * hp * wp * c;

  for (int c0 = 0; c0 < c; c0 += kCK) {
    __syncthreads();  // the previous chunk's tiles are read
    for (int i = threadIdx.x; i < taps * kCK * kTO; i += kThreads) {
      const int oo = i % kTO;
      const int cc = (i / kTO) % kCK;
      const int tap = i / (kTO * kCK);
      const int ci = c0 + cc;
      const int oi = o0 + oo;
      w_s[i] = (ci < c && oi < o)
                   ? w[(static_cast<long long>(tap) * c + ci) * o + oi]
                   : 0.f;
    }
    for (int i = threadIdx.x; i < kCK * plane; i += kThreads) {
      const int cc = i % kCK;  // fastest: neighbouring channels in memory
      const int q = (i / kCK) % twp;
      const int r = i / (kCK * twp);
      const int hi = oh0 + r;
      const int wi = ow0 + q;
      const int ci = c0 + cc;
      float v = 0.f;
      if (hi < hp && wi < wp && ci < c)
        v = xb[(static_cast<long long>(hi) * wp + wi) * c + ci];
      x_s[(cc * thp + r) * twp + q] = v;
    }
    __syncthreads();
    for (int dh = 0; dh < kh; ++dh) {
      for (int dw = 0; dw < kw; ++dw) {
        const float* xr = x_s + (row + dh) * twp + col0 + dw;
        const float* wr = w_s + (dh * kw + dw) * kCK * kTO + og * kOut;
#pragma unroll
        for (int cc = 0; cc < kCK; ++cc) {
          float a[kPix];
#pragma unroll
          for (int i = 0; i < kPix; ++i) a[i] = xr[cc * plane + i];
          const float4 b0 = *reinterpret_cast<const float4*>(wr + cc * kTO);
          const float4 b1 =
              *reinterpret_cast<const float4*>(wr + cc * kTO + 4);
          const float bv[kOut] = {b0.x, b0.y, b0.z, b0.w,
                                  b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < kPix; ++i)
#pragma unroll
            for (int j = 0; j < kOut; ++j)
              acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
        }
      }
    }
  }

  const int oh = oh0 + row;
  if (oh >= ho) return;
  const int shard = b / images;
  const int image = b % images;
  const long long out_row =
      (static_cast<long long>(image) * shards + shard) * ho + oh;
  const int ob = o0 + og * kOut;
  const bool vec = (o % 4 == 0) && (ob + kOut <= o);
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int ow = ow0 + col0 + i;
    if (ow >= wo) break;
    float* dst = out + (out_row * wo + ow) * o + ob;
    if (vec) {
      reinterpret_cast<float4*>(dst)[0] =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      reinterpret_cast<float4*>(dst)[1] =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    } else {
#pragma unroll
      for (int j = 0; j < kOut; ++j)
        if (ob + j < o) dst[j] = acc[i][j];
    }
  }
}

size_t simt_smem(int kh, int kw) {
  return sizeof(float) *
         (static_cast<size_t>(kh) * kw * kCK * kTO +
          static_cast<size_t>(kCK) * (kTH + kh - 1) * (kTW + kw - 1));
}

// -- tensor-core route (C > 4) --------------------------------------------------

constexpr int kMTH = 4;       // output rows per CTA
constexpr int kMTW = 32;      // output columns per CTA
constexpr int kMTO = 64;      // output channels per CTA
constexpr int kMCK = 8;       // input channels per chunk (one mma k-step)
constexpr int kMPitch = 12;   // floats per staged pixel: 8 channels + 4 pad
constexpr int kMThreads = 128;  // 4 warps: 2 along pixels x 2 along channels
constexpr size_t kSmemPerBlock = 232448;  // Hopper's opt-in maximum

// floats of one stage: the chunk's input rows, then its filter taps
__host__ __device__ int mma_x_floats(int kh, int kw) {
  return (kMTH + kh - 1) * (kMTW + kw - 1) * kMPitch;
}
size_t mma_stage_bytes(int kh, int kw) {
  return sizeof(float) * (static_cast<size_t>(mma_x_floats(kh, kw)) +
                          static_cast<size_t>(kh) * kw * kMCK * kMTO);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from global to shared memory, zero-filled when !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                   "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::
                   "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v = hi + lo, both TF32 rounded to nearest, ties away. hi takes cvt.rna's
// rounding in two integer ops: half a TF32 ulp (bit 12) added to the
// magnitude carries into the kept bits, then the 13 low bits are cleared.
// That can carry a NaN into another value, so lo, whose rest is NaN when
// v is, goes through cvt.rna itself and keeps it NaN.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  const float rest = v - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// d += a (16 x 8, row) * b (8 x 8, col) on the tensor cores
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Lane (g, t) = (lane / 4, lane % 4) of an m16n8k8 tile holds A at
// (m, k) = (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); B at (k, n) =
// (t, g), (t + 4, g); the sums at (m, n) = (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1). A warp's m-tile mt covers 16 consecutive
// output columns of one row: rows 2 wm + mt / 2, columns 16 (mt % 2) + m.
template <int S>
__global__ void __launch_bounds__(kMThreads, 3)
conv_mma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                float* __restrict__ out, int images, int shards, int hp,
                int wp, int c, int kh, int kw, int o, int tiles_w, int vec_x,
                int vec_w) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int taps = kh * kw;
  const int thp = kMTH + kh - 1;
  const int twp = kMTW + kw - 1;
  const int x_floats = mma_x_floats(kh, kw);
  const int stage = x_floats + taps * kMCK * kMTO;
  const int ho = hp - kh + 1;
  const int wo = wp - kw + 1;
  const int b = blockIdx.z;  // block = shard * images + image
  const int oh0 = (blockIdx.x / tiles_w) * kMTH;
  const int ow0 = (blockIdx.x % tiles_w) * kMTW;
  const int o0 = blockIdx.y * kMTO;
  const float* const xb = x + static_cast<long long>(b) * hp * wp * c;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (tid >> 5) >> 1;  // output rows 2 wm, 2 wm + 1 of the tile
  const int wn = (tid >> 5) & 1;   // output channels 32 wn .. 32 wn + 31
  const int nchunks = (c + kMCK - 1) / kMCK;

  // chunk `chunk`'s input rows and filter taps into ring slot `slot`
  auto load = [&](int chunk, int slot) {
    float* const xs = smem + slot * stage;
    float* const ws = xs + x_floats;
    const int c0 = chunk * kMCK;
    if (vec_x) {
      for (int i = tid; i < thp * twp * 2; i += kMThreads) {
        const int pix = i >> 1;
        const int ci = c0 + (i & 1) * 4;
        const int r = pix / twp;
        const int hi = oh0 + r;
        const int wi = ow0 + pix - r * twp;
        const bool ok = hi < hp && wi < wp && ci < c;
        cp_async16(xs + pix * kMPitch + (i & 1) * 4,
                   ok ? xb + (static_cast<long long>(hi) * wp + wi) * c + ci
                      : xb,
                   ok);
      }
    } else {
      for (int i = tid; i < thp * twp * kMCK; i += kMThreads) {
        const int pix = i >> 3;
        const int ci = c0 + (i & 7);
        const int r = pix / twp;
        const int hi = oh0 + r;
        const int wi = ow0 + pix - r * twp;
        const bool ok = hi < hp && wi < wp && ci < c;
        cp_async4(xs + pix * kMPitch + (i & 7),
                  ok ? xb + (static_cast<long long>(hi) * wp + wi) * c + ci
                     : xb,
                  ok);
      }
    }
    // filter row (tap, k) of 64 output channels, swizzled by 8 * (k % 4)
    if (vec_w) {
      for (int i = tid; i < taps * kMCK * (kMTO / 4); i += kMThreads) {
        const int n = (i & 15) * 4;
        const int k = (i >> 4) & 7;
        const int tap = i >> 7;
        const int ci = c0 + k;
        const bool ok = ci < c && o0 + n < o;
        cp_async16(ws + (tap * kMCK + k) * kMTO + (n ^ ((k & 3) << 3)),
                   ok ? w + (static_cast<long long>(tap) * c + ci) * o + o0 + n
                      : w,
                   ok);
      }
    } else {
      for (int i = tid; i < taps * kMCK * kMTO; i += kMThreads) {
        const int n = i & 63;
        const int k = (i >> 6) & 7;
        const int tap = i >> 9;
        const int ci = c0 + k;
        const bool ok = ci < c && o0 + n < o;
        cp_async4(ws + (tap * kMCK + k) * kMTO + (n ^ ((k & 3) << 3)),
                  ok ? w + (static_cast<long long>(tap) * c + ci) * o + o0 + n
                     : w,
                  ok);
      }
    }
  };

  float acc[4][4][4] = {};  // [m-tile][n-tile][fragment]: the running sum
  float part[4][4][4];      // one chunk's mma sums

  for (int s = 0; s < S - 1; ++s) {
    if (s < nchunks) load(s, s);
    cp_async_commit();
  }
  for (int chunk = 0; chunk < nchunks; ++chunk) {
    if constexpr (S == 1) {
      load(chunk, 0);
      cp_async_commit();
      cp_async_wait<0>();
    } else {
      cp_async_wait<S - 2>();  // this chunk's copies have landed
    }
    __syncthreads();  // ... for every thread; the oldest slot is free
    if constexpr (S > 1) {
      const int next = chunk + S - 1;
      if (next < nchunks) load(next, next % S);
      cp_async_commit();
    }
    const float* const xs = smem + (chunk % S) * stage;
    const float* const ws = xs + x_floats;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int f = 0; f < 4; ++f) part[mt][nt][f] = 0.f;
    for (int dh = 0; dh < kh; ++dh) {
      for (int dw = 0; dw < kw; ++dw) {
        uint32_t ahi[4][4], alo[4][4], bhi[4][2], blo[4][2];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const float* p =
              xs + ((2 * wm + (mt >> 1) + dh) * twp + (mt & 1) * 16 + g + dw) *
                       kMPitch + t;
          split_tf32(p[0], ahi[mt][0], alo[mt][0]);
          split_tf32(p[8 * kMPitch], ahi[mt][1], alo[mt][1]);
          split_tf32(p[4], ahi[mt][2], alo[mt][2]);
          split_tf32(p[8 * kMPitch + 4], ahi[mt][3], alo[mt][3]);
        }
        const float* wt = ws + (dh * kw + dw) * kMCK * kMTO;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int n = (32 * wn + 8 * nt + g) ^ (t << 3);
          split_tf32(wt[t * kMTO + n], bhi[nt][0], blo[nt][0]);
          split_tf32(wt[(t + 4) * kMTO + n], bhi[nt][1], blo[nt][1]);
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            mma_tf32(part[mt][nt], alo[mt], bhi[nt]);
            mma_tf32(part[mt][nt], ahi[mt], blo[nt]);
            mma_tf32(part[mt][nt], ahi[mt], bhi[nt]);
          }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int f = 0; f < 4; ++f) acc[mt][nt][f] += part[mt][nt][f];
    if constexpr (S == 1) __syncthreads();  // the slot is read
  }

  const int shard = b / images;
  const int image = b % images;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int oh = oh0 + 2 * wm + (mt >> 1);
    if (oh >= ho) continue;
    const long long out_row =
        (static_cast<long long>(image) * shards + shard) * ho + oh;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int ow = ow0 + (mt & 1) * 16 + g + half * 8;
      if (ow >= wo) continue;
      float* const dst = out + (out_row * wo + ow) * o;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int oc = o0 + 32 * wn + 8 * nt + 2 * t;
        const float v0 = acc[mt][nt][2 * half];
        const float v1 = acc[mt][nt][2 * half + 1];
        if ((o & 1) == 0 && oc + 1 < o) {
          *reinterpret_cast<float2*>(dst + oc) = make_float2(v0, v1);
        } else {
          if (oc < o) dst[oc] = v0;
          if (oc + 1 < o) dst[oc + 1] = v1;
        }
      }
    }
  }
}

template <int S>
cudaError_t launch_mma(const float* x, const float* w, float* out, int blocks,
                       int images, int hp, int wp, int c, int kh, int kw,
                       int o, cudaStream_t stream) {
  const int ho = hp - kh + 1;
  const int wo = wp - kw + 1;
  const int tiles_w = (wo + kMTW - 1) / kMTW;
  const int tiles_h = (ho + kMTH - 1) / kMTH;
  const size_t smem = S * mma_stage_bytes(kh, kw);
  cudaError_t err = cudaFuncSetAttribute(
      conv_mma_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int vec_x = c % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_w = o % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid(tiles_h * tiles_w, (o + kMTO - 1) / kMTO, blocks);
  conv_mma_kernel<S><<<grid, kMThreads, smem, stream>>>(
      x, w, out, images, blocks / images, hp, wp, c, kh, kw, o, tiles_w,
      vec_x, vec_w);
  return cudaGetLastError();
}

bool bad_args(int blocks, int images, int hp, int wp, int c, int kh, int kw,
              int o) {
  return blocks < 0 || images <= 0 || blocks % images || c <= 0 || o <= 0 ||
         kh <= 0 || kw <= 0 || hp < kh || wp < kw;
}

}  // namespace

extern "C" {

// VALID convolution of `blocks` = shards * images contiguous f32 blocks
// x (shards, images, hp, wp, c) with the filter w (kh, kw, c, o) into out
// (images, shards * (hp - kh + 1), wp - kw + 1, o), on the CUDA cores.
// Launches on `stream`, does not synchronise, returns cudaGetLastError().
int spartan_conv_block(const void* x, const void* w, void* out, int blocks,
                       int images, int hp, int wp, int c, int kh, int kw,
                       int o, void* stream) {
  if (bad_args(blocks, images, hp, wp, c, kh, kw, o))
    return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;
  const int ho = hp - kh + 1;
  const int wo = wp - kw + 1;
  const int tiles_w = (wo + kTW - 1) / kTW;
  const int tiles_h = (ho + kTH - 1) / kTH;
  const size_t smem = simt_smem(kh, kw);
  cudaError_t err = cudaFuncSetAttribute(
      conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles_h * tiles_w, (o + kTO - 1) / kTO, blocks);
  conv_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), images, blocks / images, hp, wp, c, kh, kw, o,
      tiles_w);
  return cudaGetLastError();
}

// The same convolution as 3xTF32 on the tensor cores, with a ring of 2
// stages where shared memory holds them, else 1.
int spartan_conv_block_mma(const void* x, const void* w, void* out,
                           int blocks, int images, int hp, int wp, int c,
                           int kh, int kw, int o, void* stream) {
  if (bad_args(blocks, images, hp, wp, c, kh, kw, o))
    return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (2 * mma_stage_bytes(kh, kw) <= kSmemPerBlock)
    return launch_mma<2>(xf, wf, of, blocks, images, hp, wp, c, kh, kw, o, s);
  return launch_mma<1>(xf, wf, of, blocks, images, hp, wp, c, kh, kw, o, s);
}

}  // extern "C"
