// Direct NHWC convolution (the stencil's conv_block) for Hopper (sm_90a).
//
// conv_block replaces spartan_tpu/kernels/stencil.py::conv_block, the Pallas
// TPU kernel that halo_stencil runs on every H-shard's halo-padded block
// (StencilExpr: st.stencil on an operand whose H axis is tiled). For each
// block b it computes the VALID convolution
//   out[b, oh, ow, o] = sum_{dh, dw, c} x[b, oh + dh, ow + dw, c] * w[dh, dw, c, o]
// in f32. The TPU kernel runs KH*KW shifted-slice matrix products at
// Precision.HIGHEST over a grid of (image, H row block), accumulating in a
// VMEM tile; none of that carries over. Here every block of every logical
// H-shard is convolved in one launch, with FP32 FMAs on the CUDA cores: no
// TF32, no tensor cores.
//
// Design: a CTA computes an 8 x 32 tile of output pixels of one block for
// 64 output channels. Per chunk of CK input channels it stages the tile's
// input rows (8 + KH - 1) x (32 + KW - 1) x CK and the chunk's filter taps
// KH x KW x CK x 64 in shared memory (zero-filled past the edges of the
// image, of C and of O), then each of its 256 threads accumulates 8
// consecutive pixels x 8 output channels (64 sums) in registers. Every sum
// is accumulated in one fixed order -- channel chunk, then dh, then dw, then
// the channel within the chunk -- with no atomics, so each run gives the
// same bits. Ragged tiles (W not a multiple of 32, H not a multiple of 8,
// O not a multiple of 64) are masked at the store; padded channels hold
// zeros in both the input and the filter tile, so they add exact zeros.
// Blocks are laid out (shard, image); the output is written straight into
// (image, shard * ho + oh, ow, o), the layout of the unsharded result.
//
// Bound on an H100 SXM at the VGG-16 block-1 shapes (32 images, 224 x 224,
// 8 H-shards): conv1_2 (C = O = 64) does 2 * 32 * 224 * 224 * 64 * 576 =
// 118.4 GFLOP, 1.77 ms at 67 TFLOP/s FP32, and moves 0.86 GB (0.26 ms at
// 3.35 TB/s), so it is bound by operations; conv1_1 (C = 3) does 5.55
// GFLOP (0.083 ms) and moves 0.43 GB (0.129 ms), so it is bound by bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTH = 8;    // output rows per CTA
constexpr int kTW = 32;   // output columns per CTA
constexpr int kTO = 64;   // output channels per CTA
constexpr int kPix = 8;   // consecutive output columns per thread
constexpr int kOut = 8;   // consecutive output channels per thread
constexpr int kGroupsO = kTO / kOut;                  // 8
constexpr int kGroupsW = kTW / kPix;                  // 4
constexpr int kThreads = kTH * kGroupsW * kGroupsO;   // 256

template <int CK>
__global__ void __launch_bounds__(kThreads, 2)
conv_kernel(const float* __restrict__ x, const float* __restrict__ w,
            float* __restrict__ out, int images, int shards, int hp, int wp,
            int c, int kh, int kw, int o, int tiles_w) {
  extern __shared__ float4 smem4[];
  const int taps = kh * kw;
  const int thp = kTH + kh - 1;
  const int twp = kTW + kw - 1;
  const int plane = thp * twp;
  float* w_s = reinterpret_cast<float*>(smem4);  // [tap][CK][kTO]
  float* x_s = w_s + taps * CK * kTO;             // [CK][thp][twp]

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

  for (int c0 = 0; c0 < c; c0 += CK) {
    __syncthreads();  // the previous chunk's tiles are read
    for (int i = threadIdx.x; i < taps * CK * kTO; i += kThreads) {
      const int oo = i % kTO;
      const int cc = (i / kTO) % CK;
      const int tap = i / (kTO * CK);
      const int ci = c0 + cc;
      const int oi = o0 + oo;
      w_s[i] = (ci < c && oi < o)
                   ? w[(static_cast<long long>(tap) * c + ci) * o + oi]
                   : 0.f;
    }
    for (int i = threadIdx.x; i < CK * plane; i += kThreads) {
      const int cc = i % CK;  // fastest: neighbouring channels in memory
      const int q = (i / CK) % twp;
      const int r = i / (CK * twp);
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
        const float* wr = w_s + (dh * kw + dw) * CK * kTO + og * kOut;
#pragma unroll
        for (int cc = 0; cc < CK; ++cc) {
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

template <int CK>
cudaError_t launch(const float* x, const float* w, float* out, int blocks,
                   int images, int hp, int wp, int c, int kh, int kw, int o,
                   cudaStream_t stream) {
  const int ho = hp - kh + 1;
  const int wo = wp - kw + 1;
  const int tiles_w = (wo + kTW - 1) / kTW;
  const int tiles_h = (ho + kTH - 1) / kTH;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kh) * kw * CK * kTO +
                       static_cast<size_t>(CK) * (kTH + kh - 1) *
                           (kTW + kw - 1));
  cudaError_t err = cudaFuncSetAttribute(
      conv_kernel<CK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(tiles_h * tiles_w, (o + kTO - 1) / kTO, blocks);
  conv_kernel<CK><<<grid, kThreads, smem, stream>>>(
      x, w, out, images, blocks / images, hp, wp, c, kh, kw, o, tiles_w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// VALID convolution of `blocks` = shards * images contiguous f32 blocks
// x (shards, images, hp, wp, c) with the filter w (kh, kw, c, o) into out
// (images, shards * (hp - kh + 1), wp - kw + 1, o). Launches on `stream`,
// does not synchronise, returns cudaGetLastError().
int spartan_conv_block(const void* x, const void* w, void* out, int blocks,
                       int images, int hp, int wp, int c, int kh, int kw,
                       int o, void* stream) {
  if (blocks < 0 || images <= 0 || blocks % images || c <= 0 || o <= 0 ||
      kh <= 0 || kw <= 0 || hp < kh || wp < kw)
    return cudaErrorInvalidValue;
  if (blocks == 0) return cudaSuccess;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c <= 4) return launch<4>(xf, wf, of, blocks, images, hp, wp, c, kh, kw,
                               o, s);
  return launch<8>(xf, wf, of, blocks, images, hp, wp, c, kh, kw, o, s);
}

}  // extern "C"
