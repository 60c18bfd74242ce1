// Eval MBConv with BatchNorm folded, in one kernel.
//
// Replaces: cream_tpu/ops/pallas/mbconv.py `_kernel` (reached through
// `fused_mbconv`), which TinyViT's stage-0 MBConv calls on its eval path when
// the fused route is on.
//
// What it computes, per pixel of x (B, H, W, C), HID hidden channels:
//   h  = round(gelu(x . w1 + b1))                 1x1 expand, fp32 sums
//   h2 = round(gelu(bdw + sum_taps h[tap] * dw))  3x3 depthwise, pad 1; h is
//                                                 zero outside the image
//   y  = round(gelu((h2 . w2 + b2) + x))          1x1 project, residual
// where round() rounds to the input type and every sum and GELU is fp32
// (GELU's erf form for float32 inputs, its tanh form for bfloat16). The taps
// are taken in (dy, dx) order with separate multiply and add, as the plain
// version does. w1 (C, HID) and w2 (HID, C) are in the input type; dw
// (3, 3, HID) and the biases are fp32.
//
// What bounds it on Hopper: 4*C*HID + 18*HID flops per pixel (154 kflop at
// TinyViT-21M's C = 96, HID = 384) against 2*C values read and written:
// ~800 flop/byte in bf16, above the ridge, so the tensor cores' rate bounds
// the work. Its design: the TPU kernel kept one image's (H, W, HID) hidden
// tensor in VMEM; here that is 2.4 MB per image in bf16, ten times a Hopper
// SM's shared memory, so each block takes an 8x8 output tile of one image,
// holds its 10x10 halo of x in shared memory and walks HID in chunks of 32:
// expand the halo's chunk (recomputed on the halo, 100/64 of the expand
// work), zero it outside the image, apply the depthwise taps and GELU on the
// tile's 64 pixels, and add the chunk's share of the projection into fp32
// registers (64 x C per block). The hidden tensor never reaches device
// memory: x is read (with its halo) and y written once.
//   bfloat16: the two 1x1 products run on the tensor cores (mma.sync
//   m16n8k16, bf16 in, fp32 sums): the expand as 7 row tiles of 16 halo
//   pixels, one per warp, the projection as 4 x C/8 output tiles, 4 x C/16
//   per warp, kept in registers across the chunks. Shared-memory rows are
//   padded by 16 bytes so each fragment load hits 32 distinct banks.
//   float32: every product on CUDA cores in fp32 (the tensor cores' fp32
//   path would round the inputs to TF32); warps own pixel rows and lanes own
//   channels, so weight reads are conflict-free and activation reads are
//   broadcasts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace {

constexpr int kTile = 8;                     // output tile kTile x kTile pixels
constexpr int kHalo = kTile + 2;             // its halo's side
constexpr int kHaloPix = kHalo * kHalo;      // 100
constexpr int kTilePix = kTile * kTile;      // 64
constexpr int kChunk = 32;                   // hidden channels per pass
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kHaloRows = (kHaloPix + kWarps - 1) / kWarps;  // halo pixels per warp: 13
constexpr int kTileRows = kTilePix / kWarps;                  // tile pixels per warp: 8
// bfloat16 path: halo rows padded to 7 mma row tiles; row strides of the
// chunk-wide buffers (elements)
constexpr int kHaloPad = 112;
constexpr int kHS = kChunk + 8;              // hs (fp32), h2s and w2t (bf16)

// fp32 GELU with the JAX kernel's operation order and no contraction:
// 0.5*x*(1 + erf(x/sqrt(2))) if EXACT, else 0.5*x*(1 + tanh(c*(x + 0.044715*x^3)))
template <bool EXACT> __device__ __forceinline__ float gelu(float x) {
  const float half_x = __fmul_rn(0.5f, x);
  if (EXACT) return __fmul_rn(half_x, __fadd_rn(1.f, erff(__fmul_rn(x, 0.70710678118654752f))));
  const float cube = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, x), x), x);
  const float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(x, cube));
  return __fmul_rn(half_x, __fadd_rn(1.f, tanhf(inner)));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// halo pixel p = (p / kHalo, p % kHalo) is image pixel (ty0 - 1, tx0 - 1) + that
__device__ __forceinline__ bool halo_inside(int p, int ty0, int tx0, int H, int W) {
  const int y = ty0 - 1 + p / kHalo, x = tx0 - 1 + p % kHalo;
  return y >= 0 && y < H && x >= 0 && x < W;
}

// ---------------------------------------------------------------- float32

template <int C>
__global__ void __launch_bounds__(kThreads, 2)
mbconv_fp32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ dw,
                   const float* __restrict__ bdw, const float* __restrict__ w2,
                   const float* __restrict__ b2, float* __restrict__ out, int H, int W,
                   int HID, int tiles_w) {
  constexpr int kCols = C / 32;  // output channels per lane
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // kHaloPix x C, the halo of x
  float* w1s = xs + kHaloPix * C;               // C x kChunk
  float* w2s = w1s + C * kChunk;                // kChunk x C
  float* hs = w2s + kChunk * C;                 // kHaloPix x kChunk, expanded
  float* h2s = hs + kHaloPix * kChunk;          // kTilePix x kChunk, after the depthwise
  float* cs = h2s + kTilePix * kChunk;          // 9 taps, b1, bdw: 11 x kChunk

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ty0 = (blockIdx.x / tiles_w) * kTile, tx0 = (blockIdx.x % tiles_w) * kTile;
  const size_t img = static_cast<size_t>(blockIdx.y) * H * W;
  const float* xb = x + img * C;
  for (int i = tid; i < kHaloPix * C; i += kThreads) {
    const int p = i / C, c = i % C;
    const int y = ty0 - 1 + p / kHalo, xx = tx0 - 1 + p % kHalo;
    xs[i] = halo_inside(p, ty0, tx0, H, W) ? xb[(static_cast<size_t>(y) * W + xx) * C + c] : 0.f;
  }

  float acc[kTileRows][kCols];
#pragma unroll
  for (int r = 0; r < kTileRows; ++r)
#pragma unroll
    for (int k = 0; k < kCols; ++k) acc[r][k] = 0.f;

  for (int j0 = 0; j0 < HID; j0 += kChunk) {
    __syncthreads();  // the previous chunk is done with w1s, w2s, hs, h2s, cs
    for (int i = tid; i < C * kChunk; i += kThreads) {
      w1s[i] = w1[static_cast<size_t>(i / kChunk) * HID + j0 + i % kChunk];
      w2s[i] = w2[static_cast<size_t>(j0) * C + i];
    }
    for (int i = tid; i < 9 * kChunk; i += kThreads)
      cs[i] = dw[(i / kChunk) * HID + j0 + i % kChunk];
    if (tid < kChunk) {
      cs[9 * kChunk + tid] = b1[j0 + tid];
      cs[10 * kChunk + tid] = bdw[j0 + tid];
    }
    __syncthreads();

    // 1x1 expand of the halo, hidden channel j0 + lane
    {
      float a[kHaloRows];
#pragma unroll
      for (int r = 0; r < kHaloRows; ++r) a[r] = 0.f;
      for (int c = 0; c < C; c += 4) {
        const float wa = w1s[(c + 0) * kChunk + lane], wb = w1s[(c + 1) * kChunk + lane];
        const float wc = w1s[(c + 2) * kChunk + lane], wd = w1s[(c + 3) * kChunk + lane];
#pragma unroll
        for (int r = 0; r < kHaloRows; ++r) {
          const int p = warp + kWarps * r;
          if (p < kHaloPix) {
            const float4 xv = *reinterpret_cast<const float4*>(xs + p * C + c);
            a[r] = fmaf(xv.x, wa, a[r]);
            a[r] = fmaf(xv.y, wb, a[r]);
            a[r] = fmaf(xv.z, wc, a[r]);
            a[r] = fmaf(xv.w, wd, a[r]);
          }
        }
      }
      const float bias1 = cs[9 * kChunk + lane];
#pragma unroll
      for (int r = 0; r < kHaloRows; ++r) {
        const int p = warp + kWarps * r;
        if (p < kHaloPix)
          hs[p * kChunk + lane] = halo_inside(p, ty0, tx0, H, W)
                                      ? gelu<true>(__fadd_rn(a[r], bias1)) : 0.f;
      }
    }
    __syncthreads();

    // 3x3 depthwise on the tile's pixels, then GELU
    {
      float taps[9];
#pragma unroll
      for (int t = 0; t < 9; ++t) taps[t] = cs[t * kChunk + lane];
      const float bias_dw = cs[10 * kChunk + lane];
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) {
        const int p = warp + kWarps * r, py = p / kTile, px = p % kTile;
        float s = bias_dw;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            s = __fadd_rn(s, __fmul_rn(hs[((py + dy) * kHalo + px + dx) * kChunk + lane],
                                       taps[3 * dy + dx]));
        h2s[p * kChunk + lane] = gelu<true>(s);
      }
    }
    __syncthreads();

    // the chunk's share of the 1x1 projection, output channels lane + 32k
    for (int jj = 0; jj < kChunk; jj += 4) {
      float wv[4][kCols];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int k = 0; k < kCols; ++k) wv[q][k] = w2s[(jj + q) * C + lane + 32 * k];
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) {
        const float4 hv =
            *reinterpret_cast<const float4*>(h2s + (warp + kWarps * r) * kChunk + jj);
#pragma unroll
        for (int k = 0; k < kCols; ++k) {
          acc[r][k] = fmaf(hv.x, wv[0][k], acc[r][k]);
          acc[r][k] = fmaf(hv.y, wv[1][k], acc[r][k]);
          acc[r][k] = fmaf(hv.z, wv[2][k], acc[r][k]);
          acc[r][k] = fmaf(hv.w, wv[3][k], acc[r][k]);
        }
      }
    }
  }

  // + b2 + x, GELU, store the tile's pixels that lie in the image
  float* ob = out + img * C;
#pragma unroll
  for (int r = 0; r < kTileRows; ++r) {
    const int p = warp + kWarps * r, py = p / kTile, px = p % kTile;
    const int y = ty0 + py, xx = tx0 + px;
    if (y >= H || xx >= W) continue;
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int c = lane + 32 * k;
      const float res = xs[((py + 1) * kHalo + px + 1) * C + c];
      ob[(static_cast<size_t>(y) * W + xx) * C + c] =
          gelu<true>(__fadd_rn(__fadd_rn(acc[r][k], b2[c]), res));
    }
  }
}

// ---------------------------------------------------------------- bfloat16

using tc::ld32;
using tc::mma_bf16;

template <int C>
__global__ void __launch_bounds__(kThreads, 2)
mbconv_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ dw,
                   const float* __restrict__ bdw, const __nv_bfloat16* __restrict__ w2,
                   const float* __restrict__ b2, __nv_bfloat16* __restrict__ out, int H, int W,
                   int HID, int tiles_w) {
  constexpr int XS = C + 8;           // row stride of xs and w1t (elements)
  constexpr int kNT = C / 16;         // projection n-tiles (8 channels) per warp
  extern __shared__ float4 smem4[];
  float* hs = reinterpret_cast<float*>(smem4);      // kHaloPix x kHS fp32, expanded
  float* cs = hs + kHaloPix * kHS;                  // 9 taps, b1, bdw: 11 x kChunk
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(cs + 11 * kChunk);  // kHaloPad x XS
  __nv_bfloat16* w1t = xs + kHaloPad * XS;          // kChunk x XS: w1t[j][c] = w1[c][j0 + j]
  __nv_bfloat16* w2t = w1t + kChunk * XS;           // C x kHS: w2t[c][j] = w2[j0 + j][c]
  __nv_bfloat16* h2s = w2t + C * kHS;               // kTilePix x kHS, after the depthwise

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;         // mma fragment coordinates
  const int ty0 = (blockIdx.x / tiles_w) * kTile, tx0 = (blockIdx.x % tiles_w) * kTile;
  const size_t img = static_cast<size_t>(blockIdx.y) * H * W;
  // the halo of x, 16 bytes at a time; rows outside the image and the padding
  // rows up to kHaloPad are zero
  {
    const uint4* xb = reinterpret_cast<const uint4*>(x + img * C);
    constexpr int kVec = C / 8;
    for (int i = tid; i < kHaloPad * kVec; i += kThreads) {
      const int p = i / kVec, v = i % kVec;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (p < kHaloPix && halo_inside(p, ty0, tx0, H, W)) {
        const int y = ty0 - 1 + p / kHalo, xx = tx0 - 1 + p % kHalo;
        val = xb[(static_cast<size_t>(y) * W + xx) * kVec + v];
      }
      *reinterpret_cast<uint4*>(xs + p * XS + 8 * v) = val;
    }
  }

  float acc[kNT][4];
#pragma unroll
  for (int t = 0; t < kNT; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][i] = 0.f;
  const int mt = warp % 4, n0 = (warp / 4) * kNT;   // this warp's projection tiles

  for (int j0 = 0; j0 < HID; j0 += kChunk) {
    __syncthreads();  // the previous chunk is done with w1t, w2t, hs, h2s, cs
    for (int i = tid; i < C * kChunk; i += kThreads) {
      const int c = i / kChunk, j = i % kChunk;
      w1t[j * XS + c] = w1[static_cast<size_t>(c) * HID + j0 + j];
      const int jj = i / C, cc = i % C;
      w2t[cc * kHS + jj] = w2[static_cast<size_t>(j0 + jj) * C + cc];
    }
    for (int i = tid; i < 9 * kChunk; i += kThreads)
      cs[i] = dw[(i / kChunk) * HID + j0 + i % kChunk];
    if (tid < kChunk) {
      cs[9 * kChunk + tid] = b1[j0 + tid];
      cs[10 * kChunk + tid] = bdw[j0 + tid];
    }
    __syncthreads();

    // 1x1 expand of the halo: warp w < 7 takes halo rows 16w .. 16w + 15
    if (warp < kHaloPad / 16) {
      const int r0 = warp * 16;
      float d[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) d[t][i] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < C; k0 += 16) {
        const __nv_bfloat16* ar = xs + (r0 + gid) * XS + k0 + 2 * tig;
        const uint32_t a[4] = {ld32(ar), ld32(ar + 8 * XS), ld32(ar + 8), ld32(ar + 8 * XS + 8)};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const __nv_bfloat16* br = w1t + (8 * t + gid) * XS + k0 + 2 * tig;
          mma_bf16(d[t], a, ld32(br), ld32(br + 8));
        }
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = 8 * t + 2 * tig;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = r0 + gid + 8 * half;
          if (p >= kHaloPix) continue;
          const bool in = halo_inside(p, ty0, tx0, H, W);
          float2 h;
          h.x = in ? round_bf16(gelu<false>(__fadd_rn(d[t][2 * half], cs[9 * kChunk + j]))) : 0.f;
          h.y = in ? round_bf16(gelu<false>(__fadd_rn(d[t][2 * half + 1],
                                                      cs[9 * kChunk + j + 1]))) : 0.f;
          *reinterpret_cast<float2*>(hs + p * kHS + j) = h;
        }
      }
    }
    __syncthreads();

    // 3x3 depthwise on the tile's pixels, hidden channel j0 + lane, then GELU
    {
      float taps[9];
#pragma unroll
      for (int t = 0; t < 9; ++t) taps[t] = cs[t * kChunk + lane];
      const float bias_dw = cs[10 * kChunk + lane];
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) {
        const int p = warp + kWarps * r, py = p / kTile, px = p % kTile;
        float s = bias_dw;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
            s = __fadd_rn(s, __fmul_rn(hs[((py + dy) * kHalo + px + dx) * kHS + lane],
                                       taps[3 * dy + dx]));
        h2s[p * kHS + lane] = __float2bfloat16(gelu<false>(s));
      }
    }
    __syncthreads();

    // the chunk's share of the 1x1 projection: rows 16*mt .., n-tiles n0 ..
#pragma unroll
    for (int k0 = 0; k0 < kChunk; k0 += 16) {
      const __nv_bfloat16* ar = h2s + (16 * mt + gid) * kHS + k0 + 2 * tig;
      const uint32_t a[4] = {ld32(ar), ld32(ar + 8 * kHS), ld32(ar + 8), ld32(ar + 8 * kHS + 8)};
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
        const __nv_bfloat16* br = w2t + (8 * (n0 + t) + gid) * kHS + k0 + 2 * tig;
        mma_bf16(acc[t], a, ld32(br), ld32(br + 8));
      }
    }
  }

  // + b2 + x, GELU, store the tile's pixels that lie in the image
  __nv_bfloat16* ob = out + img * C;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int p = 16 * mt + gid + 8 * half, py = p / kTile, px = p % kTile;
    const int y = ty0 + py, xx = tx0 + px;
    if (y >= H || xx >= W) continue;
    const __nv_bfloat16* res = xs + ((py + 1) * kHalo + px + 1) * XS;
#pragma unroll
    for (int t = 0; t < kNT; ++t) {
      const int c = 8 * (n0 + t) + 2 * tig;
      const float v0 = __fadd_rn(__fadd_rn(acc[t][2 * half], b2[c]), __bfloat162float(res[c]));
      const float v1 =
          __fadd_rn(__fadd_rn(acc[t][2 * half + 1], b2[c + 1]), __bfloat162float(res[c + 1]));
      *reinterpret_cast<__nv_bfloat162*>(ob + (static_cast<size_t>(y) * W + xx) * C + c) =
          __floats2bfloat162_rn(gelu<false>(v0), gelu<false>(v1));
    }
  }
}

// ---------------------------------------------------------------- launch

template <int C>
size_t smem_bytes(bool bf16) {
  if (bf16)
    return sizeof(float) * (kHaloPix * kHS + 11 * kChunk) +
           sizeof(__nv_bfloat16) * ((kHaloPad + kChunk) * (C + 8) + (C + kTilePix) * kHS);
  return sizeof(float) * (static_cast<size_t>(kHaloPix) * C + 2 * C * kChunk +
                          kHaloPix * kChunk + kTilePix * kChunk + 11 * kChunk);
}

template <typename Kernel, typename T>
cudaError_t run(Kernel kern, size_t smem, const void* x, const void* w1, const float* b1,
                const float* dw, const float* bdw, const void* w2, const float* b2, void* out,
                int B, int H, int W, int HID, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int tiles_h = (H + kTile - 1) / kTile, tiles_w = (W + kTile - 1) / kTile;
  const dim3 grid(tiles_h * tiles_w, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), b1, dw, bdw,
      static_cast<const T*>(w2), b2, static_cast<T*>(out), H, W, HID, tiles_w);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch(bool bf16, const void* x, const void* w1, const float* b1, const float* dw,
                   const float* bdw, const void* w2, const float* b2, void* out, int B, int H,
                   int W, int HID, cudaStream_t s) {
  if (bf16)
    return run<decltype(&mbconv_bf16_kernel<C>), __nv_bfloat16>(
        mbconv_bf16_kernel<C>, smem_bytes<C>(true), x, w1, b1, dw, bdw, w2, b2, out, B, H, W,
        HID, s);
  return run<decltype(&mbconv_fp32_kernel<C>), float>(
      mbconv_fp32_kernel<C>, smem_bytes<C>(false), x, w1, b1, dw, bdw, w2, b2, out, B, H, W,
      HID, s);
}

}  // namespace

// dtype: 0 float32 (erf GELU, CUDA cores), 1 bfloat16 (tanh GELU, tensor
// cores; x 16-byte aligned). C in {32, 64, 96, 128}, HID a multiple of 32.
// Returns a cudaError_t (0 on success).
extern "C" int cream_mbconv_fwd(const void* x, const void* w1, const void* b1, const void* dw,
                                const void* bdw, const void* w2, const void* b2, void* out,
                                int B, int H, int W, int C, int HID, int dtype, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || HID < kChunk || HID % kChunk || dtype < 0 ||
      dtype > 1 || (dtype == 1 && reinterpret_cast<uintptr_t>(x) % 16))
    return cudaErrorInvalidValue;
  const bool bf16 = dtype == 1;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fb1 = static_cast<const float*>(b1);
  const float* fdw = static_cast<const float*>(dw);
  const float* fbdw = static_cast<const float*>(bdw);
  const float* fb2 = static_cast<const float*>(b2);
  switch (C) {
    case 32: return launch<32>(bf16, x, w1, fb1, fdw, fbdw, w2, fb2, out, B, H, W, HID, s);
    case 64: return launch<64>(bf16, x, w1, fb1, fdw, fbdw, w2, fb2, out, B, H, W, HID, s);
    case 96: return launch<96>(bf16, x, w1, fb1, fdw, fbdw, w2, fb2, out, B, H, W, HID, s);
    case 128: return launch<128>(bf16, x, w1, fb1, fdw, fbdw, w2, fb2, out, B, H, W, HID, s);
  }
  return cudaErrorInvalidValue;
}
