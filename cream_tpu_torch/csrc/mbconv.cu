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
// ~800 flop/byte in bf16, above the ridge. The tensor cores' rate gives
// the roofline bound, but the work that must stay on the CUDA cores sets a
// higher floor: per hidden element the depthwise's 18 fp32 operations and
// two fp32 GELUs. The TPU kernel kept one image's (H, W, HID) hidden tensor
// in VMEM; here that is 2.4 MB per image in bf16, ten times a Hopper SM's
// shared memory, so a block takes one output tile of one image, holds the
// tile's halo of x in shared memory and walks HID in chunks of 32: expand
// the halo's chunk (recomputed on the halo), zero it outside the image,
// apply the depthwise taps and GELU on the tile's pixels, and add the
// chunk's share of the projection into fp32 registers. The hidden tensor
// never reaches device memory: x is read (with its halo) and y written once.
// The tile is 8x8 for float32 and 14x14 for bfloat16; the wrapper's
// `tile_plan` gives the grid of tiles, which the entry point launches as it
// is, one block a tile, once it has checked that the grid covers the map.
//
// bfloat16, one block of 16 warps an SM (158 KB of shared memory at C = 96,
// 128 registers a thread):
//   - 14x14 output tiles with a 16x16 halo: 256 halo pixels are exactly 16
//     mma row tiles (m16n8k16, bf16 in, fp32 sums), one halo row per warp,
//     so the expand recomputes 256/196 = 1.31x the work the tile needs.
//     56x56 maps cut into 4x4 tiles; ragged maps are masked.
//   - x's halo arrives by 16-byte cp.async with zero fill outside the image
//     and stays for the residual. w1's and w2's slices are copied by
//     cp.async as they lie in memory (row-major (k, n) for both products;
//     ldmatrix.trans reads their B fragments), with the taps and biases,
//     into a ring of two slots, one region ahead (below).
//   - The hidden chunks (h, then h2) live in shared memory as bf16, the
//     type they are rounded to, two buffers each.
//   - A block walks HID in regions: region b expands chunk b + 1, applies
//     the depthwise to chunk b and projects chunk b - 1, all from buffers
//     the previous region filled, so one block barrier a region (a chunk)
//     separates every producer from its consumer, and the ring's wait for
//     region b + 1's slices folds into it. Half the warps take the expand
//     first and half the depthwise, so the tensor cores, the MUFU and the
//     fp32 lanes work at once.
//   - The depthwise walks half columns: a lane takes a channel pair, a
//     thread 7 output rows of one column, reading 9 halo rows once each and
//     keeping three running sums (the K7 forward's scheme), so each output
//     still takes its nine taps in (dy, dx) order, multiply and add apart.
//   - The projection's 14 row tiles (an output row of 16 pixels, 14 real)
//     x C/8 column tiles sit in registers across the chunks, 2 x C/16 a
//     warp on 14 warps.
//   - GELU's tanh is 1 - 2 / (1 + e^(2|u|)) with u's sign, the exponent
//     2|u| log2(e) = |x| (c1 x^2 + c0) by one multiply and one FMA, then
//     one ex2.approx and one rcp.approx: |t - tanh(u)| < 2^-21 for every
//     u (tests/test_torch_mbconv.py emulates it with both approximations at
//     their error bounds; libdevice tanhf is within 2 ulps), never
//     tanh.approx.f32, whose 2^-11 relative error would move roundings of
//     h. GELU uses t only as 1 + t: for u < 0 that is q = 2 / (1 + e)
//     rounded to a multiple of 2^-24, as tanhf's 1 + t rounds.
// float32: every product on CUDA cores in fp32 (the tensor cores' fp32 path
// would round the inputs to TF32), 8x8 tiles with a 10x10 halo, 8 warps;
// warps own pixel rows and lanes own channels, so weight reads are
// conflict-free and activation reads are broadcasts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "cp_async.cuh"

namespace {

using cpa::cp_async16;
using cpa::cp_async_commit;
using cpa::cp_async_wait;

// float32 path
constexpr int kTile = 8;                     // output tile kTile x kTile pixels
constexpr int kHalo = kTile + 2;             // its halo's side
constexpr int kHaloPix = kHalo * kHalo;      // 100
constexpr int kTilePix = kTile * kTile;      // 64
constexpr int kChunk = 32;                   // hidden channels per pass (both paths)
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kHaloRows = (kHaloPix + kWarps - 1) / kWarps;  // halo pixels per warp: 13
constexpr int kTileRows = kTilePix / kWarps;                  // tile pixels per warp: 8

// bfloat16 path
namespace b16 {
constexpr int kTile = 14;                    // output tile kTile x kTile pixels
constexpr int kHalo = kTile + 2;             // its halo's side: one mma row tile a halo row
constexpr int kHaloPix = kHalo * kHalo;      // 256
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kWork = 14;                    // warps in the depthwise and the projection
constexpr int kRows = kTile / 2;             // output rows of a depthwise walk
constexpr int kHS = kChunk + 8;              // row stride of hs, h2s and w1s (elements)
static_assert(kHalo == kWarps, "the expand takes one 16-pixel halo row a warp");
static_assert(kHalo == 16, "a halo row is one m16 row tile");
static_assert(2 * kRows == kTile && kWork == 2 * 7, "two depthwise walks of 7 columns");
}  // namespace b16

// 2 log2(e) sqrt(2 / pi) and 0.044715 times it: e^(2|u|) for GELU's
// u = sqrt(2/pi) (x + 0.044715 x^3) is 2^(|x| (kE2 + kE2c x^2))
constexpr float kE2 = 2.3022082f;
constexpr float kE2c = 0.10294324f;

// tanh-form GELU's t = tanh(u) (see the note at the top): q = 2 / (1 +
// e^(2|u|)) by ex2.approx and rcp.approx, t = copysign(1 - q, x)
__device__ __forceinline__ float tanh_of(float x) {
  float e, r;
  const float a = __fmul_rn(fabsf(x), __fmaf_rn(__fmul_rn(kE2c, x), x, kE2));
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"(a));
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(__fadd_rn(1.f, e)));
  return copysignf(__fmaf_rn(-2.f, r, 1.f), x);    // 2r is exact: one rounding, as 1 - q
}

// fp32 GELU 0.5*x*(1 + erf(x/sqrt(2))) if EXACT, with the JAX kernel's
// operation order and no contraction; else 0.5*x*(1 + t), t = tanh_of(x)
template <bool EXACT> __device__ __forceinline__ float gelu(float x) {
  const float half_x = __fmul_rn(0.5f, x);
  if (EXACT) return __fmul_rn(half_x, __fadd_rn(1.f, erff(__fmul_rn(x, 0.70710678118654752f))));
  return __fmul_rn(half_x, __fadd_rn(1.f, tanh_of(x)));
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

using tc::ldsm_x4;
using tc::ldsm_x4_trans;
using tc::mma_bf16;
using tc::pack_bf16;

__device__ __forceinline__ float2 bf16x2_at(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <int C>
__host__ __device__ constexpr int b16_slot() {   // bf16 elements of a ring slot: w1s, then w2s
  return C * b16::kHS + kChunk * (C + 8);
}

template <int C>
__global__ void __launch_bounds__(b16::kThreads, 1)
mbconv_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
                   const float* __restrict__ b1, const float* __restrict__ dw,
                   const float* __restrict__ bdw, const __nv_bfloat16* __restrict__ w2,
                   const float* __restrict__ b2, __nv_bfloat16* __restrict__ out, int H, int W,
                   int HID, int tiles_w) {
  constexpr int kTile = b16::kTile, kHalo = b16::kHalo, kHaloPix = b16::kHaloPix;
  constexpr int kThreads = b16::kThreads, kWork = b16::kWork, kRows = b16::kRows;
  constexpr int kHS = b16::kHS;
  constexpr int XS = C + 8;            // row stride of xs and w2s (elements)
  constexpr int kNT = C / 16;          // projection column tiles a warp
  constexpr int kSlot = b16_slot<C>();
  constexpr int kHBuf = kHaloPix * kHS, kH2Buf = kTile * kHalo * kHS;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem4);  // kHaloPix x XS: x's halo
  __nv_bfloat16* hs = xs + kHaloPix * XS;        // 2 x kHaloPix x kHS: expanded chunks
  __nv_bfloat16* h2s = hs + 2 * kHBuf;           // 2 x kTile x kHalo rows x kHS: depthwise out
  __nv_bfloat16* ring = h2s + 2 * kH2Buf;        // 2 x (w1s, w2s)
  float* cring = reinterpret_cast<float*>(ring + 2 * kSlot);    // 2 x 11 x kChunk

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gid = lane / 4, tig = lane % 4;      // mma fragment coordinates
  const int ty0 = (blockIdx.x / tiles_w) * kTile, tx0 = (blockIdx.x % tiles_w) * kTile;
  const size_t img = static_cast<size_t>(blockIdx.y) * H * W;
  const int chunks = HID / kChunk;

  // Region b of the walk (b = -1 .. chunks) expands chunk b + 1, applies
  // the depthwise to chunk b and projects chunk b - 1; its operands, bundle
  // b, sit in ring slot b & 1: w1s[c][n] = w1[c][32 (b + 1) + n] with b1's
  // slice in cs row 9, the taps dw[dy][dx][32 b ..] in cs rows 0-8 with
  // bdw's slice in row 10, w2s[k][c] = w2[32 (b - 1) + k][c]. One commit
  // group a bundle.
  auto issue = [&](int b) {
    if (b <= chunks) {
      __nv_bfloat16* w1s = ring + (b & 1) * kSlot;
      __nv_bfloat16* w2s = w1s + C * kHS;
      float* cs = cring + (b & 1) * 11 * kChunk;
      if (b + 1 < chunks) {
        const int j0 = (b + 1) * kChunk;
        for (int i = tid; i < C * 4; i += kThreads)
          cp_async16(w1s + (i / 4) * kHS + 8 * (i % 4),
                     w1 + static_cast<size_t>(i / 4) * HID + j0 + 8 * (i % 4), true);
        if (tid < 8) cp_async16(cs + 9 * kChunk + 4 * tid, b1 + j0 + 4 * tid, true);
      }
      if (b >= 0 && b < chunks && tid >= 32 && tid < 32 + 10 * 8) {
        const int r = (tid - 32) / 8, v = (tid - 32) % 8;
        const float* src = r < 9 ? dw + static_cast<size_t>(r) * HID : bdw;
        cp_async16(cs + (r < 9 ? r : 10) * kChunk + 4 * v, src + b * kChunk + 4 * v, true);
      }
      if (b >= 1) {
        const int j0 = (b - 1) * kChunk;
        for (int i = tid; i < kChunk * (C / 8); i += kThreads)
          cp_async16(w2s + (i / (C / 8)) * XS + 8 * (i % (C / 8)),
                     w2 + static_cast<size_t>(j0 + i / (C / 8)) * C + 8 * (i % (C / 8)), true);
      }
    }
    cp_async_commit();
  };

  // 1x1 expand of chunk k into hs[k & 1]: warp w takes halo row w (16
  // pixels) x the chunk's 32 hidden channels; h is zero outside the image
  auto expand = [&](int k, const __nv_bfloat16* w1s, const float* cs) {
    float d[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[t][e] = 0.f;
#pragma unroll
    for (int k0 = 0; k0 < C; k0 += 16) {
      uint32_t a[4], b[4];
      ldsm_x4(a, xs + (16 * warp) * XS + k0, XS, lane);
      ldsm_x4_trans(b, w1s + k0 * kHS, kHS, lane);
      mma_bf16(d[0], a, b[0], b[1]);
      mma_bf16(d[1], a, b[2], b[3]);
      ldsm_x4_trans(b, w1s + k0 * kHS + 16, kHS, lane);
      mma_bf16(d[2], a, b[0], b[1]);
      mma_bf16(d[3], a, b[2], b[3]);
    }
    __nv_bfloat16* hk = hs + (k & 1) * kHBuf;
    const int y = ty0 - 1 + warp;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int hx = gid + 8 * half, xx = tx0 - 1 + hx;
      const bool in = y >= 0 && y < H && xx >= 0 && xx < W;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int n = 8 * t + 2 * tig;
        uint32_t h = 0u;
        if (in) {
          const float2 bb = *reinterpret_cast<const float2*>(cs + 9 * kChunk + n);
          h = pack_bf16(gelu<false>(__fadd_rn(d[t][2 * half], bb.x)),
                        gelu<false>(__fadd_rn(d[t][2 * half + 1], bb.y)));
        }
        *reinterpret_cast<uint32_t*>(hk + (16 * warp + hx) * kHS + n) = h;
      }
    }
  };

  // 3x3 depthwise of chunk k from hs[k & 1] into h2s[k & 1], then GELU
  // (warps below kWork): lanes q = channel pair; rows kRows * part .. +
  // kRows - 1 of column ox, the two half-warps' columns 4 apart (80 words
  // apart in hs: no bank conflict) where the 14 columns allow. Halo row
  // r0 + r gives the tap row dy = 0 of output r0 + r, dy = 1 of r0 + r - 1
  // and dy = 2 of r0 + r - 2: three running sums.
  const int part = warp / 7, jw = warp % 7, q = lane % 16, hw = lane / 16;
  const int ox = jw < 4 ? jw + 4 * hw : (jw < 6 ? jw + 4 + 4 * hw : 10 + hw);
  auto depthwise = [&](int k, const float* cs) {
    float2 tap[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) tap[t] = *reinterpret_cast<const float2*>(cs + t * kChunk + 2 * q);
    const float2 bias = *reinterpret_cast<const float2*>(cs + 10 * kChunk + 2 * q);
    const int r0 = kRows * part;
    const __nv_bfloat16* hp = hs + (k & 1) * kHBuf + (r0 * kHalo + ox) * kHS + 2 * q;
    __nv_bfloat16* op = h2s + (k & 1) * kH2Buf + (r0 * kHalo + ox) * kHS + 2 * q;
    float2 s0 = bias, s1 = bias, s2 = bias;   // outputs r, r - 1, r - 2
#pragma unroll
    for (int r = 0; r < kRows + 2; ++r) {
      float2 v[3];
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) v[dx] = bf16x2_at(hp + (r * kHalo + dx) * kHS);
      s0 = bias;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        if (r < kRows) {
          s0.x = __fadd_rn(s0.x, __fmul_rn(v[dx].x, tap[dx].x));
          s0.y = __fadd_rn(s0.y, __fmul_rn(v[dx].y, tap[dx].y));
        }
        if (r >= 1 && r <= kRows) {
          s1.x = __fadd_rn(s1.x, __fmul_rn(v[dx].x, tap[3 + dx].x));
          s1.y = __fadd_rn(s1.y, __fmul_rn(v[dx].y, tap[3 + dx].y));
        }
        if (r >= 2) {
          s2.x = __fadd_rn(s2.x, __fmul_rn(v[dx].x, tap[6 + dx].x));
          s2.y = __fadd_rn(s2.y, __fmul_rn(v[dx].y, tap[6 + dx].y));
        }
      }
      if (r >= 2)
        *reinterpret_cast<uint32_t*>(op + (r - 2) * kHalo * kHS) =
            pack_bf16(gelu<false>(s2.x), gelu<false>(s2.y));
      s2 = s1;
      s1 = s0;
    }
  };

  // chunk k's share of the 1x1 projection from h2s[k & 1] (warps below
  // kWork): output rows 2 mp, 2 mp + 1, column tiles kNT nh .. + kNT - 1,
  // summed in registers across the chunks
  const int mp = warp % 7, nh = warp / 7;
  float acc[2][kNT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int t = 0; t < kNT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][t][e] = 0.f;
  auto project = [&](int k, const __nv_bfloat16* w2s) {
    const __nv_bfloat16* h2k = h2s + (k & 1) * kH2Buf;
#pragma unroll
    for (int k0 = 0; k0 < kChunk; k0 += 16) {
      uint32_t a[2][4];
      ldsm_x4(a[0], h2k + (2 * mp * kHalo) * kHS + k0, kHS, lane);
      ldsm_x4(a[1], h2k + ((2 * mp + 1) * kHalo) * kHS + k0, kHS, lane);
#pragma unroll
      for (int t = 0; t < kNT; t += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, w2s + k0 * XS + 8 * (kNT * nh + t), XS, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_bf16(acc[i][t], a[i], b[0], b[1]);
          mma_bf16(acc[i][t + 1], a[i], b[2], b[3]);
        }
      }
    }
  };

  // x's halo, 16 bytes a copy, zero outside the image; it stays for the
  // residual. It shares bundle -1's commit group.
  {
    const __nv_bfloat16* xb = x + img * C;
    constexpr int kVec = C / 8;
    for (int i = tid; i < kHaloPix * kVec; i += kThreads) {
      const int p = i / kVec, v = i % kVec;
      const int y = ty0 - 1 + p / kHalo, xx = tx0 - 1 + p % kHalo;
      const bool in = y >= 0 && y < H && xx >= 0 && xx < W;
      cp_async16(xs + p * XS + 8 * v, in ? xb + (static_cast<size_t>(y) * W + xx) * C + 8 * v : xb,
                 in);
    }
  }
  issue(-1);
  // the last two columns of each output row in h2s (pixels 14, 15 of its
  // row tile) are never written: zero them once
  for (int i = tid; i < 2 * kTile * 2 * (kHS / 2); i += kThreads) {
    const int r = i / (kHS / 2), w = i % (kHS / 2);
    reinterpret_cast<uint32_t*>(h2s + (r / 2) * kHalo * kHS + (kTile + r % 2) * kHS)[w] = 0u;
  }
  cp_async_wait<0>();
  __syncthreads();

  // The walk: one block barrier a region. Half the warps take the expand
  // first and half the depthwise, so the tensor cores, the MUFU and the
  // fp32 lanes work at once.
  const bool dw_first = warp >= 8;
  for (int b = -1; b <= chunks; ++b) {
    issue(b + 1);     // into the slot bundle b - 1 used
    const __nv_bfloat16* w1s = ring + (b & 1) * kSlot;
    const __nv_bfloat16* w2s = w1s + C * kHS;
    const float* cs = cring + (b & 1) * 11 * kChunk;
    const bool do_dw = b >= 0 && b < chunks && warp < kWork;
    if (dw_first && do_dw) depthwise(b, cs);
    if (b + 1 < chunks) expand(b + 1, w1s, cs);
    if (!dw_first && do_dw) depthwise(b, cs);
    if (b >= 1 && warp < kWork) project(b - 1, w2s);
    cp_async_wait<0>();   // bundle b + 1
    __syncthreads();
  }

  // + b2 + x, GELU, store the tile's pixels that lie in the image
  if (warp < kWork) {
    __nv_bfloat16* ob = out + img * C;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int oy = 2 * mp + i, y = ty0 + oy;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ox2 = gid + 8 * half, xx = tx0 + ox2;
        if (y >= H || ox2 >= kTile || xx >= W) continue;
        const __nv_bfloat16* res = xs + ((oy + 1) * kHalo + ox2 + 1) * XS;
#pragma unroll
        for (int t = 0; t < kNT; ++t) {
          const int c = 8 * (kNT * nh + t) + 2 * tig;
          const float2 bb = *reinterpret_cast<const float2*>(b2 + c);
          const float2 r = bf16x2_at(res + c);
          const float v0 = __fadd_rn(__fadd_rn(acc[i][t][2 * half], bb.x), r.x);
          const float v1 = __fadd_rn(__fadd_rn(acc[i][t][2 * half + 1], bb.y), r.y);
          *reinterpret_cast<uint32_t*>(ob + (static_cast<size_t>(y) * W + xx) * C + c) =
              pack_bf16(gelu<false>(v0), gelu<false>(v1));
        }
      }
    }
  }
}

// ---------------------------------------------------------------- launch

template <int C>
size_t smem_bytes(bool bf16) {
  if (bf16)
    return sizeof(__nv_bfloat16) * (b16::kHaloPix * (C + 8) +
                                    2 * (b16::kHaloPix + b16::kTile * b16::kHalo) * b16::kHS +
                                    2 * b16_slot<C>()) +
           sizeof(float) * 2 * 11 * kChunk;
  return sizeof(float) * (static_cast<size_t>(kHaloPix) * C + 2 * C * kChunk +
                          kHaloPix * kChunk + kTilePix * kChunk + 11 * kChunk);
}

template <typename Kernel, typename T>
cudaError_t run(Kernel kern, int threads, size_t smem, const void* x, const void* w1,
                const float* b1, const float* dw, const float* bdw, const void* w2,
                const float* b2, void* out, int B, int H, int W, int HID, int tiles_h,
                int tiles_w, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid(tiles_h * tiles_w, B);
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), b1, dw, bdw,
      static_cast<const T*>(w2), b2, static_cast<T*>(out), H, W, HID, tiles_w);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch(bool bf16, const void* x, const void* w1, const float* b1, const float* dw,
                   const float* bdw, const void* w2, const float* b2, void* out, int B, int H,
                   int W, int HID, int tiles_h, int tiles_w, cudaStream_t s) {
  if (bf16)
    return run<decltype(&mbconv_bf16_kernel<C>), __nv_bfloat16>(
        mbconv_bf16_kernel<C>, b16::kThreads, smem_bytes<C>(true), x, w1, b1, dw, bdw, w2, b2,
        out, B, H, W, HID, tiles_h, tiles_w, s);
  return run<decltype(&mbconv_fp32_kernel<C>), float>(
      mbconv_fp32_kernel<C>, kThreads, smem_bytes<C>(false), x, w1, b1, dw, bdw, w2, b2, out, B,
      H, W, HID, tiles_h, tiles_w, s);
}

// whether n tiles of side `tile` cover `len` pixels, the last one ragged
bool covers(int n, int tile, int len) { return n >= 1 && (n - 1) * tile < len && len <= n * tile; }

}  // namespace

// dtype: 0 float32 (erf GELU, CUDA cores, 8x8 tiles), 1 bfloat16 (tanh GELU,
// tensor cores, 14x14 tiles); tiles_h x tiles_w: the wrapper's `tile_plan`
// grid, launched as (tiles_h * tiles_w, B) blocks, which must cover the map
// in the dtype's tiles. C in {32, 64, 96, 128}, HID a multiple of 32; the
// bfloat16 path copies its operands 16 bytes at a time (all 16-byte
// aligned). Returns a cudaError_t (0 on success).
extern "C" int cream_mbconv_fwd(const void* x, const void* w1, const void* b1, const void* dw,
                                const void* bdw, const void* w2, const void* b2, void* out,
                                int B, int H, int W, int C, int HID, int dtype, int tiles_h,
                                int tiles_w, void* stream) {
  const bool bf16 = dtype == 1;
  const int tile = bf16 ? b16::kTile : kTile;
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (B < 1 || B > 65535 || H < 1 || W < 1 || HID < kChunk || HID % kChunk || dtype < 0 ||
      dtype > 1 || !covers(tiles_h, tile, H) || !covers(tiles_w, tile, W) ||
      (bf16 && (misaligned(x) || misaligned(w1) || misaligned(w2) || misaligned(dw) ||
                misaligned(b1) || misaligned(bdw) || misaligned(b2))))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fb1 = static_cast<const float*>(b1);
  const float* fdw = static_cast<const float*>(dw);
  const float* fbdw = static_cast<const float*>(bdw);
  const float* fb2 = static_cast<const float*>(b2);
  switch (C) {
    case 32:
      return launch<32>(bf16, x, w1, fb1, fdw, fbdw, w2, fb2, out, B, H, W, HID, tiles_h,
                        tiles_w, s);
    case 64:
      return launch<64>(bf16, x, w1, fb1, fdw, fbdw, w2, fb2, out, B, H, W, HID, tiles_h,
                        tiles_w, s);
    case 96:
      return launch<96>(bf16, x, w1, fb1, fdw, fbdw, w2, fb2, out, B, H, W, HID, tiles_h,
                        tiles_w, s);
    case 128:
      return launch<128>(bf16, x, w1, fb1, fdw, fbdw, w2, fb2, out, B, H, W, HID, tiles_h,
                        tiles_w, s);
  }
  return cudaErrorInvalidValue;
}
