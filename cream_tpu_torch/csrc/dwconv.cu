// Depthwise 3x3 convolution, pad 1, stride 1 or 2, NHWC: forward, and the
// backward as dx and the weight grad in one launch (or the weight grad alone).
//
// Replaces: cream_tpu/ops/dwconv.py's Pallas kernels
//   K7 `_fwd_kernel` and `_bwd_kernel` (stride 1, `dw_conv3x3_fused`),
//   K8 `_wgrad_kernel` (stride 1 weight grad, `dw_conv3x3_wg`),
//   K9 `_fwd2_kernel` and `_bwd2_kernel` (stride 2, `dw_conv3x3s2_fused`).
// The TPU kernels' W-rolls, row chunks and the stride-2 phase-split copies
// of x are Mosaic workarounds; here taps are read from tiles in shared
// memory (the stride-2 forward: directly from global memory).
//
// What it computes (x: (B, H, W, C), w9: (9, C) with tap t = 3*kh + kw,
// y and dy: (B, Ho, Wo, C), Ho = (H - 1) / S + 1):
//   y[b,o,p,c]  = sum_t w9[t,c] * x[b, S*o+kh-1, S*p+kw-1, c]        (zero pad)
//   dx[b,h,w,c] = sum_t w9[t,c] * dy[b, (h+1-kh)/S, (w+1-kw)/S, c]  (where whole)
//   dw[t,c]     = sum_{b,o,p} x[b, S*o+kh-1, S*p+kw-1, c] * dy[b,o,p,c]
// y and dx sum in fp32 in tap order with the product and the sum rounded
// apart (no FMA), as the plain PyTorch version does, and round once to the
// input type; dw is fp32.
//
// What bounds it on Hopper: 9 multiply-adds per element against 2 bytes
// (bf16) read and written per element: ~1 flop/byte, far below the ridge,
// so HBM bytes bound every launch (x read, y written; x and dy read, dx
// written). The backward kernels (K7, K8, K9's) and K7's forward are tile
// kernels: a block owns tiles of (image, TH output rows, TW output columns,
// CB channels), so that each byte of x and dy comes from HBM once and the
// halos mostly from L2. The wrapper's tile plans (`ops/dwconv.py`
// `tile_plan`, `tile_plan_s2`) give V (channels a thread), CB, TW, TH, the
// tiles a block takes at once (several whole images at small maps) and, for
// the backward, the pixel-tile groups.
//   Staging: the block copies each tensor's window of a tile into shared
// memory (stride 1: x and dy as (TH+2, TW+2, CB) with a one-pixel halo;
// stride 2: x as (2TH+1, 2TW+1, CB) from (2*o0-1, 2*p0-1), the pixels the
// tile's outputs read, and dy as (TH+1, TW+1, CB) from (o0, p0), the tile
// and a pixel below and to its right), 16 bytes a `cp.async` where C
// allows; the zero padding is cp.async's zero-fill (source size 0) at the
// map's edges; other C are staged element by element.
//   Stride-1 forward: a thread owns one (column, V channels) of a tile and
// walks its rows down: each staged row (3 shared reads) feeds the three outputs it
// reaches, kept as three running sums, so an output costs 3 shared reads,
// not 9 global ones; the 9*V taps sit in registers.
//   Stride-1 backward: x and dy both staged; a thread walks its rows up, so dx
// takes its taps in tap order with the same running sums, and each staged
// row of x meets the dy rows it pairs with in 9*V fp32 dw sums. A block
// (group g, channel slice) walks a contiguous range of pixel tiles, reduces
// its threads' sums in shared memory in thread order into one (9, CB)
// partial; a second small kernel sums the partials in group order. Which
// block owns which tile depends only on the shape, so dw has the same bits
// on every launch, and K8 (the same kernel with dx off) gives K7's dw.
//   Stride-2 backward (K9's): a thread owns one output column (V channels)
// of a tile and walks its rows down. Output (o, p) writes the four dx
// pixels (2o + i, 2p + j), the JAX kernel's parity phases, from the staged
// dy at (o, p), (o, p+1), (o+1, p), (o+1, p+1): each phase's taps in tap
// order, only those whose dy lies in the map, so dx is bit-identical to the
// plain version; dy row o + 1 is the next output's row o. Its dw sums read
// x rows 2o-1 .. 2o+1, the last of which is kept for the next output; the
// block reduces them as above. The row loop is not unrolled, which keeps
// the bf16 kernel at 80 registers: three 224-thread blocks an SM, as many
// as their 74 KB of staged windows allow (unrolled twice it took 97, two
// blocks an SM, and ran slower).
//   Stride-2 forward (K9's) keeps the direct-read design: a thread owns V
// channels of one output pixel and reads its 9 taps from global memory
// through L1/L2 (level with cuDNN).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "cp_async.cuh"

namespace {

using cpa::cp_async16;
using cpa::cp_async_commit;
using cpa::cp_async_wait;

constexpr int kThreads = 256;

// V consecutive channels of T as fp32, loaded and stored in one access
// (16 bytes for bf16 x8 and fp32 x4).
template <typename T, int V> struct Vec;
template <> struct Vec<float, 1> {
  __device__ static void load(const float* p, float* v) { v[0] = *p; }
  __device__ static void store(float* p, const float* v) { *p = v[0]; }
};
template <> struct Vec<float, 2> {
  __device__ static void load(const float* p, float* v) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x;
    v[1] = f.y;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
};
template <> struct Vec<float, 4> {
  __device__ static void load(const float* p, float* v) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <> struct Vec<__nv_bfloat16, 1> {
  __device__ static void load(const __nv_bfloat16* p, float* v) { v[0] = __bfloat162float(*p); }
  __device__ static void store(__nv_bfloat16* p, const float* v) { *p = __float2bfloat16(v[0]); }
};
template <> struct Vec<__nv_bfloat16, 2> {
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = f.x;
    v[1] = f.y;
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  }
};
template <> struct Vec<__nv_bfloat16, 4> {
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    uint2 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 2; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint2*>(p) = u;
  }
};
template <> struct Vec<__nv_bfloat16, 8> {
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    uint4 u;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};

// Sizes; every index of a tensor fits in an int (the wrapper refuses 2**31
// elements or more).
struct Shape {
  int B, H, W, C, Ho, Wo;
};

// One thread per (output pixel, channel vector), grid-stride.
template <typename T, int V, int S>
__device__ void fwd_body(const T* __restrict__ x, const T* __restrict__ w9, T* __restrict__ y,
                         Shape s) {
  const int cvs = s.C / V;
  const int total = s.B * s.Ho * s.Wo * cvs;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    const int c = (i % cvs) * V;
    const int pix = i / cvs;
    const int p = pix % s.Wo;
    const int o = (pix / s.Wo) % s.Ho;
    const int b = pix / (s.Wo * s.Ho);
    float acc[V], xv[V], wv[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      const int h = S * o + kh - 1;
      if (h < 0 || h >= s.H) continue;
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const int w = S * p + kw - 1;
        if (w < 0 || w >= s.W) continue;
        Vec<T, V>::load(x + ((b * s.H + h) * s.W + w) * s.C + c, xv);
        Vec<T, V>::load(w9 + (kh * 3 + kw) * s.C + c, wv);
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = __fadd_rn(acc[v], __fmul_rn(xv[v], wv[v]));
      }
    }
    Vec<T, V>::store(y + pix * s.C + c, acc);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
dwconv_s2_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w9, T* __restrict__ y,
                     Shape s) {
  fwd_body<T, V, 2>(x, w9, y, s);
}

// dw[i] = sum over groups of partial[g][i]: a block of kReduceLanes outputs
// by kReduceParts parts; part q sums groups q, q + parts, ... in order, then
// the parts' sums are added in part order, so the order is fixed.
constexpr int kReduceLanes = 32, kReduceParts = 32;

__global__ void __launch_bounds__(kReduceLanes * kReduceParts)
dwconv_dw_reduce_kernel(const float* __restrict__ partial, float* __restrict__ dw, int groups,
                        int count) {
  __shared__ float part[kReduceParts][kReduceLanes];
  const int lane = threadIdx.x % kReduceLanes, q = threadIdx.x / kReduceLanes;
  const int i = blockIdx.x * kReduceLanes + lane;
  float acc = 0.f;
  if (i < count)
    for (int g = q; g < groups; g += kReduceParts) acc += partial[g * count + i];
  part[q][lane] = acc;
  __syncthreads();
  if (q == 0 && i < count) {
    float sum = 0.f;
    for (int k = 0; k < kReduceParts; ++k) sum += part[k][lane];
    dw[i] = sum;
  }
}

// ---- the tile kernels (K7 forward and backward, K8, K9's backward) ----

// The tile plan (see the note at the top), as the wrapper's `tile_plan` or
// `tile_plan_s2` gives it, with the counts it implies; tiles cut the output
// map (Ho, Wo).
struct Tiles {
  int lanes, cb, ncs, tw, nw, th, nh, ni, groups;
  int P;               // pixel tiles: B * nw * nh
  bool vec16;          // 16-byte cp.async staging (C and CB bytes multiples of 16)
};

// Pixel tile pt: row tile fastest, then column tile, then the image, so a
// block walks down a column strip and the next tile's upper halo rows are
// the rows it has just read.
struct TileAt {
  int b, h0, w0, c0;
};

__device__ __forceinline__ TileAt pixel_tile(int pt, const Tiles& t, int c0) {
  const int hb = pt % t.nh, q = pt / t.nh;
  return {q / t.nw, hb * t.th, (q % t.nw) * t.tw, c0};
}

// A tensor's staged window of the tile at output pixel (h0, w0): `rows` x
// `cols` pixels of its (H, W) map from pixel (st*h0 + off, st*w0 + off),
// zero outside the map. `inner`: only the window's inner rows and columns
// are staged (the rest is left as it was).
struct Window {
  int st, off, rows, cols, H, W;
  bool inner;
};

// Tensor k's window at stride S. x (k = 0): stride 1, the tile and its
// one-pixel halo; stride 2, the x pixels the tile's outputs read. dy (k =
// 1): stride 1, as x's (DYH false: the tile's own pixels, K8); stride 2,
// the tile and a pixel below and to its right. S, k and DYH are known to
// the build, so the kernels' staging loops see constants.
template <int S, bool DYH>
__host__ __device__ __forceinline__ Window window(int k, const Shape& s, int th, int tw) {
  if (k == 0)
    return S == 1 ? Window{1, -1, th + 2, tw + 2, s.H, s.W, false}
                  : Window{2, -1, 2 * th + 1, 2 * tw + 1, s.H, s.W, false};
  return S == 1 ? Window{1, -1, th + 2, tw + 2, s.Ho, s.Wo, !DYH}
                : Window{1, 0, th + 1, tw + 1, s.Ho, s.Wo, false};
}

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Stage the block's sub-tiles p0 ... p0 + NI - 1 (those below p1) of
// tensor K's window into sm. Staged row q = sub * rows + r holds window row
// r of sub-tile sub, as `cols` pixels of CB channels: J chunks of epc
// elements. Thread i takes chunk i % js (and + js, ...) of staged rows i /
// js, i / js + qs, ... (js = min(J, blockDim), qs = blockDim / js), so its
// column and channels are fixed and a row step costs a few adds.
template <typename T, int S, int K, bool DYH>
__device__ void stage(T* sm, const T* __restrict__ g, const Shape& s, const Tiles& t, int p0,
                      int p1, int c0) {
  const Window win = window<S, DYH>(K, s, t.th, t.tw);
  const int C = s.C;
  const int epc = t.vec16 ? 16 / static_cast<int>(sizeof(T)) : 1;   // elements per chunk
  const int KC = t.cb / epc, R = win.rows, J = win.cols * KC;
  const int js = min(J, static_cast<int>(blockDim.x)), qs = blockDim.x / js;
  const int nsub = min(t.ni, p1 - p0), WC = win.W * C;
  if (static_cast<int>(threadIdx.x) >= qs * js) return;
  for (int j = threadIdx.x % js; j < J; j += js) {
    const int c = j / KC, off = j % KC * epc;
    if (win.inner && (c == 0 || c == win.cols - 1)) continue;
    int sub = 0, r = threadIdx.x / js, cur = -1;
    while (r >= R) r -= R, ++sub;
    bool in_w = false;
    int h0 = 0, base = 0;                              // map row h0 + r is at base + r * WC
    while (sub < nsub) {
      if (sub != cur) {
        cur = sub;
        const TileAt a = pixel_tile(p0 + sub, t, c0);
        const int w = win.st * a.w0 + win.off + c;
        in_w = w >= 0 && w < win.W;
        h0 = win.st * a.h0 + win.off;
        base = ((a.b * win.H + h0) * win.W + w) * C + a.c0 + off;
      }
      const int h = h0 + r;
      const bool in = in_w && h >= 0 && h < win.H;
      const T* src = in ? g + base + r * WC : g;
      T* dst = sm + (sub * R + r) * J * epc + j * epc;
      if (!win.inner || (r != 0 && r != R - 1)) {
        if (t.vec16)
          cp_async16(dst, src, in);
        else
          *dst = in ? *src : zero<T>();
      }
      r += qs;
      while (r >= R) r -= R, ++sub;
    }
  }
}

// The elements of one tensor's staged tiles (one step of the walk).
__host__ __device__ inline int staged_elems(const Window& w, const Tiles& t) {
  return t.ni * w.rows * w.cols * t.cb;
}

// The thread's place in the block: sub-tile, column and channel lane
// (lanes fastest, so a warp reads consecutive shared and global addresses).
struct Lane {
  int sub, col, lane;
  __device__ explicit Lane(const Tiles& t)
      : sub(threadIdx.x / (t.tw * t.lanes)),
        col(threadIdx.x / t.lanes % t.tw),
        lane(threadIdx.x % t.lanes) {}
};

// Block (cs, g) walks pixel tiles [P*g/G, P*(g+1)/G) of channel slice cs,
// NI at a time (the slices of one group are launched together, so they
// read the same pixels at about the same time), with NT tensors (x, then
// dy) staged in kStages buffers (tensor k's windows after tensor k-1's in
// a buffer): the next kStages - 1 steps' copies are in flight while f(the
// staged buffer, p0, p1) computes on the current one.
constexpr int kStages = 2;

template <int NT, int S, bool DYH, typename T, typename F>
__device__ void walk_tiles(T* sm, const T* const (&src)[NT], const Shape& s, const Tiles& t,
                           F&& f) {
  const int g = blockIdx.y, c0 = blockIdx.x * t.cb;
  const int pt0 = static_cast<int>(static_cast<long long>(t.P) * g / t.groups);
  const int pt1 = static_cast<int>(static_cast<long long>(t.P) * (g + 1) / t.groups);
  const int ex = staged_elems(window<S, DYH>(0, s, t.th, t.tw), t);   // x's staged tiles
  const int E = NT == 1 ? ex : ex + staged_elems(window<S, DYH>(1, s, t.th, t.tw), t);
  // step i's tiles into buffer i % kStages; one commit group a step, empty
  // past the end, so that wait_group<kStages - 1> always means "step done"
  auto issue = [&](int i) {
    const int p0 = pt0 + i * t.ni;
    if (p0 < pt1) {
      T* buf = sm + i % kStages * E;
      stage<T, S, 0, DYH>(buf, src[0], s, t, p0, pt1, c0);
      if constexpr (NT == 2) stage<T, S, 1, DYH>(buf + ex, src[1], s, t, p0, pt1, c0);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  for (int i = 0, p0 = pt0; p0 < pt1; ++i, p0 += t.ni) {
    issue(i + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    f(sm + i % kStages * E, p0, pt1);
    __syncthreads();                                  // before the buffer is staged again
  }
}

// One tile column of the forward, walked down from the halo row above the
// tile (staged row 0) to the one below it (rows + 1): each staged row of x
// gives the first tap row (kh = 0) of output row r, the second of r - 1
// and the last of r - 2, which is then stored. sx: x at staged row 0,
// column col (the output's left neighbour); rs: the staged row stride; cb:
// the column stride; yp: y at the tile's first row; gs: y's row stride.
template <typename T, int V>
__device__ __forceinline__ void fwd_column(const T* sx, int rs, int cb, int rows,
                                           const float (&wv)[9][V], T* yp, int gs) {
  float s1[V], s2[V];                                  // outputs r - 1, r - 2
#pragma unroll
  for (int v = 0; v < V; ++v) s1[v] = s2[v] = 0.f;
#pragma unroll 3
  for (int r = 0; r < rows + 2; ++r, sx += rs) {
    float xr[3][V], s0[V];
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) Vec<T, V>::load(sx + kw * cb, xr[kw]);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      s0[v] = 0.f;
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {                 // tap order: kh outer, kw inner
        s0[v] = __fadd_rn(s0[v], __fmul_rn(xr[kw][v], wv[kw][v]));
        s1[v] = __fadd_rn(s1[v], __fmul_rn(xr[kw][v], wv[3 + kw][v]));
        s2[v] = __fadd_rn(s2[v], __fmul_rn(xr[kw][v], wv[6 + kw][v]));
      }
    }
    if (r >= 2) {
      Vec<T, V>::store(yp, s2);
      yp += gs;
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      s2[v] = s1[v];
      s1[v] = s0[v];
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
dwconv_tile_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w9, T* __restrict__ y,
                       Shape s, Tiles t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Lane l(t);
  const int c = blockIdx.x * t.cb + l.lane * V;
  float wv[9][V];
#pragma unroll
  for (int k = 0; k < 9; ++k) Vec<T, V>::load(w9 + k * s.C + c, wv[k]);
  const T* const src[1] = {x};
  walk_tiles<1, 1, true>(reinterpret_cast<T*>(smem), src, s, t,
                         [&](const T* sm, int p0, int p1) {
    if (p0 + l.sub >= p1) return;
    const TileAt a = pixel_tile(p0 + l.sub, t, c);
    const int w = a.w0 + l.col;
    if (w >= s.W) return;
    fwd_column<T, V>(sm + (l.sub * (t.th + 2) * (t.tw + 2) + l.col) * t.cb + l.lane * V,
                     (t.tw + 2) * t.cb, t.cb, min(t.th, s.H - a.h0), wv,
                     y + ((a.b * s.H + a.h0) * s.W + w) * s.C + c, s.W * s.C);
  });
}

// One tile column of the backward, walked up from the halo row below the
// tile (staged row rows + 1) to the one above it (0). sx, sdy: the column's
// staged x and dy at staged row 0, column col (its left neighbour); rs,
// cb, dxp and gs as for the forward.
//   dx: the staged dy row r gives the first tap row (kh = 0) of output row
// r - 2, the second of r - 1 and the last of r, which is then stored.
//   dw: dy row r + 1 pairs with x row r at kh = 0; dy row r with x row r at
// kh = 1 and with x row r + 1 at kh = 2; only the tile's own dy rows
// (1..rows) count.
template <typename T, int V, bool DX>
__device__ __forceinline__ void bwd_column(const T* sx, const T* sdy, int rs, int cb, int rows,
                                           const float (&wv)[9][V], float (&dw)[9][V], T* dxp,
                                           int gs) {
  float xp[3][V], dyp[V], d1[V], d2[V];              // x row r + 1, dy row r + 1, dx r - 1, r
#pragma unroll
  for (int v = 0; v < V; ++v) {
    dyp[v] = d1[v] = d2[v] = 0.f;
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) xp[kw][v] = 0.f;
  }
  sx += (rows + 1) * rs;
  sdy += (rows + 1) * rs;
  if constexpr (DX) dxp += (rows - 1) * gs;
#pragma unroll 3
  for (int r = rows + 1; r >= 0; --r, sx -= rs, sdy -= rs) {
    float xc[3][V], dr[3][V];
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
      Vec<T, V>::load(sx + kw * cb, xc[kw]);
      if (DX || kw == 1) Vec<T, V>::load(sdy + kw * cb, dr[kw]);
    }
    if (r + 1 <= rows) {
#pragma unroll
      for (int kw = 0; kw < 3; ++kw)
#pragma unroll
        for (int v = 0; v < V; ++v) dw[kw][v] = fmaf(xc[kw][v], dyp[v], dw[kw][v]);
    }
    if (r >= 1 && r <= rows) {
#pragma unroll
      for (int kw = 0; kw < 3; ++kw)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          dw[3 + kw][v] = fmaf(xc[kw][v], dr[1][v], dw[3 + kw][v]);
          dw[6 + kw][v] = fmaf(xp[kw][v], dr[1][v], dw[6 + kw][v]);
        }
    }
    if constexpr (DX) {
      float d0[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        d0[v] = 0.f;
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {                 // tap kw reads dy column col + 1 - kw
          d0[v] = __fadd_rn(d0[v], __fmul_rn(wv[kw][v], dr[2 - kw][v]));
          d1[v] = __fadd_rn(d1[v], __fmul_rn(wv[3 + kw][v], dr[2 - kw][v]));
          d2[v] = __fadd_rn(d2[v], __fmul_rn(wv[6 + kw][v], dr[2 - kw][v]));
        }
      }
      if (r < rows) {
        Vec<T, V>::store(dxp, d2);
        dxp -= gs;
      }
#pragma unroll
      for (int v = 0; v < V; ++v) {
        d2[v] = d1[v];
        d1[v] = d0[v];
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      dyp[v] = dr[1][v];
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) xp[kw][v] = xc[kw][v];
    }
  }
}

// The backward block's last step: its threads' dw sums, reduced in thread
// order into partial[g][9][cs*CB ... cs*CB + CB) through red (shared
// memory, the staging buffers once the walk is done).
template <int V>
__device__ void reduce_block_dw(const float (&dw)[9][V], float* red, const Tiles& t, int C,
                                float* __restrict__ partial) {
  // thread q's sums at red[q][9][V]; each output sums its lane's threads
  // in thread order
#pragma unroll
  for (int k = 0; k < 9; ++k)
#pragma unroll
    for (int v = 0; v < V; ++v) red[(threadIdx.x * 9 + k) * V + v] = dw[k][v];
  __syncthreads();
  const int columns = blockDim.x / t.lanes, c0 = blockIdx.x * t.cb;
  for (int j = threadIdx.x; j < 9 * t.cb; j += blockDim.x) {
    const int k = j / t.cb, ch = j % t.cb, lane = ch / V, v = ch % V;
    float sum = 0.f;
    for (int q = 0; q < columns; ++q) sum += red[((q * t.lanes + lane) * 9 + k) * V + v];
    partial[(blockIdx.y * 9 + k) * C + c0 + ch] = sum;
  }
}

template <typename T, int V, bool DX>
__global__ void __launch_bounds__(kThreads)
dwconv_tile_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                       const T* __restrict__ w9, T* __restrict__ dx, float* __restrict__ partial,
                       Shape s, Tiles t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Lane l(t);
  const int c = blockIdx.x * t.cb + l.lane * V;
  float wv[9][V], dw[9][V];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    if constexpr (DX) Vec<T, V>::load(w9 + k * s.C + c, wv[k]);
#pragma unroll
    for (int v = 0; v < V; ++v) dw[k][v] = 0.f;
  }
  const T* const src[2] = {x, dy};
  const int E = staged_elems(window<1, DX>(0, s, t.th, t.tw), t);
  walk_tiles<2, 1, DX>(reinterpret_cast<T*>(smem), src, s, t,      // K8: dy's own pixels
                       [&](const T* sm, int p0, int p1) {
    if (p0 + l.sub >= p1) return;
    const TileAt a = pixel_tile(p0 + l.sub, t, c);
    const int w = a.w0 + l.col;
    if (w >= s.W) return;
    const int off = (l.sub * (t.th + 2) * (t.tw + 2) + l.col) * t.cb + l.lane * V;
    bwd_column<T, V, DX>(sm + off, sm + E + off, (t.tw + 2) * t.cb, t.cb,
                         min(t.th, s.H - a.h0), wv, dw,
                         DX ? dx + ((a.b * s.H + a.h0) * s.W + w) * s.C + c : nullptr,
                         s.W * s.C);
  });
  reduce_block_dw<V>(dw, reinterpret_cast<float*>(smem), t, s.C, partial);
}

// One output column of the stride-2 backward, walked down the tile's rows.
// sx: x's staged window at row 0, column 2*col (the output's first tap);
// sdy: dy's at row 0, column col; xrs, drs: their row strides; cb: the
// pixel stride of both. Output row r reads x rows 2r .. 2r + 2 (row 2r is
// the previous output's 2r + 2, kept) and dy rows r, r + 1 (the next
// output's r) at columns col, col + 1. rows: the tile's output rows in the
// map; down: dy row `rows` (the window's last) is in the map; right: dy
// column col + 1 is; odd_col: dx column 2p + 1 is; odd_last: dx row 2o + 1
// of the last output row is. dxp: dx at (2*o0, 2p); gs, ps: its row and
// pixel strides.
//   dx's four phases sum their taps in tap order (t = 3*kh + kw: dx(2o+i,
// 2p+j) takes kh = 1 (i = 0) or 0, 2 (i = 1; dy rows o + 1, o), likewise kw
// with j), from 0, each product and sum rounded apart, adding only the
// taps whose dy lies in the map, as the plain version does.
template <typename T, int V>
__device__ __forceinline__ void s2_bwd_column(const T* sx, const T* sdy, int xrs, int drs, int cb,
                                              int rows, bool down, bool right, bool odd_col,
                                              bool odd_last, const float (&wv)[9][V],
                                              float (&dw)[9][V], T* dxp, int gs, int ps) {
  float xa[3][V], d0[2][V];                           // x row 2r, dy row r (col, col + 1)
#pragma unroll
  for (int kw = 0; kw < 3; ++kw) Vec<T, V>::load(sx + kw * cb, xa[kw]);
  Vec<T, V>::load(sdy, d0[0]);
  Vec<T, V>::load(sdy + cb, d0[1]);
  sx += xrs;                                          // x row 2r + 1
  sdy += drs;                                         // dy row r + 1
#pragma unroll 1
  for (int r = 0; r < rows; ++r, sx += 2 * xrs, sdy += drs, dxp += 2 * gs) {
    float xb[3][V], xc[3][V], d1[2][V];
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
      Vec<T, V>::load(sx + kw * cb, xb[kw]);
      Vec<T, V>::load(sx + xrs + kw * cb, xc[kw]);
    }
    Vec<T, V>::load(sdy, d1[0]);
    Vec<T, V>::load(sdy + cb, d1[1]);
    const bool last = r == rows - 1, dn = !last || down, odd_row = !last || odd_last;
    float ee[V], eo[V], oe[V], oo[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float g = d0[0][v];
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        dw[kw][v] = fmaf(xa[kw][v], g, dw[kw][v]);
        dw[3 + kw][v] = fmaf(xb[kw][v], g, dw[3 + kw][v]);
        dw[6 + kw][v] = fmaf(xc[kw][v], g, dw[6 + kw][v]);
      }
      ee[v] = __fadd_rn(0.f, __fmul_rn(wv[4][v], g));
      eo[v] = 0.f;
      if (right) eo[v] = __fadd_rn(eo[v], __fmul_rn(wv[3][v], d0[1][v]));
      eo[v] = __fadd_rn(eo[v], __fmul_rn(wv[5][v], g));
      oe[v] = 0.f;
      if (dn) oe[v] = __fadd_rn(oe[v], __fmul_rn(wv[1][v], d1[0][v]));
      oe[v] = __fadd_rn(oe[v], __fmul_rn(wv[7][v], g));
      oo[v] = 0.f;
      if (dn && right) oo[v] = __fadd_rn(oo[v], __fmul_rn(wv[0][v], d1[1][v]));
      if (dn) oo[v] = __fadd_rn(oo[v], __fmul_rn(wv[2][v], d1[0][v]));
      if (right) oo[v] = __fadd_rn(oo[v], __fmul_rn(wv[6][v], d0[1][v]));
      oo[v] = __fadd_rn(oo[v], __fmul_rn(wv[8][v], g));
    }
    Vec<T, V>::store(dxp, ee);
    if (odd_col) Vec<T, V>::store(dxp + ps, eo);
    if (odd_row) {
      Vec<T, V>::store(dxp + gs, oe);
      if (odd_col) Vec<T, V>::store(dxp + gs + ps, oo);
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) xa[kw][v] = xc[kw][v];
      d0[0][v] = d1[0][v];
      d0[1][v] = d1[1][v];
    }
  }
}

// K9's backward: tiles of the output map, x and dy staged in their windows
// (see the note at the top), dw reduced as the stride-1 backward's.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
dwconv_s2_tile_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                          const T* __restrict__ w9, T* __restrict__ dx,
                          float* __restrict__ partial, Shape s, Tiles t) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Lane l(t);
  const int c = blockIdx.x * t.cb + l.lane * V;
  float wv[9][V], dw[9][V];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    Vec<T, V>::load(w9 + k * s.C + c, wv[k]);
#pragma unroll
    for (int v = 0; v < V; ++v) dw[k][v] = 0.f;
  }
  const T* const src[2] = {x, dy};
  const Window xw = window<2, true>(0, s, t.th, t.tw), dyw = window<2, true>(1, s, t.th, t.tw);
  const int E = staged_elems(xw, t);
  walk_tiles<2, 2, true>(reinterpret_cast<T*>(smem), src, s, t,
                         [&](const T* sm, int p0, int p1) {
    if (p0 + l.sub >= p1) return;
    const TileAt a = pixel_tile(p0 + l.sub, t, c);
    const int p = a.w0 + l.col;
    if (p >= s.Wo) return;
    const int rows = min(t.th, s.Ho - a.h0), o_last = a.h0 + rows - 1;
    s2_bwd_column<T, V>(
        sm + ((l.sub * xw.rows * xw.cols) + 2 * l.col) * t.cb + l.lane * V,
        sm + E + ((l.sub * dyw.rows * dyw.cols) + l.col) * t.cb + l.lane * V,
        xw.cols * t.cb, dyw.cols * t.cb, t.cb, rows, o_last + 1 < s.Ho, p + 1 < s.Wo,
        2 * p + 1 < s.W, 2 * o_last + 1 < s.H, wv, dw,
        dx + ((a.b * s.H + 2 * a.h0) * s.W + 2 * p) * s.C + c, s.W * s.C, s.C);
  });
  reduce_block_dw<V>(dw, reinterpret_cast<float*>(smem), t, s.C, partial);
}

template <typename T, int V>
cudaError_t launch_fwd(const void* x, const void* w9, void* y, const Shape& s,
                       cudaStream_t stream) {
  const long long total = static_cast<long long>(s.B) * s.Ho * s.Wo * (s.C / V);
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  dwconv_s2_fwd_kernel<T, V><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w9), static_cast<T*>(y), s);
  return cudaGetLastError();
}

// dw = the sum of the groups' (9, C) partials, in group order.
cudaError_t reduce_dw(const float* partial, float* dw, int groups, int C, cudaStream_t stream) {
  const int count = 9 * C;
  dwconv_dw_reduce_kernel<<<(count + kReduceLanes - 1) / kReduceLanes,
                            kReduceLanes * kReduceParts, 0, stream>>>(partial, dw, groups, count);
  return cudaGetLastError();
}

constexpr int kMaxSmem = 200 * 1024;   // dynamic shared memory a tile block may take

// The plan's counts, or false for a plan the kernels cannot take; smem: the
// block's dynamic shared memory (two buffers of x's staged windows, and of
// dy's in the backward, whose reduction then reuses them).
bool make_tiles(const Shape& s, int esize, int stride, bool backward, int V, int cb, int tw,
                int th, int ni, int groups, Tiles* t, int* smem) {
  if (V < 1 || cb < V || cb % V || s.C % cb || tw < 1 || th < 1 || ni < 1) return false;
  const int lanes = cb / V, ncs = s.C / cb;
  if (static_cast<long long>(lanes) * tw * ni > kThreads) return false;
  const int nw = (s.Wo + tw - 1) / tw, nh = (s.Ho + th - 1) / th;
  const long long P = static_cast<long long>(s.B) * nh * nw;
  if (P * ncs >= (1LL << 31) || groups < 1 || groups > P || groups > 65535) return false;
  const Window xw = stride == 1 ? window<1, true>(0, s, th, tw) : window<2, true>(0, s, th, tw);
  const Window dyw = stride == 1 ? window<1, true>(1, s, th, tw) : window<2, true>(1, s, th, tw);
  const long long pixels = xw.rows * xw.cols + (backward ? dyw.rows * dyw.cols : 0);
  const long long staged = kStages * pixels * ni * cb * esize;
  const long long red = static_cast<long long>(lanes) * tw * ni * 9 * V * 4;
  const long long bytes = backward && red > staged ? red : staged;
  if (bytes > kMaxSmem) return false;
  *t = Tiles{lanes, cb, ncs, tw, nw, th, nh, ni, groups, static_cast<int>(P),
             (cb * esize) % 16 == 0 && (s.C * esize) % 16 == 0};
  *smem = static_cast<int>(bytes);
  return true;
}

// Let kernel K take up to kMaxSmem of dynamic shared memory (set once).
template <auto K>
cudaError_t allow_smem() {
  static const cudaError_t e =
      cudaFuncSetAttribute(K, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  return e;
}

// Launch tile kernel K on the plan's grid: (channel slices, groups) blocks
// of NI * TW * lanes threads.
template <auto K, typename... A>
cudaError_t launch_tiles(const Tiles& t, int smem, cudaStream_t stream, A... args) {
  const cudaError_t e = allow_smem<K>();
  if (e != cudaSuccess) return e;
  K<<<dim3(t.ncs, t.groups), t.ni * t.tw * t.lanes, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_tile_fwd(const void* x, const void* w9, void* y, const Shape& s,
                            const Tiles& t, int smem, cudaStream_t stream) {
  return launch_tiles<dwconv_tile_fwd_kernel<T, V>>(t, smem, stream, static_cast<const T*>(x),
                                                    static_cast<const T*>(w9),
                                                    static_cast<T*>(y), s, t);
}

template <typename T, int V>
cudaError_t launch_tile_bwd(const void* x, const void* dy, const void* w9, void* dx,
                            float* partial, float* dw, const Shape& s, int stride,
                            const Tiles& t, int smem, cudaStream_t stream) {
  const T *xt = static_cast<const T*>(x), *dyt = static_cast<const T*>(dy);
  const T* wt = static_cast<const T*>(w9);
  T* dxt = static_cast<T*>(dx);
  const cudaError_t e =
      stride == 2 ? launch_tiles<dwconv_s2_tile_bwd_kernel<T, V>>(t, smem, stream, xt, dyt, wt,
                                                                  dxt, partial, s, t)
      : dx ? launch_tiles<dwconv_tile_bwd_kernel<T, V, true>>(t, smem, stream, xt, dyt, wt, dxt,
                                                              partial, s, t)
           : launch_tiles<dwconv_tile_bwd_kernel<T, V, false>>(t, smem, stream, xt, dyt, wt, dxt,
                                                               partial, s, t);
  return e != cudaSuccess ? e : reduce_dw(partial, dw, t.groups, s.C, stream);
}

bool make_shape(int B, int H, int W, int C, int stride, Shape* s) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || (stride != 1 && stride != 2)) return false;
  if (static_cast<long long>(B) * H * W * C >= (1LL << 31)) return false;
  *s = Shape{B, H, W, C, (H - 1) / stride + 1, (W - 1) / stride + 1};
  return true;
}

// The stride-2 forward's channels per thread: 16-byte accesses where C
// allows (bf16 x8, fp32 x4), else bf16 pairs, else one.
int vec_for(int C, int dtype) {
  if (dtype == 0) return C % 4 == 0 ? 4 : 1;
  if (C % 8 == 0) return 8;
  return C % 4 == 0 ? 4 : C % 2 == 0 ? 2 : 1;
}

// f(T{}, V) for dtype (0 float32, 1 bfloat16) and V channels a thread; the
// stride-2 forward takes V = 1, 4 (fp32) or 1, 2, 4, 8 (bf16); the tile
// kernels V = 1, 2, 4 (4 forward only).
template <bool Tile, bool Backward, typename F>
cudaError_t dispatch(int V, int dtype, F&& f) {
  switch (dtype * 16 + V) {
    case 1: return f(float{}, std::integral_constant<int, 1>{});
    case 2:
      if constexpr (Tile) return f(float{}, std::integral_constant<int, 2>{});
      break;
    case 4:
      if constexpr (!(Tile && Backward)) return f(float{}, std::integral_constant<int, 4>{});
      break;
    case 17: return f(__nv_bfloat16{}, std::integral_constant<int, 1>{});
    case 18: return f(__nv_bfloat16{}, std::integral_constant<int, 2>{});
    case 20:
      if constexpr (!(Tile && Backward)) return f(__nv_bfloat16{}, std::integral_constant<int, 4>{});
      break;
    case 24:
      if constexpr (!Tile) return f(__nv_bfloat16{}, std::integral_constant<int, 8>{});
      break;
  }
  return cudaErrorInvalidValue;
}

// The backward tile kernels behind both C entries: K7's (stride 1; K8 with
// dx and w9 both null) and K9's (stride 2; dx and w9 both given).
int tile_bwd(const void* x, const void* dy, const void* w9, void* dx, void* partial, void* dw,
             int B, int H, int W, int C, int stride, int dtype, int V, int cb, int tw, int th,
             int ni, int groups, void* stream) {
  Shape s;
  Tiles t;
  int smem;
  if (!make_shape(B, H, W, C, stride, &s) || dtype < 0 || dtype > 1 ||
      (dx == nullptr) != (w9 == nullptr) || (stride == 2 && dx == nullptr) ||
      !make_tiles(s, dtype ? 2 : 4, stride, true, V, cb, tw, th, ni, groups, &t, &smem))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(partial);
  float* d = static_cast<float*>(dw);
  return dispatch<true, true>(V, dtype, [&](auto e, auto v) {
    return launch_tile_bwd<decltype(e), decltype(v)::value>(x, dy, w9, dx, pt, d, s, stride, t,
                                                            smem, st);
  });
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Each returns a cudaError_t (0 on success).

// Stride 1 (K7 forward): the tile plan (V, CB, TW, TH, NI, groups) from
// the wrapper's `tile_plan`.
extern "C" int cream_dwconv_tile_fwd(const void* x, const void* w9, void* y, int B, int H, int W,
                                     int C, int dtype, int V, int cb, int tw, int th, int ni,
                                     int groups, void* stream) {
  Shape s;
  Tiles t;
  int smem;
  if (!make_shape(B, H, W, C, 1, &s) || dtype < 0 || dtype > 1 ||
      !make_tiles(s, dtype ? 2 : 4, 1, false, V, cb, tw, th, ni, groups, &t, &smem))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch<true, false>(V, dtype, [&](auto e, auto v) {
    return launch_tile_fwd<decltype(e), decltype(v)::value>(x, w9, y, s, t, smem, st);
  });
}

// Stride 1 (K7 backward; K8 with dx and w9 both null): the plan as for the
// forward; `partial` holds groups * 9 * C floats, dw is (9, C) fp32.
extern "C" int cream_dwconv_tile_bwd(const void* x, const void* dy, const void* w9, void* dx,
                                     void* partial, void* dw, int B, int H, int W, int C,
                                     int dtype, int V, int cb, int tw, int th, int ni, int groups,
                                     void* stream) {
  return tile_bwd(x, dy, w9, dx, partial, dw, B, H, W, C, 1, dtype, V, cb, tw, th, ni, groups,
                  stream);
}

// Stride 2 (K9 forward).
extern "C" int cream_dwconv_s2_fwd(const void* x, const void* w9, void* y, int B, int H, int W,
                                   int C, int dtype, void* stream) {
  Shape s;
  if (!make_shape(B, H, W, C, 2, &s) || dtype < 0 || dtype > 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch<false, false>(vec_for(C, dtype), dtype, [&](auto e, auto v) {
    return launch_fwd<decltype(e), decltype(v)::value>(x, w9, y, s, st);
  });
}

// Stride 2 (K9 backward): dx and dw, the tile plan (V, CB, TW, TH, NI,
// groups; TW and TH in output pixels) from the wrapper's `tile_plan_s2`;
// `partial` holds groups * 9 * C floats, dw is (9, C) fp32.
extern "C" int cream_dwconv_s2_tile_bwd(const void* x, const void* dy, const void* w9, void* dx,
                                        void* partial, void* dw, int B, int H, int W, int C,
                                        int dtype, int V, int cb, int tw, int th, int ni,
                                        int groups, void* stream) {
  return tile_bwd(x, dy, w9, dx, partial, dw, B, H, W, C, 2, dtype, V, cb, tw, th, ni, groups,
                  stream);
}
