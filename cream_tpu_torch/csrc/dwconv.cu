// Depthwise 3x3 convolution, pad 1, stride 1 or 2, NHWC: forward, and the
// backward as dx and the weight grad in one launch (or the weight grad alone).
//
// Replaces: cream_tpu/ops/dwconv.py's Pallas kernels
//   K7 `_fwd_kernel` and `_bwd_kernel` (stride 1, `dw_conv3x3_fused`),
//   K8 `_wgrad_kernel` (stride 1 weight grad, `dw_conv3x3_wg`),
//   K9 `_fwd2_kernel` and `_bwd2_kernel` (stride 2, `dw_conv3x3s2_fused`).
// The TPU kernels' W-rolls, row chunks and stride-2 parity-phase split are
// Mosaic workarounds; here stride-2 taps are read directly.
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
// written). Stride 1 (K7, K8) is a tile kernel: a block owns tiles of
// (image, TH rows, TW columns, CB channels), TH and TW at most 16, so that
// each byte of x and dy comes from HBM once and its one-pixel halo mostly
// from L2. The wrapper's tile plan (`ops/dwconv.py` `tile_plan`) gives V
// (channels a thread), CB, TW, TH, the tiles a block takes at once (several
// whole images at small maps) and, for the backward, the pixel-tile groups.
//   Staging: the block copies each (TH+2, TW+2, CB) tile with its halo into
// shared memory, 16 bytes a `cp.async` where C allows; the zero padding is
// cp.async's zero-fill (source size 0) at the map's edges; other C are
// staged element by element.
//   Forward: a thread owns one (column, V channels) of a tile and walks its
// rows down: each staged row (3 shared reads) feeds the three outputs it
// reaches, kept as three running sums, so an output costs 3 shared reads,
// not 9 global ones; the 9*V taps sit in registers.
//   Backward: x and dy tiles both staged; a thread walks its rows up, so dx
// takes its taps in tap order with the same running sums, and each staged
// row of x meets the dy rows it pairs with in 9*V fp32 dw sums. A block
// (group g, channel slice) walks a contiguous range of pixel tiles, reduces
// its threads' sums in shared memory in thread order into one (9, CB)
// partial; a second small kernel sums the partials in group order. Which
// block owns which tile depends only on the shape, so dw has the same bits
// on every launch, and K8 (the same kernel with dx off) gives K7's dw.
//   Stride 2 (K9) keeps the direct-read design: a thread owns V channels of
// one pixel and reads its taps from global memory through L1/L2 (its output
// and dy are a quarter of x, and its taps are not shared between
// neighbouring outputs the way stride 1's are). Its dx is a gather (each dx
// pixel reads the dy taps that reach it); its dw is summed as above.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "cp_async.cuh"

namespace {

using cpa::cp_async16;
using cpa::cp_async_commit;
using cpa::cp_async_wait;

constexpr int kThreads = 256;
constexpr int kTargetBlocks = 1024;  // backward blocks aimed for (~8 per SM)
constexpr int kMinPixelsPerLane = 4;  // a backward group's dy pixels per pixel lane, at least

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

// Channel vectors per backward block: all of them up to 32, else the
// largest divisor of their count in [16, 32] (32 if none), so few lanes
// idle; the block's other threads are pixel lanes. With the pixel groups
// below, they depend only on the shape, so the order of every sum does too.
int lanes_for(int cvs) {
  if (cvs <= 32) return cvs;
  for (int ct = 32; ct >= 16; --ct)
    if (cvs % ct == 0) return ct;
  return 32;
}

int groups_for(const Shape& s, int V) {
  const int cvs = s.C / V, ct = lanes_for(cvs);
  const int slices = (cvs + ct - 1) / ct, pt = kThreads / ct;
  const int pout = s.B * s.Ho * s.Wo;
  int g = (kTargetBlocks + slices - 1) / slices;
  const int cap = (pout + pt * kMinPixelsPerLane - 1) / (pt * kMinPixelsPerLane);
  if (g > cap) g = cap;
  if (g > 65535) g = 65535;
  return g < 1 ? 1 : g;
}

// dx of the group's share of x pixels: each gathers the dy taps that reach it.
template <typename T, int V, int S>
__device__ void dx_body(const T* __restrict__ dy, const T* __restrict__ w9, T* __restrict__ dx,
                        const Shape& s, int c, int g, int G, int pl, int pt) {
  float wv[9][V];
#pragma unroll
  for (int t = 0; t < 9; ++t) Vec<T, V>::load(w9 + t * s.C + c, wv[t]);
  const long long pin = static_cast<long long>(s.B) * s.H * s.W;
  const int q0 = static_cast<int>(pin * g / G), q1 = static_cast<int>(pin * (g + 1) / G);
  float dv[V], out[V];
  for (int pix = q0 + pl; pix < q1; pix += pt) {
    const int w = pix % s.W;
    const int h = (pix / s.W) % s.H;
    const int b = pix / (s.W * s.H);
#pragma unroll
    for (int v = 0; v < V; ++v) out[v] = 0.f;
#pragma unroll
    for (int kh = 0; kh < 3; ++kh) {
      const int th = h + 1 - kh;
      if (th < 0 || th % S) continue;
      const int o = th / S;
      if (o >= s.Ho) continue;
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
        const int tw = w + 1 - kw;
        if (tw < 0 || tw % S) continue;
        const int p = tw / S;
        if (p >= s.Wo) continue;
        Vec<T, V>::load(dy + ((b * s.Ho + o) * s.Wo + p) * s.C + c, dv);
#pragma unroll
        for (int v = 0; v < V; ++v)
          out[v] = __fadd_rn(out[v], __fmul_rn(wv[kh * 3 + kw][v], dv[v]));
      }
    }
    Vec<T, V>::store(dx + pix * s.C + c, out);
  }
}

// Block (slice, group): channel vectors [slice*ct, slice*ct + ct), dy pixels
// and x pixels of the group's contiguous share. Thread: lane cl (channel
// vector) and pixel lane pl of pt (threads past pt*ct idle).
template <typename T, int V, int S, bool DX>
__device__ void bwd_body(const T* __restrict__ x, const T* __restrict__ dy,
                         const T* __restrict__ w9, T* __restrict__ dx,
                         float* __restrict__ partial, Shape s, int ct) {
  __shared__ float red[kThreads * V];
  const int cvs = s.C / V;
  const int cl = threadIdx.x % ct, pl = threadIdx.x / ct, pt = blockDim.x / ct;
  const int cv = blockIdx.x * ct + cl;
  const bool active = cv < cvs && pl < pt;
  const int c = cv * V;
  const int g = blockIdx.y, G = gridDim.y;

  float acc[9][V];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[t][v] = 0.f;
  const long long pout = static_cast<long long>(s.B) * s.Ho * s.Wo;
  const int p0 = static_cast<int>(pout * g / G), p1 = static_cast<int>(pout * (g + 1) / G);
  if (active) {
    float dv[V], xv[V];
    for (int pix = p0 + pl; pix < p1; pix += pt) {
      const int p = pix % s.Wo;
      const int o = (pix / s.Wo) % s.Ho;
      const int b = pix / (s.Wo * s.Ho);
      Vec<T, V>::load(dy + pix * s.C + c, dv);
#pragma unroll
      for (int kh = 0; kh < 3; ++kh) {
        const int h = S * o + kh - 1;
        if (h < 0 || h >= s.H) continue;
#pragma unroll
        for (int kw = 0; kw < 3; ++kw) {
          const int w = S * p + kw - 1;
          if (w < 0 || w >= s.W) continue;
          Vec<T, V>::load(x + ((b * s.H + h) * s.W + w) * s.C + c, xv);
#pragma unroll
          for (int v = 0; v < V; ++v) acc[kh * 3 + kw][v] += xv[v] * dv[v];
        }
      }
    }
  }
  // per tap, the block's sums over its pixel lanes in lane order
  const int width = ct * V;
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    if (pl < pt)
#pragma unroll
      for (int v = 0; v < V; ++v) red[pl * width + cl * V + v] = acc[t][v];
    __syncthreads();
    for (int r = threadIdx.x; r < width; r += blockDim.x) {
      const int ch = blockIdx.x * width + r;
      if (ch >= s.C) continue;
      float sum = 0.f;
      for (int q = 0; q < pt; ++q) sum += red[q * width + r];
      partial[(g * 9 + t) * s.C + ch] = sum;
    }
    __syncthreads();
  }
  if constexpr (DX) {
    if (active) dx_body<T, V, S>(dy, w9, dx, s, c, g, G, pl, pt);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
dwconv_s2_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy, const T* __restrict__ w9,
                     T* __restrict__ dx, float* __restrict__ partial, Shape s, int ct) {
  bwd_body<T, V, 2, true>(x, dy, w9, dx, partial, s, ct);
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

// ---- stride 1: the tile kernels (K7 forward and backward, K8) ----

// The tile plan (see the note at the top), as the wrapper's `tile_plan`
// gives it, with the counts it implies.
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

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Stage the block's sub-tiles p0 ... p0 + NI - 1 (those below p1) of g into
// sm. Staged row q = sub * (TH+2) + r holds map row h0 - 1 + r of sub-tile
// sub, as TW+2 pixels of CB channels, zero outside the map: J chunks of
// epc elements; without `halo`, only the tile's own pixels (the rest is
// left as it was). Thread i takes chunk i % js (and + js, ...) of staged
// rows i / js, i / js + qs, ... (js = min(J, blockDim), qs = blockDim /
// js), so its column and channels are fixed and a row step costs a few adds.
template <typename T>
__device__ void stage(T* sm, const T* __restrict__ g, const Shape& s, const Tiles& t, int p0,
                      int p1, int c0, bool halo) {
  const int epc = t.vec16 ? 16 / static_cast<int>(sizeof(T)) : 1;   // elements per chunk
  const int KC = t.cb / epc, R = t.th + 2, J = (t.tw + 2) * KC;
  const int js = min(J, static_cast<int>(blockDim.x)), qs = blockDim.x / js;
  const int nsub = min(t.ni, p1 - p0), WC = s.W * s.C;
  if (static_cast<int>(threadIdx.x) >= qs * js) return;
  for (int j = threadIdx.x % js; j < J; j += js) {
    const int c = j / KC, off = j % KC * epc;
    if (!halo && (c == 0 || c == t.tw + 1)) continue;
    int sub = 0, r = threadIdx.x / js, cur = -1;
    while (r >= R) r -= R, ++sub;
    bool in_w = false;
    int h0 = 0, base = 0;                              // map row h0 - 1 + r is at base + r * WC
    while (sub < nsub) {
      if (sub != cur) {
        cur = sub;
        const TileAt a = pixel_tile(p0 + sub, t, c0);
        const int w = a.w0 - 1 + c;
        in_w = w >= 0 && w < s.W;
        h0 = a.h0;
        base = ((a.b * s.H + a.h0 - 1) * s.W + w) * s.C + a.c0 + off;
      }
      const int h = h0 - 1 + r;
      const bool in = in_w && h >= 0 && h < s.H;
      const T* src = in ? g + base + r * WC : g;
      T* dst = sm + (sub * R + r) * J * epc + j * epc;
      if (halo || (r != 0 && r != R - 1)) {
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
// read the same pixels at about the same time), with NT tensors staged in
// kStages buffers (tensor k with its halo where bit k of `halo` is set):
// the next kStages - 1 steps' copies are in flight while f(staged tensors,
// E, p0, p1) computes on the current one.
constexpr int kStages = 2;

template <int NT, typename T, typename F>
__device__ void walk_tiles(T* sm, const T* const (&src)[NT], int halo, const Shape& s,
                           const Tiles& t, F&& f) {
  const int g = blockIdx.y, c0 = blockIdx.x * t.cb;
  const int pt0 = static_cast<int>(static_cast<long long>(t.P) * g / t.groups);
  const int pt1 = static_cast<int>(static_cast<long long>(t.P) * (g + 1) / t.groups);
  const int E = t.ni * (t.th + 2) * (t.tw + 2) * t.cb;     // one tensor's staged tiles
  // step i's tiles into buffer i % kStages; one commit group a step, empty
  // past the end, so that wait_group<kStages - 1> always means "step done"
  auto issue = [&](int i) {
    const int p0 = pt0 + i * t.ni;
    if (p0 < pt1) {
#pragma unroll
      for (int k = 0; k < NT; ++k)
        stage(sm + (i % kStages * NT + k) * E, src[k], s, t, p0, pt1, c0, halo >> k & 1);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);
  for (int i = 0, p0 = pt0; p0 < pt1; ++i, p0 += t.ni) {
    issue(i + kStages - 1);
    cp_async_wait<kStages - 1>();
    __syncthreads();
    f(sm + i % kStages * NT * E, E, p0, pt1);
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
  walk_tiles<1>(reinterpret_cast<T*>(smem), src, 1, s, t,
                [&](const T* sm, int, int p0, int p1) {
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

// The backward block also reduces its threads' dw sums in thread order into
// partial[g][9][cs*CB ... cs*CB + CB).
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
  walk_tiles<2>(reinterpret_cast<T*>(smem), src, DX ? 3 : 1, s, t,   // K8: dy's own pixels
                [&](const T* sm, int E, int p0, int p1) {
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
  // thread q's sums at red[q][9][V]; each output sums its lane's threads
  // in thread order
  float* red = reinterpret_cast<float*>(smem);
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
    partial[(blockIdx.y * 9 + k) * s.C + c0 + ch] = sum;
  }
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

template <typename T, int V>
cudaError_t launch_bwd(const void* x, const void* dy, const void* w9, void* dx, float* partial,
                       float* dw, const Shape& s, int groups, cudaStream_t stream) {
  if (groups != groups_for(s, V)) return cudaErrorInvalidValue;
  const int ct = lanes_for(s.C / V);
  const dim3 grid((s.C / V + ct - 1) / ct, groups);
  dwconv_s2_bwd_kernel<T, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const T*>(w9),
      static_cast<T*>(dx), partial, s, ct);
  const cudaError_t e = cudaGetLastError();
  return e != cudaSuccess ? e : reduce_dw(partial, dw, groups, s.C, stream);
}

constexpr int kMaxSmem = 200 * 1024;   // dynamic shared memory a tile block may take

// The plan's counts, or false for a plan the kernels cannot take; smem: the
// block's dynamic shared memory (two buffers of staged tiles, of x, and of
// dy in the backward, whose reduction then reuses them).
bool make_tiles(const Shape& s, int esize, bool backward, int V, int cb, int tw, int th, int ni,
                int groups, Tiles* t, int* smem) {
  if (V < 1 || cb < V || cb % V || s.C % cb || tw < 1 || th < 1 || ni < 1) return false;
  const int lanes = cb / V, ncs = s.C / cb;
  if (static_cast<long long>(lanes) * tw * ni > kThreads) return false;
  const int nw = (s.W + tw - 1) / tw, nh = (s.H + th - 1) / th;
  const long long P = static_cast<long long>(s.B) * nh * nw;
  if (P * ncs >= (1LL << 31) || groups < 1 || groups > P || groups > 65535) return false;
  const long long stage = static_cast<long long>(ni) * (th + 2) * (tw + 2) * cb * esize;
  const long long red = static_cast<long long>(lanes) * tw * ni * 9 * V * 4;
  const long long staged = (backward ? 2 : 1) * kStages * stage;
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

template <typename T, int V>
cudaError_t launch_tile_fwd(const void* x, const void* w9, void* y, const Shape& s,
                            const Tiles& t, int smem, cudaStream_t stream) {
  const cudaError_t e = allow_smem<dwconv_tile_fwd_kernel<T, V>>();
  if (e != cudaSuccess) return e;
  dwconv_tile_fwd_kernel<T, V><<<dim3(t.ncs, t.groups), t.ni * t.tw * t.lanes, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w9), static_cast<T*>(y), s, t);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_tile_bwd(const void* x, const void* dy, const void* w9, void* dx,
                            float* partial, float* dw, const Shape& s, const Tiles& t, int smem,
                            cudaStream_t stream) {
  auto kern = dx ? dwconv_tile_bwd_kernel<T, V, true> : dwconv_tile_bwd_kernel<T, V, false>;
  cudaError_t e = dx ? allow_smem<dwconv_tile_bwd_kernel<T, V, true>>()
                     : allow_smem<dwconv_tile_bwd_kernel<T, V, false>>();
  if (e != cudaSuccess) return e;
  kern<<<dim3(t.ncs, t.groups), t.ni * t.tw * t.lanes, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), static_cast<const T*>(w9),
      static_cast<T*>(dx), partial, s, t);
  e = cudaGetLastError();
  return e != cudaSuccess ? e : reduce_dw(partial, dw, t.groups, s.C, stream);
}

bool make_shape(int B, int H, int W, int C, int stride, Shape* s) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || (stride != 1 && stride != 2)) return false;
  if (static_cast<long long>(B) * H * W * C >= (1LL << 31)) return false;
  *s = Shape{B, H, W, C, (H - 1) / stride + 1, (W - 1) / stride + 1};
  return true;
}

// Stride 2's channels per thread. Forward: 16-byte accesses where C allows
// (bf16 x8, fp32 x4), else bf16 pairs, else one. Backward: at most 4
// channels, so its 9 fp32 sums per channel leave registers for 3-4 blocks
// per SM.
int vec_for(int C, int dtype, bool backward) {
  if (dtype == 0) return C % 4 == 0 ? 4 : 1;
  if (C % 8 == 0 && !backward) return 8;
  return C % 4 == 0 ? 4 : C % 2 == 0 ? 2 : 1;
}

// f(T{}, V) for dtype (0 float32, 1 bfloat16) and V channels a thread; the
// stride-2 kernels take V = 1, 4 (fp32) or 1, 2, 4, 8 (bf16, 8 forward
// only); the tile kernels V = 1, 2, 4 (4 forward only).
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
      if constexpr (!Tile && !Backward) return f(__nv_bfloat16{}, std::integral_constant<int, 8>{});
      break;
  }
  return cudaErrorInvalidValue;
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
      !make_tiles(s, dtype ? 2 : 4, false, V, cb, tw, th, ni, groups, &t, &smem))
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
  Shape s;
  Tiles t;
  int smem;
  if (!make_shape(B, H, W, C, 1, &s) || dtype < 0 || dtype > 1 ||
      (dx == nullptr) != (w9 == nullptr) ||
      !make_tiles(s, dtype ? 2 : 4, true, V, cb, tw, th, ni, groups, &t, &smem))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(partial);
  float* d = static_cast<float*>(dw);
  return dispatch<true, true>(V, dtype, [&](auto e, auto v) {
    return launch_tile_bwd<decltype(e), decltype(v)::value>(x, dy, w9, dx, pt, d, s, t, smem, st);
  });
}

// Stride 2 (K9 forward).
extern "C" int cream_dwconv_s2_fwd(const void* x, const void* w9, void* y, int B, int H, int W,
                                   int C, int dtype, void* stream) {
  Shape s;
  if (!make_shape(B, H, W, C, 2, &s) || dtype < 0 || dtype > 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch<false, false>(vec_for(C, dtype, false), dtype, [&](auto e, auto v) {
    return launch_fwd<decltype(e), decltype(v)::value>(x, w9, y, s, st);
  });
}

// The number of pixel groups, hence of (9, C) fp32 partials, that
// cream_dwconv_s2_bwd takes for this shape; 0 for a shape it refuses.
extern "C" int cream_dwconv_s2_bwd_groups(int B, int H, int W, int C, int dtype) {
  Shape s;
  if (!make_shape(B, H, W, C, 2, &s) || dtype < 0 || dtype > 1) return 0;
  return groups_for(s, vec_for(C, dtype, true));
}

// Stride 2 (K9 backward): dx and dw; `partial` holds groups * 9 * C floats.
extern "C" int cream_dwconv_s2_bwd(const void* x, const void* dy, const void* w9, void* dx,
                                   void* partial, void* dw, int B, int H, int W, int C, int dtype,
                                   int groups, void* stream) {
  Shape s;
  if (!make_shape(B, H, W, C, 2, &s) || dtype < 0 || dtype > 1 || dx == nullptr ||
      w9 == nullptr)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(partial);
  float* d = static_cast<float*>(dw);
  return dispatch<false, true>(vec_for(C, dtype, true), dtype, [&](auto e, auto v) {
    return launch_bwd<decltype(e), decltype(v)::value>(x, dy, w9, dx, pt, d, s, groups, st);
  });
}
