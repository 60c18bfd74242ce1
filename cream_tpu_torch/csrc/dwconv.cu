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
// so HBM bandwidth bounds every launch (x read, y written; x and dy read, dx
// written). Its design: a thread owns 8 channels (bf16, forward) or 4 of one
// pixel where C allows, so every access is 8-16 bytes and a warp's are
// coalesced along C; the other taps of a pixel's neighbourhood come from
// L1/L2; index math is 32-bit. dx is a
// gather (each dx pixel reads the dy taps that reach it), so no atomics. dw:
// each block owns a channel slice and a contiguous range of dy pixels, keeps
// 9 fp32 sums per channel in registers, reduces them across its pixel lanes
// in shared memory in a fixed order and writes one (9, slice) partial; a
// second small kernel sums the partials in a fixed order, so dw has the same
// bits on every launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

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
dwconv_s1_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w9, T* __restrict__ y,
                     Shape s) {
  fwd_body<T, V, 1>(x, w9, y, s);
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
dwconv_s1_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy, const T* __restrict__ w9,
                     T* __restrict__ dx, float* __restrict__ partial, Shape s, int ct) {
  bwd_body<T, V, 1, true>(x, dy, w9, dx, partial, s, ct);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
dwconv_s2_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dy, const T* __restrict__ w9,
                     T* __restrict__ dx, float* __restrict__ partial, Shape s, int ct) {
  bwd_body<T, V, 2, true>(x, dy, w9, dx, partial, s, ct);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
dwconv_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                    float* __restrict__ partial, Shape s, int ct) {
  bwd_body<T, V, 1, false>(x, dy, nullptr, nullptr, partial, s, ct);
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

template <typename T, int V>
cudaError_t launch_fwd(const void* x, const void* w9, void* y, const Shape& s, int stride,
                       cudaStream_t stream) {
  const long long total = static_cast<long long>(s.B) * s.Ho * s.Wo * (s.C / V);
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;
  auto kern = stride == 1 ? dwconv_s1_fwd_kernel<T, V> : dwconv_s2_fwd_kernel<T, V>;
  kern<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w9), static_cast<T*>(y), s);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_bwd(const void* x, const void* dy, const void* w9, void* dx, float* partial,
                       float* dw, const Shape& s, int stride, int groups, cudaStream_t stream) {
  if (groups != groups_for(s, V)) return cudaErrorInvalidValue;
  const int ct = lanes_for(s.C / V);
  const dim3 grid((s.C / V + ct - 1) / ct, groups);
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  if (dx == nullptr) {
    if (stride != 1) return cudaErrorInvalidValue;
    dwconv_wgrad_kernel<T, V><<<grid, kThreads, 0, stream>>>(xt, dyt, partial, s, ct);
  } else {
    auto kern = stride == 1 ? dwconv_s1_bwd_kernel<T, V> : dwconv_s2_bwd_kernel<T, V>;
    kern<<<grid, kThreads, 0, stream>>>(xt, dyt, static_cast<const T*>(w9), static_cast<T*>(dx),
                                        partial, s, ct);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int count = 9 * s.C;
  dwconv_dw_reduce_kernel<<<(count + kReduceLanes - 1) / kReduceLanes,
                            kReduceLanes * kReduceParts, 0, stream>>>(partial, dw, groups, count);
  return cudaGetLastError();
}

bool make_shape(int B, int H, int W, int C, int stride, Shape* s) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || (stride != 1 && stride != 2)) return false;
  if (static_cast<long long>(B) * H * W * C >= (1LL << 31)) return false;
  *s = Shape{B, H, W, C, (H - 1) / stride + 1, (W - 1) / stride + 1};
  return true;
}

// Channels per thread. Forward: 16-byte accesses where C allows (bf16 x8,
// fp32 x4), else bf16 pairs, else one. Backward: at most 4 channels, so its
// 9 fp32 sums per channel leave registers for 3-4 blocks per SM.
int vec_for(int C, int dtype, bool backward) {
  if (dtype == 0) return C % 4 == 0 ? 4 : 1;
  if (C % 8 == 0 && !backward) return 8;
  return C % 4 == 0 ? 4 : C % 2 == 0 ? 2 : 1;
}

template <bool Backward, typename F>
cudaError_t dispatch(int C, int dtype, F&& f) {
  switch (dtype * 16 + vec_for(C, dtype, Backward)) {
    case 1: return f(float{}, std::integral_constant<int, 1>{});
    case 4: return f(float{}, std::integral_constant<int, 4>{});
    case 17: return f(__nv_bfloat16{}, std::integral_constant<int, 1>{});
    case 18: return f(__nv_bfloat16{}, std::integral_constant<int, 2>{});
    case 20: return f(__nv_bfloat16{}, std::integral_constant<int, 4>{});
    case 24:
      if constexpr (!Backward) return f(__nv_bfloat16{}, std::integral_constant<int, 8>{});
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Returns a cudaError_t (0 on success).
extern "C" int cream_dwconv_fwd(const void* x, const void* w9, void* y, int B, int H, int W,
                                int C, int stride, int dtype, void* stream) {
  Shape s;
  if (!make_shape(B, H, W, C, stride, &s) || dtype < 0 || dtype > 1) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch<false>(C, dtype, [&](auto t, auto v) {
    return launch_fwd<decltype(t), decltype(v)::value>(x, w9, y, s, stride, st);
  });
}

// The number of pixel groups, hence of (9, C) fp32 partials, that
// cream_dwconv_bwd takes for this shape; 0 for a shape it refuses.
extern "C" int cream_dwconv_bwd_groups(int B, int H, int W, int C, int stride, int dtype) {
  Shape s;
  if (!make_shape(B, H, W, C, stride, &s) || dtype < 0 || dtype > 1) return 0;
  return groups_for(s, vec_for(C, dtype, true));
}

// dx and w9 both null: the weight grad alone (stride 1). `partial` holds
// groups * 9 * C floats; dw is (9, C) fp32. Returns a cudaError_t.
extern "C" int cream_dwconv_bwd(const void* x, const void* dy, const void* w9, void* dx,
                                void* partial, void* dw, int B, int H, int W, int C, int stride,
                                int dtype, int groups, void* stream) {
  Shape s;
  if (!make_shape(B, H, W, C, stride, &s) || dtype < 0 || dtype > 1 ||
      (dx == nullptr) != (w9 == nullptr))
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(partial);
  float* d = static_cast<float*>(dw);
  return dispatch<true>(C, dtype, [&](auto t, auto v) {
    return launch_bwd<decltype(t), decltype(v)::value>(x, dy, w9, dx, pt, d, s, stride, groups,
                                                       st);
  });
}
