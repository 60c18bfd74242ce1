// Window bias-attention forward, read straight from the NHWC qkv tensor.
//
// Replaces: cream_tpu/ops/pallas/window_attention.py `_kernel` (reached
// through `fused_window_attention` -> `_fwa` -> `_pallas_fwd`), the forward
// of the fused window attention that TinyViT and Swin call once per block.
//
// What it computes, per window, head and query row n:
//   out[n] = softmax(q[n] . K^T * scale + bias[h][n] (+ mask[win][n])) . V
// with fp32 scores, the exact per-row max, fp32 sums, P rounded to the input
// type before P.V, P.V accumulated in fp32 and the result stored in the input
// type at (B, H, W, heads*dv). An optional qkv projection bias is added to
// q/k/v on load and rounded to the input type, as the caller's GEMM epilogue
// would have done. Two lane packings of the qkv row: head_major
// ([q_h|k_h|v_h] per head) and qkv_major ([q all|k all|v all]).
//
// What bounds it on Hopper: per (window, head) the block reads N*(2kd+dv)
// input values once from HBM and does 2*N*N*(kd+dv) flops (N = 196 at
// TinyViT-21M stage 2: ~4.9 Mflop against ~50 KB of qkv and output, well
// above the HBM ridge), so this simple version is bound by CUDA-core FMAs and
// shared-memory loads, not by HBM. Its design: one block per (head, window,
// batch) with the window offsets computed from blockIdx (no HBM transpose on
// either side); K and V of that head staged once in shared memory as fp32,
// K rows padded to an odd multiple of 16 bytes so the float4 reads of eight
// lanes on eight keys hit distinct banks; one warp per query row with the
// scores in registers (lanes stride over keys, ragged keys masked by the
// index bound) and max/sum by warp shuffles; P goes through a per-warp row
// in shared memory and each lane accumulates one output channel. The (N, N)
// scores never leave the SM. Tensor-core (mma/wgmma) tiles are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;
constexpr int kMaxTokens = 256;
constexpr int kKeysPerLane = kMaxTokens / 32;

struct Params {
  const void* qkv;       // (B, H, W, L), L = heads * (2*kd + dv)
  const float* bias;     // (heads, N, N)
  const float* mask;     // (nH*nW, N, N) or null
  const void* qkv_bias;  // (L,) in the input type, or null
  void* out;             // (B, H, W, heads*dv)
  int H, W, heads, window, layout;  // layout 0: head_major, 1: qkv_major
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x as the input type holds it (round to nearest even through T)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

template <typename T, int KD, int DV>
__global__ void __launch_bounds__(kWarps * 32)
window_attention_fwd_kernel(Params p) {
  constexpr int KS = KD + 4;  // padded K row stride in floats
  extern __shared__ float4 smem4[];
  const int N = p.window * p.window;
  float* k_s = reinterpret_cast<float*>(smem4);  // N * KS
  float* v_s = k_s + N * KS;                      // N * DV
  float* p_s = v_s + N * DV;                      // kWarps * N

  const T* qkv = static_cast<const T*>(p.qkv);
  const T* qb = static_cast<const T*>(p.qkv_bias);
  T* out = static_cast<T*>(p.out);
  const int h = blockIdx.x, win = blockIdx.y, b = blockIdx.z;
  const int nW = p.W / p.window;
  const int y0 = (win / nW) * p.window, x0 = (win % nW) * p.window;
  const int L = p.heads * (2 * KD + DV);
  int qo, ko, vo;
  if (p.layout == 0) {
    qo = h * (2 * KD + DV); ko = qo + KD; vo = qo + 2 * KD;
  } else {
    qo = h * KD; ko = p.heads * KD + h * KD; vo = 2 * p.heads * KD + h * DV;
  }
  // pixel index of window token t: the window is row-major inside the map
  auto pix = [&](int t) -> long long {
    return (static_cast<long long>(b) * p.H + y0 + t / p.window) * p.W + x0 + t % p.window;
  };

  for (int i = threadIdx.x; i < N * KD; i += blockDim.x) {
    const int t = i / KD, d = i % KD;
    float x = to_f(qkv[pix(t) * L + ko + d]);
    if (qb) x = round_to<T>(x + to_f(qb[ko + d]));
    k_s[t * KS + d] = x;
  }
  for (int i = threadIdx.x; i < N * DV; i += blockDim.x) {
    const int t = i / DV, d = i % DV;
    float x = to_f(qkv[pix(t) * L + vo + d]);
    if (qb) x = round_to<T>(x + to_f(qb[vo + d]));
    v_s[t * DV + d] = x;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* p_w = p_s + warp * N;
  const float* bias_h = p.bias + static_cast<size_t>(h) * N * N;
  const float* mask_w = p.mask ? p.mask + static_cast<size_t>(win) * N * N : nullptr;

  for (int n = warp; n < N; n += kWarps) {
    // the query row, held whole by every lane (a broadcast load)
    float q[KD];
    const T* qp = qkv + pix(n) * L + qo;
#pragma unroll
    for (int d = 0; d < KD; ++d) {
      float x = to_f(qp[d]);
      if (qb) x = round_to<T>(x + to_f(qb[qo + d]));
      q[d] = x;
    }

    float s[kKeysPerLane];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      const int m = lane + 32 * i;
      s[i] = -INFINITY;
      if (m < N) {
        const float4* kr = reinterpret_cast<const float4*>(k_s + m * KS);
        float acc = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < KD / 4; ++d4) {
          const float4 kk = kr[d4];
          acc = fmaf(q[4 * d4 + 0], kk.x, acc);
          acc = fmaf(q[4 * d4 + 1], kk.y, acc);
          acc = fmaf(q[4 * d4 + 2], kk.z, acc);
          acc = fmaf(q[4 * d4 + 3], kk.w, acc);
        }
        float sc = acc * p.scale + bias_h[n * N + m];
        if (mask_w) sc += mask_w[n * N + m];
        s[i] = sc;
        mx = fmaxf(mx, sc);
      }
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));

    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      const float e = (lane + 32 * i < N) ? expf(s[i] - mx) : 0.f;
      s[i] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);

#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      const int m = lane + 32 * i;
      if (m < N) p_w[m] = round_to<T>(s[i] / sum);
    }
    __syncwarp();

    T* op = out + pix(n) * (p.heads * DV) + h * DV;
    for (int d = lane; d < DV; d += 32) {
      float acc = 0.f;
      for (int m = 0; m < N; ++m) acc = fmaf(p_w[m], v_s[m * DV + d], acc);
      op[d] = from_f<T>(acc);
    }
    __syncwarp();  // p_w is rewritten by this warp's next row
  }
}

template <typename T, int KD, int DV>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const int N = p.window * p.window;
  const size_t smem = sizeof(float) *
      (static_cast<size_t>(N) * (KD + 4) + static_cast<size_t>(N) * DV +
       static_cast<size_t>(kWarps) * N);
  auto kern = window_attention_fwd_kernel<T, KD, DV>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(p.heads, (p.H / p.window) * (p.W / p.window), B);
  kern<<<grid, kWarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int KD>
cudaError_t dispatch_dv(int dv, const Params& p, int B, cudaStream_t s) {
  switch (dv) {
    case 16: return launch<T, KD, 16>(p, B, s);
    case 32: return launch<T, KD, 32>(p, B, s);
    case 64: return launch<T, KD, 64>(p, B, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_kd(int kd, int dv, const Params& p, int B, cudaStream_t s) {
  switch (kd) {
    case 16: return dispatch_dv<T, 16>(dv, p, B, s);
    case 32: return dispatch_dv<T, 32>(dv, p, B, s);
    case 64: return dispatch_dv<T, 64>(dv, p, B, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Returns a cudaError_t (0 on success).
extern "C" int cream_window_attention_fwd(
    const void* qkv, const void* bias, const void* mask, const void* qkv_bias,
    void* out, int B, int H, int W, int heads, int kd, int dv, int window,
    int layout, int dtype, float scale, void* stream) {
  if (window * window > kMaxTokens || H % window || W % window || layout < 0 || layout > 1)
    return cudaErrorInvalidValue;
  const Params p{qkv, static_cast<const float*>(bias), static_cast<const float*>(mask),
                 qkv_bias, out, H, W, heads, window, layout, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_kd<float>(kd, dv, p, B, s);
    case 1: return dispatch_kd<__nv_bfloat16>(kd, dv, p, B, s);
  }
  return cudaErrorInvalidValue;
}
