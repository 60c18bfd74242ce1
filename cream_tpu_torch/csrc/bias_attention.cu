// Per-window multi-head attention with a per-head bias table, forward only.
//
// Replaces: cream_tpu/ops/pallas/bias_attention.py `_kernel` (reached
// through `fused_bias_attention`), which BiasAttention calls on its eval path.
//
// What it computes, per window w, head h and query row n:
//   out[w][h][n] = softmax_m(q[w][h][n] . k[w][h][m] * scale + bias[h][n][m]) . v[w][h]
// with fp32 scores, the exact row max, exp and division by the fp32 row sum,
// P rounded to the input type before P.V, P.V accumulated in fp32 and the
// result stored in the input type. q, k: (W, heads, N, kd); v, out:
// (W, heads, N, dv); bias: (heads, N, N) fp32. N <= 256 as it is: the TPU
// wrapper's padding of N > 128 to a lane multiple (-1e9 bias on the padded
// keys) is a Mosaic compile-time workaround that changes nothing on the real
// rows, so it is not repeated.
//
// What bounds it on Hopper: per (window, head) it reads N*(2kd+dv) values and
// writes N*dv, and does 2*N*N*(kd+dv) flops: at TinyViT's N = 49, kd = dv =
// 32 about 0.3 Mflop against 12.5 KB of bf16 traffic, 25 flop/byte, below the
// H100's ridge, so HBM bounds the work; this simple version is bound by
// CUDA-core FMAs and shared-memory loads. Its design: one block of 4 warps
// per (window, head), the TPU kernel's (window tile, head) grid cell cut to
// one window; q, k and v staged once in shared memory as fp32 (k rows at an
// odd stride so the lanes' keys fall in distinct banks); one warp per query
// row with KPL keys per lane (N <= 32*KPL) and warp-shuffle max/sum, the
// per-window core that the CGA kernels share (cga_attend.cuh). The (N, N)
// scores never leave the SM.
#include "cga_attend.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kMaxTokens = 256;

template <typename T, int KPL>
__global__ void __launch_bounds__(kWarps * 32)
bias_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      const float* __restrict__ bias, T* __restrict__ out, int heads, int N,
                      int kd, int d, float scale) {
  extern __shared__ float4 smem4[];
  const int ks = kd | 1;
  float* q_s = reinterpret_cast<float*>(smem4);  // N * kd
  float* k_s = q_s + N * kd;                      // N * ks
  float* v_s = k_s + N * ks;                      // N * d
  float* p_s = v_s + N * d;                       // kWarps * 32 * KPL
  const long long wh = blockIdx.x;                // window * heads + head
  const int h = static_cast<int>(wh % heads);
  const T* qw = q + wh * N * kd;
  const T* kw = k + wh * N * kd;
  const T* vw = v + wh * N * d;
  for (int i = threadIdx.x; i < N * kd; i += blockDim.x) {
    q_s[i] = cga::to_f(qw[i]);
    k_s[(i / kd) * ks + i % kd] = cga::to_f(kw[i]);
  }
  for (int i = threadIdx.x; i < N * d; i += blockDim.x) v_s[i] = cga::to_f(vw[i]);
  __syncthreads();
  T* ow = out + wh * N * d;
  cga::attend_rows<T, KPL>(q_s, kd, k_s, ks, v_s, d, bias + static_cast<size_t>(h) * N * N,
                           scale, N, kd, d, p_s,
                           [&](int n, int c, float o) { ow[n * d + c] = cga::from_f<T>(o); });
}

template <typename T, int KPL>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias, void* out,
                   int W, int heads, int N, int kd, int d, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(N) * (kd + (kd | 1) + d) +
                                       kWarps * 32 * KPL);
  auto kern = bias_attention_kernel<T, KPL>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const long long blocks = static_cast<long long>(W) * heads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<static_cast<unsigned>(blocks), kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<T*>(out), heads, N, kd, d, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, const float* bias, void* out,
                     int W, int heads, int N, int kd, int d, float scale, cudaStream_t s) {
  if (N <= 64) return launch<T, 2>(q, k, v, bias, out, W, heads, N, kd, d, scale, s);
  if (N <= 128) return launch<T, 4>(q, k, v, bias, out, W, heads, N, kd, d, scale, s);
  return launch<T, 8>(q, k, v, bias, out, W, heads, N, kd, d, scale, s);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Returns a cudaError_t (0 on success).
extern "C" int cream_bias_attention(const void* q, const void* k, const void* v,
                                    const void* bias, void* out, int W, int heads, int N,
                                    int kd, int d, int dtype, float scale, void* stream) {
  if (W < 1 || heads < 1 || N < 1 || N > kMaxTokens || kd < 1 || d < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  switch (dtype) {
    case 0: return dispatch<float>(q, k, v, b, out, W, heads, N, kd, d, scale, s);
    case 1: return dispatch<__nv_bfloat16>(q, k, v, b, out, W, heads, N, kd, d, scale, s);
  }
  return cudaErrorInvalidValue;
}
