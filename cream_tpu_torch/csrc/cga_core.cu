// The attention core of EfficientViT's cascaded group attention, one head.
//
// Replaces: cream_tpu/ops/pallas/cga_core.py `_kernel` (reached through
// `cga_attention`), which CascadedGroupAttention calls once per head when
// the attention core alone is fused (the qkv and depthwise convolutions stay
// library ops).
//
// What it computes, per window w and query row n:
//   out[w][n] = softmax_m(q[w][n] . k[w][m] * scale + bias[n][m]) . v[w]
// with fp32 scores, the exact row max, exp and division by the fp32 row sum,
// P rounded to the input type before P.V, P.V accumulated in fp32 and the
// result stored in the input type. q, k: (W, N, kd); v, out: (W, N, d);
// bias: (N, N) fp32, already gathered for this head.
//
// What bounds it on Hopper: per window it reads N*(2kd+d) values and writes
// N*d, and does 2*N*N*(kd+d) flops: at EfficientViT's N = 49, kd = 16,
// d = 64 about 0.4 Mflop against 12.5 KB of bf16 traffic, 30 flop/byte,
// below the H100's ridge, so HBM bounds the work and this simple version is
// bound by CUDA-core FMAs and shared-memory loads. Its design: the TPU
// kernel packed G windows block-diagonally into one GEMM with -1e9
// cross-window terms (a Mosaic schedule choice); here each window is one
// block of 4 warps, q/k/v staged once in shared memory as fp32 (k rows at an
// odd stride so the lanes' keys fall in distinct banks), one warp per query
// row with two keys per lane and warp-shuffle max/sum (cga_attend.cuh). The
// (N, N) scores never leave the SM.
#include "cga_attend.cuh"

namespace {

constexpr int kWarps = 4;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
cga_core_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const float* __restrict__ bias, T* __restrict__ out, int N, int kd, int d,
                float scale) {
  extern __shared__ float4 smem4[];
  const int ks = kd | 1;
  float* q_s = reinterpret_cast<float*>(smem4);  // N * kd
  float* k_s = q_s + N * kd;                      // N * ks
  float* v_s = k_s + N * ks;                      // N * d
  float* p_s = v_s + N * d;                       // kWarps * kMaxTokens
  const long long w = blockIdx.x;
  const T* qw = q + w * N * kd;
  const T* kw = k + w * N * kd;
  const T* vw = v + w * N * d;
  for (int i = threadIdx.x; i < N * kd; i += blockDim.x) {
    q_s[i] = cga::to_f(qw[i]);
    k_s[(i / kd) * ks + i % kd] = cga::to_f(kw[i]);
  }
  for (int i = threadIdx.x; i < N * d; i += blockDim.x) v_s[i] = cga::to_f(vw[i]);
  __syncthreads();
  T* ow = out + w * N * d;
  cga::attend_rows<T>(q_s, kd, k_s, ks, v_s, d, bias, scale, N, kd, d, p_s,
                      [&](int n, int c, float o) { ow[n * d + c] = cga::from_f<T>(o); });
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias, void* out,
                   int W, int N, int kd, int d, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(N) * (kd + (kd | 1) + d) +
                                       kWarps * cga::kMaxTokens);
  auto kern = cga_core_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<W, kWarps * 32, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                         static_cast<const T*>(v), bias, static_cast<T*>(out),
                                         N, kd, d, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Returns a cudaError_t (0 on success).
extern "C" int cream_cga_core(const void* q, const void* k, const void* v, const void* bias,
                              void* out, int W, int N, int kd, int d, int dtype, float scale,
                              void* stream) {
  if (W < 1 || N < 1 || N > cga::kMaxTokens || kd < 1 || d < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  switch (dtype) {
    case 0: return launch<float>(q, k, v, b, out, W, N, kd, d, scale, s);
    case 1: return launch<__nv_bfloat16>(q, k, v, b, out, W, N, kd, d, scale, s);
  }
  return cudaErrorInvalidValue;
}
