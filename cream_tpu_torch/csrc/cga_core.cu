// The attention core of EfficientViT's cascaded group attention, one head.
//
// Replaces: cream_tpu/ops/pallas/cga_core.py `_kernel` (reached through
// `cga_attention`), which CascadedGroupAttention calls once per head when
// the attention core alone is fused (the qkv and depthwise convolutions stay
// library ops).
//
// What it computes, per window w and query row n:
//   out[w][n] = softmax_m(q[w][n] . k[w][m] * scale + bias[n][m]) . v[w]
// with fp32 scores rounded as (S * scale) + bias, the exact row max, exp and
// division by the fp32 row sum, P rounded to the input type before P.V, P.V
// accumulated in fp32 and the result stored in the input type. q, k:
// (W, N, kd); v, out: (W, N, d); bias: (N, N) fp32, already gathered for
// this head.
//
// What bounds it on Hopper: per window it reads N*(2kd+d) values and writes
// N*d, and does 2*N*N*(kd+d) flops: at EfficientViT's N = 49, kd = 16,
// d = 64 about 0.4 Mflop against 12.5 KB of bf16 traffic, 30 flop/byte,
// below the H100's ridge, so HBM bounds the work.
//
// bfloat16: both products on the tensor cores, the core shared with K3
// (bias_attend_mma.cuh). The TPU kernel packed G windows block-diagonally
// into one GEMM with -1e9 cross-window terms to fill its matrix unit; here a
// 49-token window is one block of 4 warps, a 16-row query strip each (K1's
// split), and the 4x4 windows of stage 2 (16 tokens, one strip) go 4 to a
// block, a warp each. One instance: N <= 64 (4 key tiles), every head dim
// by a loop over 16-wide tiles. The CUDA-core bf16 path it replaces took
// 1.219 ms per EfficientViT-M5 bs512 forward (28 launches) on an H100 80GB
// HBM3 at 700 W.
// float32: the CUDA-core kernel (tensor cores would round the inputs to
// TF32, past the fp32 bound): one block of 4 warps per window, q/k/v staged
// as fp32 (k rows at an odd stride so the lanes' keys fall in distinct
// banks), one warp per query row with two keys per lane and warp-shuffle
// max/sum (cga_attend.cuh, shared with K4).
#include "bias_attend_mma.cuh"
#include "cga_attend.cuh"

namespace {

constexpr int kWarps = 4;

__global__ void __launch_bounds__(kWarps * 32)
cga_core_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ bias,
                float* __restrict__ out, int N, int kd, int d, float scale) {
  extern __shared__ float4 smem4[];
  const int ks = kd | 1;
  float* q_s = reinterpret_cast<float*>(smem4);  // N * kd
  float* k_s = q_s + N * kd;                      // N * ks
  float* v_s = k_s + N * ks;                      // N * d
  float* p_s = v_s + N * d;                       // kWarps * kMaxTokens
  const long long w = blockIdx.x;
  const float* qw = q + w * N * kd;
  const float* kw = k + w * N * kd;
  const float* vw = v + w * N * d;
  for (int i = threadIdx.x; i < N * kd; i += blockDim.x) {
    q_s[i] = qw[i];
    k_s[(i / kd) * ks + i % kd] = kw[i];
  }
  for (int i = threadIdx.x; i < N * d; i += blockDim.x) v_s[i] = vw[i];
  __syncthreads();
  float* ow = out + w * N * d;
  cga::attend_rows<float>(q_s, kd, k_s, ks, v_s, d, bias, scale, N, kd, d, p_s,
                          [&](int n, int c, float o) { ow[n * d + c] = o; });
}

cudaError_t launch_fp32(const void* q, const void* k, const void* v, const float* bias,
                        void* out, int W, int N, int kd, int d, float scale,
                        cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(N) * (kd + (kd | 1) + d) +
                                       kWarps * cga::kMaxTokens);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cga_core_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  cga_core_kernel<<<W, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      bias, static_cast<float*>(out), N, kd, d, scale);
  return cudaGetLastError();
}

__global__ void __launch_bounds__(bam::kThreads) cga_core_mma_kernel(bam::Params p) {
  bam::attend_block<cga::kMaxTokens / 16>(p);
}

}  // namespace

// dtype: 0 float32 (CUDA cores), 1 bfloat16 (tensor cores; q, k and v must
// start on a 16-byte boundary). Returns a cudaError_t (0 on success).
extern "C" int cream_cga_core(const void* q, const void* k, const void* v, const void* bias,
                              void* out, int W, int N, int kd, int d, int dtype, float scale,
                              void* stream) {
  if (W < 1 || N < 1 || N > cga::kMaxTokens || kd < 1 || d < 1) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  switch (dtype) {
    case 0: return launch_fp32(q, k, v, b, out, W, N, kd, d, scale, s);
    case 1:
      return bam::launch(cga_core_mma_kernel,
                         bam::Params{static_cast<const bam::bf16*>(q),
                                     static_cast<const bam::bf16*>(k),
                                     static_cast<const bam::bf16*>(v), b,
                                     static_cast<bam::bf16*>(out), W, 1, N, kd, d, scale},
                         s);
  }
  return cudaErrorInvalidValue;
}
