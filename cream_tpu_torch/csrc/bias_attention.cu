// Per-window multi-head attention with a per-head bias table, forward only.
//
// Replaces: cream_tpu/ops/pallas/bias_attention.py `_kernel` (reached
// through `fused_bias_attention`), which BiasAttention calls on its eval path.
//
// What it computes, per window w, head h and query row n:
//   out[w][h][n] = softmax_m(q[w][h][n] . k[w][h][m] * scale + bias[h][n][m]) . v[w][h]
// with fp32 scores rounded as (S * scale) + bias, the exact row max, exp and
// division by the fp32 row sum, P rounded to the input type before P.V, P.V
// accumulated in fp32 and the result stored in the input type. q, k:
// (W, heads, N, kd); v, out: (W, heads, N, dv); bias: (heads, N, N) fp32.
// N <= 256 as it is: the TPU wrapper's padding of N > 128 to a lane multiple
// (-1e9 bias on the padded keys) is a Mosaic compile-time workaround that
// changes nothing on the real rows, so it is not repeated.
//
// What bounds it on Hopper: per (window, head) it reads N*(2kd+dv) values and
// writes N*dv, and does 2*N*N*(kd+dv) flops: at TinyViT's N = 49, kd = dv =
// 32 about 0.3 Mflop against 12.5 KB of bf16 traffic, 25 flop/byte, below the
// H100's ridge, so HBM bounds the work. The fp32 bias is read from L2 once
// per (window, head), 4 bytes a score.
//
// bfloat16: both products on the tensor cores, the core shared with K5
// (bias_attend_mma.cuh): a block of 4 warps per (window, head), or per 2 or
// 4 of them for windows of 32 or 16 tokens; q, k and v staged as bf16 with
// rows and head dims zero-padded to multiples of 16; each warp takes 16-row
// query strips whose scores stay in registers (NKT 16-key tiles, in buckets
// 4/9/13/16 as K1's). The CUDA-core bf16 path it replaces (one warp per
// query row, every operand a scalar from shared memory) took 1.201 ms at
// (4096,6,49,32) and 4.028 at (256,12,196,32) on an H100 80GB HBM3 at 700 W.
// float32: the CUDA-core kernel (tensor cores would round the inputs to
// TF32, past the fp32 bound): one block of 4 warps per (window, head), q, k
// and v staged as fp32 (k rows at an odd stride so the lanes' keys fall in
// distinct banks), one warp per query row with KPL keys per lane (N <=
// 32*KPL) and warp-shuffle max/sum, the core K4 and K5 share
// (cga_attend.cuh).
#include "bias_attend_mma.cuh"
#include "cga_attend.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kMaxTokens = 256;

template <int KPL>
__global__ void __launch_bounds__(kWarps * 32)
bias_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ bias,
                      float* __restrict__ out, int heads, int N, int kd, int d, float scale) {
  extern __shared__ float4 smem4[];
  const int ks = kd | 1;
  float* q_s = reinterpret_cast<float*>(smem4);  // N * kd
  float* k_s = q_s + N * kd;                      // N * ks
  float* v_s = k_s + N * ks;                      // N * d
  float* p_s = v_s + N * d;                       // kWarps * 32 * KPL
  const long long wh = blockIdx.x;                // window * heads + head
  const int h = static_cast<int>(wh % heads);
  const float* qw = q + wh * N * kd;
  const float* kw = k + wh * N * kd;
  const float* vw = v + wh * N * d;
  for (int i = threadIdx.x; i < N * kd; i += blockDim.x) {
    q_s[i] = qw[i];
    k_s[(i / kd) * ks + i % kd] = kw[i];
  }
  for (int i = threadIdx.x; i < N * d; i += blockDim.x) v_s[i] = vw[i];
  __syncthreads();
  float* ow = out + wh * N * d;
  cga::attend_rows<float, KPL>(q_s, kd, k_s, ks, v_s, d, bias + static_cast<size_t>(h) * N * N,
                               scale, N, kd, d, p_s,
                               [&](int n, int c, float o) { ow[n * d + c] = o; });
}

template <int KPL>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, const float* bias,
                        void* out, int W, int heads, int N, int kd, int d, float scale,
                        cudaStream_t stream) {
  const size_t smem = sizeof(float) * (static_cast<size_t>(N) * (kd + (kd | 1) + d) +
                                       kWarps * 32 * KPL);
  auto kern = bias_attention_kernel<KPL>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const long long blocks = static_cast<long long>(W) * heads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<static_cast<unsigned>(blocks), kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      bias, static_cast<float*>(out), heads, N, kd, d, scale);
  return cudaGetLastError();
}

template <int NKT>
__global__ void __launch_bounds__(bam::kThreads) bias_attention_mma_kernel(bam::Params p) {
  bam::attend_block<NKT>(p);
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v, const float* bias,
                        void* out, int W, int heads, int N, int kd, int d, float scale,
                        cudaStream_t s) {
  const bam::Params p{static_cast<const bam::bf16*>(q), static_cast<const bam::bf16*>(k),
                      static_cast<const bam::bf16*>(v), bias, static_cast<bam::bf16*>(out),
                      static_cast<long long>(W) * heads, heads, N, kd, d, scale};
  if (N <= 64) return bam::launch(bias_attention_mma_kernel<4>, p, s);
  if (N <= 144) return bam::launch(bias_attention_mma_kernel<9>, p, s);
  if (N <= 208) return bam::launch(bias_attention_mma_kernel<13>, p, s);
  return bam::launch(bias_attention_mma_kernel<16>, p, s);
}

}  // namespace

// dtype: 0 float32 (CUDA cores), 1 bfloat16 (tensor cores; q, k and v must
// start on a 16-byte boundary). Returns a cudaError_t (0 on success).
extern "C" int cream_bias_attention(const void* q, const void* k, const void* v,
                                    const void* bias, void* out, int W, int heads, int N,
                                    int kd, int d, int dtype, float scale, void* stream) {
  if (W < 1 || heads < 1 || N < 1 || N > kMaxTokens || kd < 1 || d < 1)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  switch (dtype) {
    case 0:
      if (N <= 64) return launch_fp32<2>(q, k, v, b, out, W, heads, N, kd, d, scale, s);
      if (N <= 128) return launch_fp32<4>(q, k, v, b, out, W, heads, N, kd, d, scale, s);
      return launch_fp32<8>(q, k, v, b, out, W, heads, N, kd, d, scale, s);
    case 1: return launch_bf16(q, k, v, b, out, W, heads, N, kd, d, scale, s);
  }
  return cudaErrorInvalidValue;
}
