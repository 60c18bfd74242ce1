// Shared pieces of the two cascaded-group-attention kernels (cga_core.cu,
// cga.cu): dtype conversions and the per-window attention core.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cga {

constexpr int kMaxTokens = 64;  // keys per window: two per lane of a warp

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x as the type T holds it (round to nearest even through T)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Attention of one window, N <= 64 tokens, one warp per query row:
//   s[n][m] = (q[n] . k[m]) * scale + bias[n][m]   (fp32)
//   P = softmax_m(s) with the exact row max, exp and division by the fp32
//       row sum, then rounded to T
//   o[n][c] = sum_m P[n][m] v[m][c] accumulated in fp32, rounded to T
// q, k, v are fp32 rows in shared memory (row strides qs, ks, vs; ks odd, so
// the lanes' key rows fall in distinct banks); bias is (N, N) fp32 in device
// memory; p_s holds kMaxTokens floats per warp. `emit(n, c, o)` receives
// each output element, already rounded to T. Each lane keeps its keys'
// scores in registers and its share (c = lane + 32 t) of the output row.
template <typename T, typename Emit>
__device__ __forceinline__ void attend_rows(const float* q, int qs, const float* k, int ks,
                                            const float* v, int vs, const float* bias,
                                            float scale, int N, int kd, int d, float* p_s,
                                            Emit emit) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warps = blockDim.x / 32;
  float* p_w = p_s + warp * kMaxTokens;
  for (int n = warp; n < N; n += warps) {
    const float* qr = q + n * qs;
    float s[2];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = lane + 32 * i;
      s[i] = -INFINITY;
      if (m < N) {
        const float* kr = k + m * ks;
        float acc = 0.f;
        for (int c = 0; c < kd; ++c) acc = fmaf(qr[c], kr[c], acc);
        s[i] = fmaf(acc, scale, bias[n * N + m]);
        mx = fmaxf(mx, s[i]);
      }
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      s[i] = (lane + 32 * i < N) ? expf(s[i] - mx) : 0.f;
      sum += s[i];
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = lane + 32 * i;
      if (m < N) p_w[m] = round_to<T>(s[i] / sum);
    }
    __syncwarp();
    for (int c = lane; c < d; c += 32) {
      float acc = 0.f;
      for (int m = 0; m < N; ++m) acc = fmaf(p_w[m], v[m * vs + c], acc);
      emit(n, c, round_to<T>(acc));
    }
    __syncwarp();  // p_w is rewritten by this warp's next row
  }
}

}  // namespace cga
