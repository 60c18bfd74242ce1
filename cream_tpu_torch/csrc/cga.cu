// EfficientViT's cascaded group attention, the whole cascade of one window
// in one block (eval, BatchNorm folded into the weights).
//
// Replaces: cream_tpu/ops/pallas/cga.py `_kernel` (reached through
// `fused_cga`), which CascadedGroupAttention calls once per attention block
// when the cascade is fused.
//
// What it computes, per window (N = ws*ws tokens, C = heads*d channels,
// x's channels split into `heads` chunks of d; T is the input type):
//   feat = x chunk 0; for each head h:
//     feat = feat + x chunk h (h > 0), rounded to T
//     qkv  = feat . wqkv[h] (fp32 sums) + bqkv[h], rounded to T
//     q    = depthwise ks x ks conv of q over the ws x ws grid (fp32, zero
//            ring, fp32 kernel and bias), times kd^-0.5, rounded to T
//     P    = softmax(q . k^T + bias[h]) (fp32, exact row max), rounded to T
//     o    = P . v (fp32 sums), rounded to T; feat = o; cat[h] = relu(o)
//   out = cat . wproj (fp32 sums) + bproj, rounded to T
// x, out: (Nw, ws, ws, C) in T; wqkv (heads, d, 2kd+d) and wproj
// (heads*d, C) in T; biases and the depthwise kernel (heads, ks, ks, kd)
// in fp32; bias (heads, N, N) fp32, gathered from the offset table.
//
// What bounds it on Hopper: per window it reads and writes N*C values and
// does 2*N*C*(C + 2kd + d) + 2*heads*N*N*(kd + d) flops, at EfficientViT-M5
// stage 1 (N = 49, C = 288) ~13 Mflop against 56 KB of bf16 traffic:
// ~230 flop/byte, just under the H100's bf16 ridge (~295), so the least
// time is set by bytes. This simple version runs every product on CUDA
// cores in fp32 and is bound by their FMA and shared-memory load issue.
// Its design: the TPU kernel padded the window to a sublane multiple
// (7 -> 8) with a -1e9 key bucket and a query mask (a Mosaic layout rule);
// here a block of 8 warps takes one window of N tokens as they are, and the
// depthwise conv's bounds checks give the zero ring. The window's x lives in
// shared memory in T and each head's relu(o) overwrites the chunk of x that
// head consumed, so x and the concatenated heads share one N*C buffer; the
// running feat, the head's qkv (k rows at an odd stride against bank
// conflicts) and q after the conv sit beside it in fp32. The heads run in
// order (head h needs head h-1's rounded output). The two 1x1 products
// (qkv, proj) are register-tiled over 8 rows per thread with the weights
// read through L1/L2, consecutive threads on consecutive output channels.
// The attention core is cga_attend.cuh's (one warp per query row).
#include "cga_attend.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 8;  // rows of a register tile in the 1x1 products

struct Params {
  const void* x;       // (Nw, N, C) in T
  const float* bias;   // (heads, N, N)
  const void* wqkv;    // (heads, d, 2kd+d) in T
  const float* bqkv;   // (heads, 2kd+d)
  const float* dwk;    // (heads, ks, ks, kd)
  const float* dwb;    // (heads, kd)
  const void* wproj;   // (heads*d, C) in T
  const float* bproj;  // (C,)
  void* out;           // (Nw, N, C) in T
  int ws, heads, kd, d, ks;
  float scale;
};

__host__ __device__ constexpr size_t align16(size_t b) { return (b + 15) & ~size_t(15); }

// byte offsets of the shared-memory regions
struct Layout {
  size_t feat, qkv, qd, p, total;
  __host__ __device__ Layout(int N, int C, int kd, int d, size_t elem) {
    const int S = (2 * kd + d) | 1;
    feat = align16(static_cast<size_t>(N) * C * elem);
    qkv = feat + align16(sizeof(float) * N * d);
    qd = qkv + align16(sizeof(float) * N * S);
    p = qd + align16(sizeof(float) * N * kd);
    total = p + sizeof(float) * kWarps * cga::kMaxTokens;
  }
};

// out[n][col] = sum_k A[n][k] * B[k][col] for n < M, col < ncol: A in
// shared memory (row stride lda), B in device memory (row stride ldb).
// Each thread holds a tile of kRows rows of one column; `epi(n, col, acc)`
// receives the fp32 sums.
template <typename TA, typename TB, typename Epi>
__device__ __forceinline__ void block_gemm(const TA* A, int lda, const TB* __restrict__ B,
                                           int ldb, int M, int K, int ncol, Epi epi) {
  const int tiles = (M + kRows - 1) / kRows;
  for (int t = threadIdx.x; t < tiles * ncol; t += blockDim.x) {
    const int col = t % ncol, r0 = (t / ncol) * kRows;
    int off[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) off[r] = min(r0 + r, M - 1) * lda;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    const TB* b = B + col;
    for (int k = 0; k < K; ++k) {
      const float bk = cga::to_f(b[static_cast<size_t>(k) * ldb]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(cga::to_f(A[off[r] + k]), bk, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r0 + r < M) epi(r0 + r, col, acc[r]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32) cga_fused_kernel(Params p) {
  extern __shared__ float4 smem4[];
  const int N = p.ws * p.ws, kd = p.kd, d = p.d, C = p.heads * d, ks = p.ks;
  const int L = 2 * kd + d, S = L | 1, pad = ks / 2;
  const Layout lay(N, C, kd, d, sizeof(T));
  char* base = reinterpret_cast<char*>(smem4);
  T* buf = reinterpret_cast<T*>(base);                    // N * C: x, then relu(o) per head
  float* feat = reinterpret_cast<float*>(base + lay.feat);  // N * d
  float* qkv = reinterpret_cast<float*>(base + lay.qkv);    // N * S
  float* qd = reinterpret_cast<float*>(base + lay.qd);      // N * kd
  float* p_s = reinterpret_cast<float*>(base + lay.p);

  const size_t w0 = static_cast<size_t>(blockIdx.x) * N * C;
  const T* x = static_cast<const T*>(p.x) + w0;
  for (int i = threadIdx.x; i < N * C; i += blockDim.x) {
    const T xv = x[i];
    buf[i] = xv;
    if (i % C < d) feat[(i / C) * d + i % C] = cga::to_f(xv);
  }
  __syncthreads();

  const T* wqkv = static_cast<const T*>(p.wqkv);
  for (int h = 0; h < p.heads; ++h) {
    const float* bq = p.bqkv + h * L;
    block_gemm(feat, d, wqkv + static_cast<size_t>(h) * d * L, L, N, d, L,
               [&](int n, int j, float acc) { qkv[n * S + j] = cga::round_to<T>(acc + bq[j]); });
    __syncthreads();

    const float* wk = p.dwk + static_cast<size_t>(h) * ks * ks * kd;
    const float* bk = p.dwb + h * kd;
    for (int i = threadIdx.x; i < N * kd; i += blockDim.x) {
      const int n = i / kd, c = i % kd, y = n / p.ws, xx = n % p.ws;
      float acc = bk[c];
      for (int dy = 0; dy < ks; ++dy) {
        const int yy = y + dy - pad;
        if (yy < 0 || yy >= p.ws) continue;
        for (int dx = 0; dx < ks; ++dx) {
          const int xq = xx + dx - pad;
          if (xq < 0 || xq >= p.ws) continue;
          acc = fmaf(qkv[(yy * p.ws + xq) * S + c], wk[(dy * ks + dx) * kd + c], acc);
        }
      }
      qd[i] = cga::round_to<T>(acc * p.scale);
    }
    __syncthreads();

    const bool last = h + 1 == p.heads;
    const float* bias = p.bias + static_cast<size_t>(h) * N * N;
    cga::attend_rows<T>(qd, kd, qkv + kd, S, qkv + 2 * kd, S, bias, 1.f, N, kd, d, p_s,
                        [&](int n, int c, float o) {
                          T* row = buf + n * C;
                          if (!last)
                            feat[n * d + c] = cga::round_to<T>(o + cga::to_f(row[(h + 1) * d + c]));
                          row[h * d + c] = cga::from_f<T>(fmaxf(o, 0.f));
                        });
    __syncthreads();
  }

  T* out = static_cast<T*>(p.out) + w0;
  block_gemm(buf, C, static_cast<const T*>(p.wproj), C, N, C, C,
             [&](int n, int c, float acc) { out[n * C + c] = cga::from_f<T>(acc + p.bproj[c]); });
}

template <typename T>
cudaError_t launch(const Params& p, int Nw, cudaStream_t stream) {
  const size_t smem = Layout(p.ws * p.ws, p.heads * p.d, p.kd, p.d, sizeof(T)).total;
  auto kern = cga_fused_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<Nw, kWarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Bytes of shared memory a block needs (dtype: 0 float32, 1 bfloat16).
extern "C" long long cream_cga_smem_bytes(int ws, int heads, int kd, int d, int dtype) {
  return static_cast<long long>(
      Layout(ws * ws, heads * d, kd, d, dtype ? sizeof(__nv_bfloat16) : sizeof(float)).total);
}

// dtype: 0 float32, 1 bfloat16. Returns a cudaError_t (0 on success).
extern "C" int cream_cga_fused(const void* x, const void* bias, const void* wqkv,
                               const void* bqkv, const void* dwk, const void* dwb,
                               const void* wproj, const void* bproj, void* out, int Nw, int ws,
                               int heads, int kd, int d, int ks, int dtype, float scale,
                               void* stream) {
  if (Nw < 1 || ws < 1 || ws * ws > cga::kMaxTokens || heads < 1 || kd < 1 || d < 1 ||
      ks < 1 || ks % 2 == 0)
    return cudaErrorInvalidValue;
  const Params p{x, static_cast<const float*>(bias), wqkv, static_cast<const float*>(bqkv),
                 static_cast<const float*>(dwk), static_cast<const float*>(dwb), wproj,
                 static_cast<const float*>(bproj), out, ws, heads, kd, d, ks, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(p, Nw, s);
    case 1: return launch<__nv_bfloat16>(p, Nw, s);
  }
  return cudaErrorInvalidValue;
}
