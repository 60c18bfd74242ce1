// Window bias-attention backward, read straight from the NHWC qkv tensor.
//
// Replaces: cream_tpu/ops/pallas/window_attention.py `_bwd_kernel` (reached
// through `_fwa_bwd`, the custom_vjp backward of `fused_window_attention`),
// run once per attention block in every training step of TinyViT and Swin.
//
// What it computes, per window and head (recompute-P, as the JAX kernel):
//   S  = Q.K^T * scale + bias[h] (+ mask[win]),  P = softmax(S)   (fp32)
//   dP = dO.V^T,  dS = P * (dP - rowsum(dP * P))
//   dQ = dS.K * scale,  dK = dS^T.Q * scale,  dV = P^T.dO        (fp32 sums)
// with q/k/v bias-folded and rounded to the input type on load (as in the
// forward), P and dS kept in fp32 (P is not rounded, unlike the forward's),
// dQ/dK/dV stored in the input type at the qkv lanes of `layout`, and
// dbias[h] = sum of dS over every window and image, in fp32. The mask gets
// no gradient; d(qkv bias) is a token sum the caller takes of dqkv.
//
// What bounds it on Hopper: per (window, head) it reads N*(2kd+dv) values
// of qkv and N*dv of dout and writes N*(2kd+dv), and does 5 products of
// 2*N*N*d flops: at TinyViT-21M's stage 2 (N = 196, d = 32, bs256) 37.8
// Gflop, 0.038 ms at 989 TFLOP/s, against 0.082 ms of bytes at 3.35 TB/s.
// The bound is bytes. The fp32 bias is read from L2 once per (window, head)
// and the block's dbias partial read and written once per window: at
// stage 2 ~5x the bytes of qkv, dout and dqkv.
//
// dbias, in both dtypes: a block adds its dS into a partial of its own,
// (groups, heads, N, N) fp32 in device memory (its first window stores, the
// others add), and dbias_reduce_kernel sums the partials over the groups in
// a fixed order. No atomics: every launch gives the same bits.
//
// bfloat16 (the model path): all five products on the tensor cores,
// mma.sync m16n8k16 with fp32 sums (bf16_mma.cuh). It replaces PR 2's
// CUDA-core bf16 kernel (39.37 ms per TinyViT-21M-224 bs256 train step).
// One block per (head, run of consecutive windows), a warp per 16-key tile
// of the window (up to 16 warps, held to 128 registers a thread so that
// 16 warps fit an SM); per window:
//   * Q, K, V (bias-folded) and dO go to shared memory as bf16, rows padded
//     to whole key tiles with zeros and by 16 bytes (conflict-free fragment
//     loads), every load of a thread in flight at once.
//   * the query strips (16 rows) in turn, every warp on the strip and its
//     own keys: S = Q.K^T and dP = dO.V^T (2 n-tiles each, in registers);
//     the score; the exact row max and then the sums of exp(S - max) and of
//     dP * exp(S - max) over the whole row, from the warps' shares through
//     shared memory, summed in warp order (two barriers); P = e / sum and
//     dS = P * (dP - rowsum(dP * P)) in fp32, added into the dbias partial.
//   * then, with P and dS split hi/lo and transposed in registers
//     (movmatrix), dV += P^T.dO and dK += dS^T.Q for the warp's keys, in
//     registers across the strips (dO and Q through ldmatrix.trans), and the
//     warp's share of dQ = dS.K, which goes through shared memory and is
//     summed over the warps in warp order (a third barrier). P and dS are
//     computed once per element; nothing of size N x N is stored.
//   * the three products with an fp32 operand (dQ, dK, dV) split it as
//     hi = bf16(x), lo = bf16(x - hi) and run two mma passes into one fp32
//     accumulator: P and dS keep ~16 significant bits, where one bf16
//     rounding would keep 8. The other two (S, dP) are bf16 x bf16 and exact
//     on the tensor cores.
//   * the score is (S * scale) + bias (+ mask), each operation rounded on
//     its own (__fmul_rn/__fadd_rn) as the plain version does; P is the
//     correctly rounded quotient e / sum (tc::div_rn). rowsum(dP * P) is
//     taken as sum(dP * e) / sum, the same sum rounded at other points.
// float32: the CUDA-core kernel as before (tensor cores would round the
// inputs to TF32, past the fp32 bound): 8 warps, query tiles of 32 rows;
// phase A computes the scores and dP of 4 rows a warp (lanes over keys),
// phase C dQ, phase B the dK/dV outer products into sums in shared memory
// (or, where they do not fit, N = 256 with d = 64, a scratch of the block's
// own in device memory).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "bf16_mma.cuh"

namespace {

constexpr int kMaxTokens = 256;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per tile

struct Params {
  const void* qkv;       // (B, H, W, L), L = heads * (2*kd + dv)
  const float* bias;     // (heads, N, N)
  const float* mask;     // (nH*nW, N, N) or null
  const void* qkv_bias;  // (L,) in the input type, or null
  const void* dout;      // (B, H, W, heads*dv)
  void* dqkv;            // (B, H, W, L)
  float* partial;        // (groups, heads, N, N)
  float* acc_scratch;    // (groups, heads, N4*(kd+dv)), or null: sums in shared memory
  int H, W, heads, window, layout;  // layout 0: head_major, 1: qkv_major
  int n_windows, per_group;         // B*nH*nW; windows per block
  float scale;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float a, float4 b, float4& acc) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

// Shared-memory geometry of a block, in floats.
struct Geometry {
  int N, N4, KS, VS, NS;
  __host__ __device__ Geometry(int window, int kd, int dv) {
    N = window * window;
    N4 = (N + 3) / 4 * 4;                 // keys padded to a float4
    KS = kd + 4;                          // padded row strides: odd multiples
    VS = dv + 4;                          // of 16 bytes
    NS = (N4 / 4) % 2 ? N4 : N4 + 4;
  }
  __host__ __device__ int base() const {  // K, V, Q and dO tiles, P and dS tiles
    return N4 * KS + N4 * VS + kRows * KS + kRows * VS + 2 * kRows * NS;
  }
  __host__ __device__ int acc(int kd, int dv) const { return N4 * (kd + dv); }
};

// One thread's 4x4 (keys m4*4.. x channels d4*4..) block of sum over the
// tile's rows r of w[r][m] * b[r][d]: dK (w = dS, b = Q) or dV (P, dO).
__device__ __forceinline__ void tile_outer(const float* w, int ws, const float* b,
                                           int bs, int rows, int m4, int d4,
                                           float4 (&a)[4]) {
  for (int r = 0; r < rows; ++r) {
    const float4 wv = reinterpret_cast<const float4*>(w + r * ws)[m4];
    const float4 bv = reinterpret_cast<const float4*>(b + r * bs)[d4];
    axpy4(wv.x, bv, a[0]);
    axpy4(wv.y, bv, a[1]);
    axpy4(wv.z, bv, a[2]);
    axpy4(wv.w, bv, a[3]);
  }
}

// KPL: keys per lane in phase A, 2 for windows of up to 64 tokens (their
// scores then take a quarter of the registers), else 8
template <int KD, int DV, int KPL>
__global__ void __launch_bounds__(kThreads)
window_attention_bwd_kernel(Params p) {
  extern __shared__ float4 smem4[];
  const Geometry geo(p.window, KD, DV);
  const int N = geo.N, N4 = geo.N4, KS = geo.KS, VS = geo.VS, NS = geo.NS;
  float* k_s = reinterpret_cast<float*>(smem4);  // N4 * KS
  float* v_s = k_s + N4 * KS;                     // N4 * VS
  float* q_t = v_s + N4 * VS;                     // kRows * KS
  float* do_t = q_t + kRows * KS;                 // kRows * VS
  float* p_t = do_t + kRows * VS;                 // kRows * NS
  float* ds_t = p_t + kRows * NS;                 // kRows * NS

  const float* qkv = static_cast<const float*>(p.qkv);
  const float* qb = static_cast<const float*>(p.qkv_bias);
  const float* dout = static_cast<const float*>(p.dout);
  float* dqkv = static_cast<float*>(p.dqkv);
  const int h = blockIdx.x, g = blockIdx.y;
  const int nW = p.W / p.window;
  const int nwin = (p.H / p.window) * nW;
  const int L = p.heads * (2 * KD + DV);
  const int DO = p.heads * DV;
  int qo, ko, vo;
  if (p.layout == 0) {
    qo = h * (2 * KD + DV); ko = qo + KD; vo = qo + 2 * KD;
  } else {
    qo = h * KD; ko = p.heads * KD + h * KD; vo = 2 * p.heads * KD + h * DV;
  }
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float* bias_h = p.bias + static_cast<size_t>(h) * N * N;
  const size_t blk = static_cast<size_t>(g) * p.heads + h;
  float* part = p.partial + blk * N * N;
  // dK and dV sums, (N4, KD) and (N4, DV): in shared memory after the
  // tiles, or in this block's scratch
  float* dk_acc = p.acc_scratch ? p.acc_scratch + blk * geo.acc(KD, DV)
                                : ds_t + kRows * NS;
  float* dv_acc = dk_acc + N4 * KD;
  const int w0 = g * p.per_group;
  const int w1 = min(w0 + p.per_group, p.n_windows);

  for (int wi = w0; wi < w1; ++wi) {
    const int b = wi / nwin, win = wi % nwin;
    const int y0 = (win / nW) * p.window, x0 = (win % nW) * p.window;
    // pixel index of window token t: the window is row-major inside the map
    auto pix = [&](int t) -> long long {
      return (static_cast<long long>(b) * p.H + y0 + t / p.window) * p.W + x0 + t % p.window;
    };
    const float* mask_w = p.mask ? p.mask + static_cast<size_t>(win) * N * N : nullptr;

    // K and V of this window, zero rows past N (the previous window's
    // readers finished at the last barrier of its tile loop)
    for (int i = tid; i < N4 * KD; i += kThreads) {
      const int t = i / KD, d = i % KD;
      float x = 0.f;
      if (t < N) {
        x = qkv[pix(t) * L + ko + d];
        if (qb) x = x + qb[ko + d];
      }
      k_s[t * KS + d] = x;
    }
    for (int i = tid; i < N4 * DV; i += kThreads) {
      const int t = i / DV, d = i % DV;
      float x = 0.f;
      if (t < N) {
        x = qkv[pix(t) * L + vo + d];
        if (qb) x = x + qb[vo + d];
      }
      v_s[t * VS + d] = x;
    }

    for (int n0 = 0; n0 < N; n0 += kRows) {
      const int rows = min(kRows, N - n0);
      for (int i = tid; i < rows * KD; i += kThreads) {
        const int r = i / KD, d = i % KD;
        float x = qkv[pix(n0 + r) * L + qo + d];
        if (qb) x = x + qb[qo + d];
        q_t[r * KS + d] = x;
      }
      for (int i = tid; i < rows * DV; i += kThreads) {
        const int r = i / DV, d = i % DV;
        do_t[r * VS + d] = dout[pix(n0 + r) * DO + h * DV + d];
      }
      __syncthreads();

      // phase A: warp `warp` takes rows 4*warp .. 4*warp+3 of the tile
      {
        const int r0 = warp * kRowsPerWarp;
        float s[kRowsPerWarp][KPL], dp[kRowsPerWarp][KPL];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
          for (int j = 0; j < KPL; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll
        for (int k4 = 0; k4 < KD / 4; ++k4) {
          float4 qv[kRowsPerWarp];
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i)
            qv[i] = reinterpret_cast<const float4*>(q_t + (r0 + i) * KS)[k4];
#pragma unroll
          for (int j = 0; j < KPL; ++j) {
            const int m = lane + 32 * j;
            if (m < N) {
              const float4 kv = reinterpret_cast<const float4*>(k_s + m * KS)[k4];
#pragma unroll
              for (int i = 0; i < kRowsPerWarp; ++i) s[i][j] = dot4(qv[i], kv, s[i][j]);
            }
          }
        }
#pragma unroll
        for (int k4 = 0; k4 < DV / 4; ++k4) {
          float4 ov[kRowsPerWarp];
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i)
            ov[i] = reinterpret_cast<const float4*>(do_t + (r0 + i) * VS)[k4];
#pragma unroll
          for (int j = 0; j < KPL; ++j) {
            const int m = lane + 32 * j;
            if (m < N) {
              const float4 vv = reinterpret_cast<const float4*>(v_s + m * VS)[k4];
#pragma unroll
              for (int i = 0; i < kRowsPerWarp; ++i) dp[i][j] = dot4(ov[i], vv, dp[i][j]);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          const int r = r0 + i;
          // rows past N compute on stale tile rows and are never stored
          const int n = min(n0 + r, N - 1);
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < KPL; ++j) {
            const int m = lane + 32 * j;
            if (m < N) {
              float sc = s[i][j] * p.scale + bias_h[n * N + m];
              if (mask_w) sc += mask_w[n * N + m];
              s[i][j] = sc;
              mx = fmaxf(mx, sc);
            }
          }
          mx = warp_max(mx);
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < KPL; ++j) {
            const float e = (lane + 32 * j < N) ? expf(s[i][j] - mx) : 0.f;
            s[i][j] = e;
            sum += e;
          }
          sum = warp_sum(sum);
          float rs = 0.f;
#pragma unroll
          for (int j = 0; j < KPL; ++j) {
            s[i][j] = s[i][j] / sum;           // P, fp32 (0 past N)
            rs = fmaf(dp[i][j], s[i][j], rs);
          }
          rs = warp_sum(rs);
          const bool valid = r < rows;
          float* prow = part + static_cast<size_t>(n) * N;
          float old[KPL];
#pragma unroll
          for (int j = 0; j < KPL; ++j) {
            const int m = lane + 32 * j;
            dp[i][j] = s[i][j] * (dp[i][j] - rs);   // dS (0 past N)
            old[j] = (valid && m < N && wi != w0) ? prow[m] : 0.f;
          }
#pragma unroll
          for (int j = 0; j < KPL; ++j) {
            const int m = lane + 32 * j;
            if (m < N4) {                      // zero past N: phases B and C read N4
              p_t[r * NS + m] = s[i][j];
              ds_t[r * NS + m] = dp[i][j];
            }
            if (valid && m < N) prow[m] = old[j] + dp[i][j];
          }
        }
      }
      __syncthreads();

      // phase C: dQ of the tile's rows, thread (row group, channel)
      {
        constexpr int RG = kThreads / KD;      // row groups
        constexpr int RPT = kRows / RG;        // rows per thread
        const int d = tid % KD, rg = tid / KD;
        float acc[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
        for (int m4 = 0; m4 < N4 / 4; ++m4) {
          const float k0 = k_s[(4 * m4 + 0) * KS + d], k1 = k_s[(4 * m4 + 1) * KS + d];
          const float k2 = k_s[(4 * m4 + 2) * KS + d], k3 = k_s[(4 * m4 + 3) * KS + d];
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const float4 w = reinterpret_cast<const float4*>(ds_t + (rg + i * RG) * NS)[m4];
            acc[i] = fmaf(w.w, k3, fmaf(w.z, k2, fmaf(w.y, k1, fmaf(w.x, k0, acc[i]))));
          }
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = rg + i * RG;
          if (r < rows) dqkv[pix(n0 + r) * L + qo + d] = acc[i] * p.scale;
        }
      }

      // phase B: dK += dS^T.Q, dV += P^T.dO, a 4x4 block (keys x channels)
      // per thread and item
      {
        const int nk = (N4 / 4) * (KD / 4), nv = (N4 / 4) * (DV / 4);
        for (int item = tid; item < nk + nv; item += kThreads) {
          const bool is_k = item < nk;
          const int idx = is_k ? item : item - nk;
          const int D = is_k ? KD : DV;
          const int d4 = idx % (D / 4), m4 = idx / (D / 4);
          float* acc = (is_k ? dk_acc : dv_acc) + (4 * m4) * D + 4 * d4;
          float4 a[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            a[q] = n0 == 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
                           : *reinterpret_cast<const float4*>(acc + q * D);
          if (is_k)
            tile_outer(ds_t, NS, q_t, KS, rows, m4, d4, a);
          else
            tile_outer(p_t, NS, do_t, VS, rows, m4, d4, a);
#pragma unroll
          for (int q = 0; q < 4; ++q) *reinterpret_cast<float4*>(acc + q * D) = a[q];
        }
      }
      __syncthreads();  // the next tile rewrites q_t, do_t, p_t, ds_t
    }

    // dK and dV of this window
    for (int i = tid; i < N * KD; i += kThreads) {
      const int m = i / KD, d = i % KD;
      dqkv[pix(m) * L + ko + d] = dk_acc[m * KD + d] * p.scale;
    }
    for (int i = tid; i < N * DV; i += kThreads) {
      const int m = i / DV, d = i % DV;
      dqkv[pix(m) * L + vo + d] = dv_acc[m * DV + d];
    }
  }
}

// ---------------------------------------------------------------- bfloat16

using bf16 = __nv_bfloat16;
constexpr int kMmaMaxWarps = 16;   // a warp per 16-key tile: N <= 256

// A block has a warp per 16-key tile of the window; warp w owns keys
// 16w .. 16w + 15. Held to 128 registers a thread, so 16 warps fit an SM.
template <int KD, int DV>
__global__ void __launch_bounds__(kMmaMaxWarps * 32)
window_attention_bwd_mma_kernel(Params p) {
  constexpr int QS = KD + 8, VS = DV + 8;  // row strides (elements), 16-byte pad
  constexpr int DQS = KD + 8;              // dQ share rows (floats): conflict-free float2
  extern __shared__ uint4 smem16[];
  const int N = p.window * p.window;
  const int NP = 16 * (blockDim.x / 32);   // N padded to whole key tiles
  const int nwarps = blockDim.x / 32;
  bf16* q_s = reinterpret_cast<bf16*>(smem16);            // NP * QS
  bf16* k_s = q_s + NP * QS;                               // NP * QS
  bf16* v_s = k_s + NP * QS;                               // NP * VS
  bf16* o_s = v_s + NP * VS;                               // NP * VS: dO
  // per warp and strip row: the max of S over the warp's keys; the sums of
  // exp(S - max) and of dP * exp(S - max) over them; the warp's dQ share
  float* red_max = reinterpret_cast<float*>(o_s + NP * VS);            // nwarps * 16
  float2* red_sum = reinterpret_cast<float2*>(red_max + nwarps * 16);  // nwarps * 16
  float* dq_s = reinterpret_cast<float*>(red_sum + nwarps * 16);       // nwarps * 16 * DQS

  const bf16* qkv = static_cast<const bf16*>(p.qkv);
  const bf16* qb = static_cast<const bf16*>(p.qkv_bias);
  const bf16* dout = static_cast<const bf16*>(p.dout);
  bf16* dqkv = static_cast<bf16*>(p.dqkv);
  const int h = blockIdx.x, g = blockIdx.y;
  const int nW = p.W / p.window;
  const int nwin = (p.H / p.window) * nW;
  const int L = p.heads * (2 * KD + DV), DO = p.heads * DV;
  int qo, ko, vo;
  if (p.layout == 0) {
    qo = h * (2 * KD + DV); ko = qo + KD; vo = qo + 2 * KD;
  } else {
    qo = h * KD; ko = p.heads * KD + h * KD; vo = 2 * p.heads * KD + h * DV;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = 16 * warp;                       // this warp's keys
  const bool even = N % 2 == 0;                   // fp32 rows of N: 8-byte pairs
  const float* bias_h = p.bias + static_cast<size_t>(h) * N * N;
  float* part = p.partial + (static_cast<size_t>(g) * p.heads + h) * N * N;
  const int w0 = g * p.per_group;
  const int w1 = min(w0 + p.per_group, p.n_windows);

  for (int wi = w0; wi < w1; ++wi) {
    const int b = wi / nwin, win = wi % nwin;
    const int y0 = (win / nW) * p.window, x0 = (win % nW) * p.window;
    auto pix = [&](int t) -> long long {
      return (static_cast<long long>(b) * p.H + y0 + t / p.window) * p.W + x0 + t % p.window;
    };
    auto seg = [&](int off) {
      return [=](int t) { return qkv + pix(t) * L + off; };
    };
    const float* mask_w = p.mask ? p.mask + static_cast<size_t>(win) * N * N : nullptr;
    const bool first = wi == w0;
    // the previous window's readers finished at its last barrier; a thread
    // keeps every load of the staging in flight at once (2 threads a row)
    const auto qs = tc::segment(seg(qo), qb ? qb + qo : nullptr, q_s);
    const auto ks = tc::segment(seg(ko), qb ? qb + ko : nullptr, k_s);
    const auto vs = tc::segment(seg(vo), qb ? qb + vo : nullptr, v_s);
    const auto os = tc::segment([=](int t) { return dout + pix(t) * DO + h * DV; },
                                static_cast<const bf16*>(nullptr), o_s);
    if constexpr (KD == DV) {
      tc::stage_rows<KD, (KD + 15) / 16>(QS, N, NP, qs, ks, vs, os);
    } else {
      tc::stage_rows<KD, (KD + 15) / 16>(QS, N, NP, qs, ks);
      tc::stage_rows<DV, (DV + 15) / 16>(VS, N, NP, vs, os);
    }
    __syncthreads();

    float dk[KD / 8][4], dv[DV / 8][4];   // this warp's keys' sums over the queries
#pragma unroll
    for (int t = 0; t < KD / 8; ++t) dk[t][0] = dk[t][1] = dk[t][2] = dk[t][3] = 0.f;
#pragma unroll
    for (int t = 0; t < DV / 8; ++t) dv[t][0] = dv[t][1] = dv[t][2] = dv[t][3] = 0.f;

    // the query strips in turn, all warps on one strip, each on its keys
    for (int r0 = 0; r0 < NP; r0 += 16) {
      // this thread's (query, key) places of the strip: n-tile u, element e
      // at row ra (e < 2) or rb, key k(u) + (e & 1)
      const int ra = r0 + gid, rb = ra + 8;
      auto key = [&](int u) { return m0 + 8 * u + 2 * tig; };
      // the dbias partial so far, loaded first, a pair of keys at a time
      float2 old[2][2] = {};
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int hb = 0; hb < 2; ++hb) {
          const int q = hb ? rb : ra, k = key(u);
          if (!first && q < N && k < N) old[u][hb] = tc::row_pair(part + q * N, k, N, even);
        }
      uint32_t aq[KD / 16][4], ao[DV / 16][4];
#pragma unroll
      for (int k = 0; k < KD / 16; ++k) tc::load_a(aq[k], q_s + r0 * QS, QS, 16 * k, lane);
#pragma unroll
      for (int k = 0; k < DV / 16; ++k) tc::load_a(ao[k], o_s + r0 * VS, VS, 16 * k, lane);
      float s[2][4] = {}, dp[2][4] = {};
      tc::mma_abt<KD, 2>(s, aq, k_s + m0 * QS, QS, 2, lane);    // S = Q.K^T
      tc::mma_abt<DV, 2>(dp, ao, v_s + m0 * VS, VS, 2, lane);   // dP = dO.V^T

      // the score (S * scale) + bias (+ mask); padded rows read row N - 1
      // of the bias and are never stored; the row max over this warp's keys
      const size_t oa = static_cast<size_t>(min(ra, N - 1)) * N;
      const size_t ob = static_cast<size_t>(min(rb, N - 1)) * N;
      float mxa = -INFINITY, mxb = -INFINITY;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int k = key(u);
        if (k >= N) continue;
        const float2 bv[2] = {tc::row_pair(bias_h + oa, k, N, even),
                              tc::row_pair(bias_h + ob, k, N, even)};
        float2 mv[2] = {};
        if (mask_w) {
          mv[0] = tc::row_pair(mask_w + oa, k, N, even);
          mv[1] = tc::row_pair(mask_w + ob, k, N, even);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (k + (e & 1) >= N) continue;
          const float2 b2 = bv[e >> 1], m2 = mv[e >> 1];
          float sc = __fadd_rn(__fmul_rn(s[u][e], p.scale), e & 1 ? b2.y : b2.x);
          if (mask_w) sc = __fadd_rn(sc, e & 1 ? m2.y : m2.x);
          s[u][e] = sc;
          if (e < 2) mxa = fmaxf(mxa, sc); else mxb = fmaxf(mxb, sc);
        }
      }
      mxa = tc::quad_max(mxa);
      mxb = tc::quad_max(mxb);
      if (tig == 0) {
        red_max[warp * 16 + gid] = mxa;
        red_max[warp * 16 + gid + 8] = mxb;
      }
      __syncthreads();
      mxa = mxb = -INFINITY;   // the exact row max, over the warps in order
      for (int w = 0; w < nwarps; ++w) {
        mxa = fmaxf(mxa, red_max[w * 16 + gid]);
        mxb = fmaxf(mxb, red_max[w * 16 + gid + 8]);
      }
      // e = exp(S - max) (0 at padded keys); sums of e and of dP * e
      float2 ta = make_float2(0.f, 0.f), tb = make_float2(0.f, 0.f);
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = key(u) + (e & 1) < N ? expf(s[u][e] - (e < 2 ? mxa : mxb)) : 0.f;
          s[u][e] = x;
          float2& t = e < 2 ? ta : tb;
          t.x += x;
          t.y = fmaf(dp[u][e], x, t.y);
        }
      ta = make_float2(tc::quad_sum(ta.x), tc::quad_sum(ta.y));
      tb = make_float2(tc::quad_sum(tb.x), tc::quad_sum(tb.y));
      if (tig == 0) {
        red_sum[warp * 16 + gid] = ta;
        red_sum[warp * 16 + gid + 8] = tb;
      }
      __syncthreads();
      ta = tb = make_float2(0.f, 0.f);   // over the warps in order
      for (int w = 0; w < nwarps; ++w) {
        const float2 xa = red_sum[w * 16 + gid], xb = red_sum[w * 16 + gid + 8];
        ta.x += xa.x; ta.y += xa.y;
        tb.x += xb.x; tb.y += xb.y;
      }
      // P = e / sum; rowsum(dP * P) = sum(dP * e) / sum; dS = P * (dP - it)
      const float ria = 1.f / ta.x, rib = 1.f / tb.x;
      const float rsa = tc::div_rn(ta.y, ta.x, ria), rsb = tc::div_rn(tb.y, tb.x, rib);
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pv = e < 2 ? tc::div_rn(s[u][e], ta.x, ria) : tc::div_rn(s[u][e], tb.x, rib);
          s[u][e] = pv;
          dp[u][e] = pv * (dp[u][e] - (e < 2 ? rsa : rsb));   // dS
        }
      // the dbias partial: + dS, a pair of keys at a time
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int hb = 0; hb < 2; ++hb) {
          const int q = hb ? rb : ra, k = key(u);
          if (q >= N || k >= N) continue;
          const float2 v = make_float2(old[u][hb].x + dp[u][2 * hb], old[u][hb].y + dp[u][2 * hb + 1]);
          float* d = part + q * N + k;
          if (even) {
            *reinterpret_cast<float2*>(d) = v;
          } else {
            d[0] = v.x;
            if (k + 1 < N) d[1] = v.y;
          }
        }

      // dV += P^T.dO and dK += dS^T.Q for this warp's keys (P and dS split
      // hi/lo, transposed in registers; dO and Q through ldmatrix.trans),
      // and this warp's share of dQ = dS.K
      uint32_t ph[4], pl[4], dh[4], dl[4], pht[4], plt[4], dht[4], dlt[4];
      tc::c_to_a_split(s[0], s[1], ph, pl);
      tc::c_to_a_split(dp[0], dp[1], dh, dl);
      tc::transpose_a(ph, pht);
      tc::transpose_a(pl, plt);
      tc::transpose_a(dh, dht);
      tc::transpose_a(dl, dlt);
#pragma unroll
      for (int n2 = 0; n2 < DV / 16; ++n2) {
        uint32_t bo[4];
        tc::ldsm_x4_trans(bo, o_s + r0 * VS + 16 * n2, VS, lane);
        tc::mma_bf16(dv[2 * n2], pht, bo[0], bo[1]);
        tc::mma_bf16(dv[2 * n2], plt, bo[0], bo[1]);
        tc::mma_bf16(dv[2 * n2 + 1], pht, bo[2], bo[3]);
        tc::mma_bf16(dv[2 * n2 + 1], plt, bo[2], bo[3]);
      }
      float dq[KD / 8][4];
#pragma unroll
      for (int t = 0; t < KD / 8; ++t) dq[t][0] = dq[t][1] = dq[t][2] = dq[t][3] = 0.f;
#pragma unroll
      for (int n2 = 0; n2 < KD / 16; ++n2) {
        uint32_t bq[4], bk[4];
        tc::ldsm_x4_trans(bq, q_s + r0 * QS + 16 * n2, QS, lane);
        tc::mma_bf16(dk[2 * n2], dht, bq[0], bq[1]);
        tc::mma_bf16(dk[2 * n2], dlt, bq[0], bq[1]);
        tc::mma_bf16(dk[2 * n2 + 1], dht, bq[2], bq[3]);
        tc::mma_bf16(dk[2 * n2 + 1], dlt, bq[2], bq[3]);
        tc::ldsm_x4_trans(bk, k_s + m0 * QS + 16 * n2, QS, lane);
        tc::mma_bf16(dq[2 * n2], dh, bk[0], bk[1]);
        tc::mma_bf16(dq[2 * n2], dl, bk[0], bk[1]);
        tc::mma_bf16(dq[2 * n2 + 1], dh, bk[2], bk[3]);
        tc::mma_bf16(dq[2 * n2 + 1], dl, bk[2], bk[3]);
      }
      // dQ of the strip: the warps' shares summed in warp order
      float* dq_w = dq_s + warp * 16 * DQS;
#pragma unroll
      for (int t = 0; t < KD / 8; ++t) {
        *reinterpret_cast<float2*>(dq_w + gid * DQS + 8 * t + 2 * tig) = make_float2(dq[t][0], dq[t][1]);
        *reinterpret_cast<float2*>(dq_w + (gid + 8) * DQS + 8 * t + 2 * tig) =
            make_float2(dq[t][2], dq[t][3]);
      }
      __syncthreads();
      for (int j = threadIdx.x; j < 16 * KD / 2; j += blockDim.x) {
        const int row = j / (KD / 2), c = 2 * (j % (KD / 2));
        float2 acc = make_float2(0.f, 0.f);
        for (int w = 0; w < nwarps; ++w) {
          const float2 x = *reinterpret_cast<const float2*>(dq_s + (w * 16 + row) * DQS + c);
          acc.x += x.x;
          acc.y += x.y;
        }
        if (r0 + row < N)
          *reinterpret_cast<uint32_t*>(dqkv + pix(r0 + row) * L + qo + c) =
              tc::pack_bf16(acc.x * p.scale, acc.y * p.scale);
      }
    }

    // dK and dV of this warp's keys
    const int ka = m0 + gid, kb = ka + 8;
#pragma unroll
    for (int t = 0; t < KD / 8; ++t) {
      const int c = ko + 8 * t + 2 * tig;
      if (ka < N)
        *reinterpret_cast<uint32_t*>(dqkv + pix(ka) * L + c) =
            tc::pack_bf16(dk[t][0] * p.scale, dk[t][1] * p.scale);
      if (kb < N)
        *reinterpret_cast<uint32_t*>(dqkv + pix(kb) * L + c) =
            tc::pack_bf16(dk[t][2] * p.scale, dk[t][3] * p.scale);
    }
#pragma unroll
    for (int t = 0; t < DV / 8; ++t) {
      const int c = vo + 8 * t + 2 * tig;
      if (ka < N)
        *reinterpret_cast<uint32_t*>(dqkv + pix(ka) * L + c) = tc::pack_bf16(dv[t][0], dv[t][1]);
      if (kb < N)
        *reinterpret_cast<uint32_t*>(dqkv + pix(kb) * L + c) = tc::pack_bf16(dv[t][2], dv[t][3]);
    }
    __syncthreads();   // the next window rewrites shared memory
  }
}

// dbias[i] = sum over g of partial[g][i], g in order
__global__ void dbias_reduce_kernel(const float* __restrict__ partial,
                                    float* __restrict__ dbias, int groups, int count) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < count; i += gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int g = 0; g < groups; ++g) acc += partial[static_cast<size_t>(g) * count + i];
    dbias[i] = acc;
  }
}

int max_smem_bytes() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return 48 * 1024;
  return bytes;
}

// fp32 words of dK/dV sums a block keeps in device memory (0: they fit in
// its shared memory)
int acc_scratch_floats(int window, int kd, int dv) {
  const Geometry geo(window, kd, dv);
  const size_t all = sizeof(float) * static_cast<size_t>(geo.base() + geo.acc(kd, dv));
  return all <= static_cast<size_t>(max_smem_bytes()) ? 0 : geo.acc(kd, dv);
}

cudaError_t reduce_dbias(const Params& p, int groups, float* dbias, cudaStream_t stream) {
  const int N = p.window * p.window, count = p.heads * N * N;
  dbias_reduce_kernel<<<(count + 255) / 256, 256, 0, stream>>>(p.partial, dbias, groups, count);
  return cudaGetLastError();
}

template <typename Kern, typename... Args>
cudaError_t launch_kernel(Kern kern, int threads, size_t smem, const Params& p, int groups,
                          float* dbias, cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(p.heads, groups), threads, smem, stream>>>(p, args...);
  const cudaError_t e = cudaGetLastError();
  return e != cudaSuccess ? e : reduce_dbias(p, groups, dbias, stream);
}

template <int KD, int DV>
cudaError_t launch_fp32(const Params& p, int groups, float* dbias, cudaStream_t stream) {
  const Geometry geo(p.window, KD, DV);
  const int floats = geo.base() + (p.acc_scratch ? 0 : geo.acc(KD, DV));
  const size_t smem = sizeof(float) * static_cast<size_t>(floats);
  auto kern = geo.N <= 64 ? window_attention_bwd_kernel<KD, DV, 2>
                          : window_attention_bwd_kernel<KD, DV, 8>;
  return launch_kernel(kern, kThreads, smem, p, groups, dbias, stream);
}

template <int KD, int DV>
cudaError_t launch_bf16(const Params& p, int groups, float* dbias, cudaStream_t stream) {
  const int N = p.window * p.window, warps = (N + 15) / 16;
  const size_t NP = 16 * warps;
  const size_t smem = sizeof(bf16) * NP * 2 * (KD + 8 + DV + 8) +
                      sizeof(float) * warps * 16 * (1 + 2 + KD + 8);
  return launch_kernel(window_attention_bwd_mma_kernel<KD, DV>, 32 * warps, smem, p, groups,
                       dbias, stream);
}

template <int KD, int DV>
cudaError_t launch(int dtype, const Params& p, int groups, float* dbias, cudaStream_t s) {
  switch (dtype) {
    case 0: return launch_fp32<KD, DV>(p, groups, dbias, s);
    case 1: return launch_bf16<KD, DV>(p, groups, dbias, s);
  }
  return cudaErrorInvalidValue;
}

template <int KD>
cudaError_t dispatch_dv(int dv, int dtype, const Params& p, int groups, float* dbias,
                        cudaStream_t s) {
  switch (dv) {
    case 16: return launch<KD, 16>(dtype, p, groups, dbias, s);
    case 32: return launch<KD, 32>(dtype, p, groups, dbias, s);
    case 64: return launch<KD, 64>(dtype, p, groups, dbias, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// fp32 words of dK/dV scratch per (group, head) block that a float32 launch
// with these sizes needs (0 when the sums fit in shared memory). The
// bfloat16 kernel keeps its sums in registers and leaves the scratch alone.
extern "C" int cream_window_attention_bwd_scratch(int window, int kd, int dv) {
  return acc_scratch_floats(window, kd, dv);
}

// dtype: 0 float32 (CUDA cores), 1 bfloat16 (tensor cores). `partial` holds
// groups*heads*N*N floats, groups = ceil(B*nH*nW / per_group); `acc_scratch`
// holds groups*heads*cream_window_attention_bwd_scratch(...) floats, or is
// null when that is 0. The bf16 kernel reads qkv, qkv_bias and dout 16 bytes
// at a time: they must start on a 16-byte boundary. Returns a cudaError_t
// (0 on success).
extern "C" int cream_window_attention_bwd(
    const void* qkv, const void* bias, const void* mask, const void* qkv_bias,
    const void* dout, void* dqkv, void* partial, void* acc_scratch, void* dbias,
    int B, int H, int W, int heads, int kd, int dv, int window, int layout, int dtype,
    int per_group, int groups, float scale, void* stream) {
  if (window * window > kMaxTokens || H % window || W % window || layout < 0 ||
      layout > 1 || per_group < 1 || dtype < 0 || dtype > 1)
    return cudaErrorInvalidValue;
  const int n_windows = B * (H / window) * (W / window);
  if (groups != (n_windows + per_group - 1) / per_group || groups > 65535)
    return cudaErrorInvalidValue;
  if ((acc_scratch != nullptr) != (acc_scratch_floats(window, kd, dv) > 0))
    return cudaErrorInvalidValue;
  if (dtype == 1 && ((reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(qkv_bias) |
                      reinterpret_cast<uintptr_t>(dout)) & 15))
    return cudaErrorMisalignedAddress;
  const Params p{qkv, static_cast<const float*>(bias), static_cast<const float*>(mask),
                 qkv_bias, dout, dqkv, static_cast<float*>(partial),
                 static_cast<float*>(acc_scratch), H, W, heads, window, layout,
                 n_windows, per_group, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* db = static_cast<float*>(dbias);
  switch (kd) {
    case 16: return dispatch_dv<16>(dv, dtype, p, groups, db, s);
    case 32: return dispatch_dv<32>(dv, dtype, p, groups, db, s);
    case 64: return dispatch_dv<64>(dv, dtype, p, groups, db, s);
  }
  return cudaErrorInvalidValue;
}
