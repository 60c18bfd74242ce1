// The bf16 tensor-core attention core shared by the bias-attention kernel
// (bias_attention.cu, K3), the CGA attention-core kernel (cga_core.cu, K5)
// and the fused CGA kernel (cga.cu, K4; `attend_strip` alone): per item
// (one (window, head) of K3, one window of K5)
//   out[n] = softmax_m(q[n] . k[m] * scale + bias[n][m]) . v
// with fp32 scores, the exact row max, exp and P = e / sum correctly
// rounded, P rounded to bf16 before P.V, P.V summed in fp32 and the result
// rounded to bf16. The score is (S * scale) + bias, each operation rounded
// on its own (__fmul_rn/__fadd_rn) as the plain versions and the JAX
// kernels round it: no FMA contraction.
//
// Design (K1's, window_attention.cu): a block of kWarps warps takes
// `per_block` consecutive items. Their q, k and v go to shared memory as
// bf16, 16 bytes a thread where the head dim is a multiple of 8, a thread's
// loads of the three tensors issued four rows at a time before any is
// stored. Rows are padded to NP, the next multiple of 16, and columns to the
// next multiple of 16, with zeros (a padded K or V row must be zero, not
// stale: P = 0 times NaN is NaN); row strides are 16 bytes over that, so
// every fragment load hits 32 distinct banks. Each warp takes 16-row query strips of one
// item: S = Q.K^T on mma.sync m16n8k16 with fp32 sums, a k-tile of the
// head dim at a time, the strip's scores in registers (NKT 16-key tiles at
// most: N <= 16 * NKT; n-tiles past the last key are skipped); the row max
// and sum over the quad by shuffles; P packed from the C fragments straight
// into the A fragments of P.V (tc::c_to_a), V the B operand through
// ldmatrix.trans, 16 output columns at a time. Padded keys get P = 0;
// padded query rows read the bias's last row and are never stored. Windows
// of 16 (32) tokens are one (two) strips: a block then takes 4 (2) items,
// a warp (two) each, so no warp idles.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace bam {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr size_t kMaxSmem = 227 * 1024;   // shared memory a Hopper block can use

__host__ __device__ constexpr int pad16(int x) { return (x + 15) / 16 * 16; }
// row stride (elements) of a head dim d in shared memory: 16 bytes of pad
__host__ __device__ constexpr int row_stride(int d) { return pad16(d) + 8; }

struct Params {
  const bf16* q;      // (items, N, kd)
  const bf16* k;      // (items, N, kd)
  const bf16* v;      // (items, N, dv)
  const float* bias;  // (heads, N, N): item i takes bias[i % heads]
  bf16* out;          // (items, N, dv)
  long long items;
  int heads, N, kd, dv;
  float scale;
  int per_block = 1;  // items a block takes: set by launch
};

// One thread's share of staging an (items, N, d) tensor: chunk column c
// (8 elements, 16 bytes) of rows r0, r0 + rpp, ... of the block's
// items * NP padded rows
struct Seg {
  const bf16* src;
  bf16* dst;
  int d, DS, c, r0, rpp;

  __device__ Seg(const bf16* src_, bf16* dst_, int d_)
      : src(src_), dst(dst_), d(d_), DS(row_stride(d_)) {
    const int cpr = pad16(d) / 8;
    c = threadIdx.x % cpr;
    r0 = threadIdx.x / cpr;
    rpp = blockDim.x / cpr;
  }

  // padded row of pass `pass`, or -1 past the rows (or for an idle thread)
  __device__ int row(int pass, int rows) const {
    const int r = r0 + pass * rpp;
    return r0 < rpp && r < rows ? r : -1;
  }

  __device__ uint4 load(int r, int N, int NP) const {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < 0) return v;
    int g = 0, t = r;                  // item g, token t; per_block <= 4
    while (t >= NP) { t -= NP; ++g; }
    if (t >= N || 8 * c >= d) return v;
    const bf16* p = src + (static_cast<size_t>(g) * N + t) * d + 8 * c;
    if (d % 8 == 0) return *reinterpret_cast<const uint4*>(p);
    const unsigned short* e = reinterpret_cast<const unsigned short*>(p);
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t lo = 8 * c + 2 * i < d ? e[2 * i] : 0u;
      const uint32_t hi = 8 * c + 2 * i + 1 < d ? e[2 * i + 1] : 0u;
      w[i] = lo | (hi << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }

  __device__ void store(int r, uint4 v) const {
    if (r >= 0) *reinterpret_cast<uint4*>(dst + r * DS + 8 * c) = v;
  }
};

// q, k and v of `rows` padded rows into shared memory, BATCH passes of each
// loaded before any is stored, so their latencies overlap
template <int BATCH>
__device__ __forceinline__ void stage_qkv(const Seg& q, const Seg& k, const Seg& v, int rows,
                                          int N, int NP) {
  const int rpp = min(q.rpp, min(k.rpp, v.rpp));
  const int passes = (rows + rpp - 1) / rpp;
  for (int p0 = 0; p0 < passes; p0 += BATCH) {
    uint4 xq[BATCH], xk[BATCH], xv[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      xq[j] = q.load(q.row(p0 + j, rows), N, NP);
      xk[j] = k.load(k.row(p0 + j, rows), N, NP);
      xv[j] = v.load(v.row(p0 + j, rows), N, NP);
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      q.store(q.row(p0 + j, rows), xq[j]);
      k.store(k.row(p0 + j, rows), xk[j]);
      v.store(v.row(p0 + j, rows), xv[j]);
    }
  }
}

// (x, y) at row[c], row[c + 1] of a d-wide bf16 row, each rounded to nearest
// even; columns past d are not stored
__device__ __forceinline__ void store_pair(bf16* row, int c, int d, float x, float y) {
  if (c + 1 < d && d % 2 == 0) {
    *reinterpret_cast<uint32_t*>(row + c) = tc::pack_bf16(x, y);
  } else {
    if (c < d) row[c] = __float2bfloat16_rn(x);
    if (c + 1 < d) row[c + 1] = __float2bfloat16_rn(y);
  }
}

// attend_strip's default emit: row r of an (N, dv) output in device memory
struct StoreRows {
  bf16* out;
  int dv;
  __device__ void operator()(int r, int c, float x, float y) const {
    store_pair(out + static_cast<size_t>(r) * dv, c, dv, x, y);
  }
};

// The attention of query strip mt (rows 16 mt .. 16 mt + 15) of one item:
// q_s, k_s (row stride QS) and v_s (row stride VS) in shared memory, bias
// (N, N) fp32 in device memory; `emit(r, c, x, y)` takes the fp32 sums of
// output row r < N, columns c and c + 1 (c even, below pad16(dv)), as
// StoreRows stores them to an (N, dv) output
template <int NKT, typename Emit>
__device__ __forceinline__ void attend_strip(const bf16* q_s, const bf16* k_s, const bf16* v_s,
                                             int QS, int VS, int mt, int N, int kd, int dv,
                                             const float* __restrict__ bias, float scale,
                                             Emit emit, int lane) {
  const int nkt = (N + 15) / 16;   // 16-key tiles
  const int nt = (N + 7) / 8;      // 8-key n-tiles with a key
  const int gid = lane >> 2, tig = lane & 3;
  const int r0 = 16 * mt;

  float s[2 * NKT][4];
#pragma unroll
  for (int t = 0; t < 2 * NKT; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
  for (int kk = 0; kk < pad16(kd) / 16; ++kk) {
    uint32_t a[4];
    tc::load_a(a, q_s + r0 * QS, QS, 16 * kk, lane);
    const bf16* kb = k_s + gid * QS + 16 * kk + 2 * tig;
    const int st = 8 * QS;
#pragma unroll
    for (int t = 0; t < 2 * NKT; ++t) {
      if (t < nt) {
        const bf16* br = kb + t * st;
        tc::mma_bf16(s[t], a, tc::ld32(br), tc::ld32(br + 8));
      }
    }
  }

  // rows ra (c0, c1) and rb (c2, c3) of the strip
  const int ra = r0 + gid, rb = ra + 8;
  const float* bias_a = bias + static_cast<size_t>(min(ra, N - 1)) * N;
  const float* bias_b = bias + static_cast<size_t>(min(rb, N - 1)) * N;
  float mxa = -INFINITY, mxb = -INFINITY;
#pragma unroll
  for (int t = 0; t < 2 * NKT; ++t) {
    if (t < nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * t + 2 * tig + e;
        if (c < N) {
          s[t][e] = __fadd_rn(__fmul_rn(s[t][e], scale), bias_a[c]);
          s[t][2 + e] = __fadd_rn(__fmul_rn(s[t][2 + e], scale), bias_b[c]);
          mxa = fmaxf(mxa, s[t][e]);
          mxb = fmaxf(mxb, s[t][2 + e]);
        }
      }
    }
  }
  mxa = tc::quad_max(mxa);
  mxb = tc::quad_max(mxb);
  float suma = 0.f, sumb = 0.f;
#pragma unroll
  for (int t = 0; t < 2 * NKT; ++t) {
    if (t < nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = 8 * t + 2 * tig + e < N;   // padded keys: P = 0
        s[t][e] = in ? expf(s[t][e] - mxa) : 0.f;
        s[t][2 + e] = in ? expf(s[t][2 + e] - mxb) : 0.f;
        suma += s[t][e];
        sumb += s[t][2 + e];
      }
    }
  }
  suma = tc::quad_sum(suma);
  sumb = tc::quad_sum(sumb);
  const float ria = 1.f / suma, rib = 1.f / sumb;
  // P (bf16) as the A fragments of P.V; the n-tiles past nt hold zeros
  uint32_t pa[NKT][4];
#pragma unroll
  for (int kt = 0; kt < NKT; ++kt) {
    if (kt < nkt) {
#pragma unroll
      for (int t = 2 * kt; t < 2 * kt + 2; ++t) {
        s[t][0] = tc::div_rn(s[t][0], suma, ria);
        s[t][1] = tc::div_rn(s[t][1], suma, ria);
        s[t][2] = tc::div_rn(s[t][2], sumb, rib);
        s[t][3] = tc::div_rn(s[t][3], sumb, rib);
      }
      tc::c_to_a(s[2 * kt], s[2 * kt + 1], pa[kt]);
    }
  }

  // O = P.V, 16 output columns at a time
  for (int n2 = 0; n2 < pad16(dv) / 16; ++n2) {
    float o[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const int vst = 16 * VS;
#pragma unroll
    for (int kt = 0; kt < NKT; ++kt) {
      if (kt < nkt) {
        uint32_t bv[4];
        tc::ldsm_x4_trans(bv, v_s + kt * vst + 16 * n2, VS, lane);
        tc::mma_bf16(o[0], pa[kt], bv[0], bv[1]);
        tc::mma_bf16(o[1], pa[kt], bv[2], bv[3]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 16 * n2 + 8 * h + 2 * tig;
      if (ra < N) emit(ra, c, o[h][0], o[h][1]);
      if (rb < N) emit(rb, c, o[h][2], o[h][3]);
    }
  }
}

// The block's items: blockIdx.x * per_block onwards (see the note at the top)
template <int NKT>
__device__ __forceinline__ void attend_block(const Params& p) {
  extern __shared__ uint4 smem16[];
  const int N = p.N, NP = pad16(N), G = p.per_block;
  const int QS = row_stride(p.kd), VS = row_stride(p.dv);
  const long long item0 = static_cast<long long>(blockIdx.x) * G;
  const int items = static_cast<int>(min(static_cast<long long>(G), p.items - item0));
  bf16* q_s = reinterpret_cast<bf16*>(smem16);   // G * NP * QS
  bf16* k_s = q_s + G * NP * QS;                  // G * NP * QS
  bf16* v_s = k_s + G * NP * QS;                  // G * NP * VS
  const Seg sq(p.q + item0 * N * p.kd, q_s, p.kd);
  const Seg sk(p.k + item0 * N * p.kd, k_s, p.kd);
  const Seg sv(p.v + item0 * N * p.dv, v_s, p.dv);
  stage_qkv<4>(sq, sk, sv, items * NP, N, NP);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int spw = kWarps / G;   // warps an item
  const int g = warp / spw;
  if (g >= items) return;
  const long long it = item0 + g;
  const float* bias = p.bias + static_cast<size_t>(it % p.heads) * N * N;
  for (int mt = warp % spw; mt < NP / 16; mt += spw)
    attend_strip<NKT>(q_s + g * NP * QS, k_s + g * NP * QS, v_s + g * NP * VS, QS, VS, mt, N,
                      p.kd, p.dv, bias, p.scale, StoreRows{p.out + it * N * p.dv, p.dv}, lane);
}

__host__ __device__ constexpr size_t smem_bytes(int per_block, int N, int kd, int dv) {
  return sizeof(bf16) * static_cast<size_t>(per_block) * pad16(N) *
         (2 * row_stride(kd) + row_stride(dv));
}

// Items a block takes: 4 for one-strip windows, 2 for two-strip ones, else
// 1; fewer where their shared memory would not fit
inline int items_per_block(int N, int kd, int dv) {
  const int nkt = (N + 15) / 16;
  int G = nkt == 1 ? 4 : nkt == 2 ? 2 : 1;
  while (G > 1 && smem_bytes(G, N, kd, dv) > kMaxSmem) G /= 2;
  return G;
}

// Launches kern(p) over p.items with p.per_block set; q, k and v must start
// on a 16-byte boundary
template <typename Kern>
cudaError_t launch(Kern kern, Params p, cudaStream_t stream) {
  if ((reinterpret_cast<uintptr_t>(p.q) | reinterpret_cast<uintptr_t>(p.k) |
       reinterpret_cast<uintptr_t>(p.v)) & 15)
    return cudaErrorMisalignedAddress;
  p.per_block = items_per_block(p.N, p.kd, p.dv);
  const size_t smem = smem_bytes(p.per_block, p.N, p.kd, p.dv);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const long long blocks = (p.items + p.per_block - 1) / p.per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace bam
