// EfficientViT's cascaded group attention, the whole cascade of a window in
// one block (eval, BatchNorm folded into the weights).
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
// time is set by bytes. The TPU kernel padded the window to a sublane
// multiple (7 -> 8) with a -1e9 key bucket and a query mask (a Mosaic
// layout rule); here the tokens are taken as they are.
//
// bfloat16 (the tensor cores; `cga_bf16_kernel`): a block of 8 warps takes
// G consecutive windows (the wrapper's `launch_plan`, mirrored by
// `plan_windows` below: of the G whose shared memory lets two blocks share
// an SM and whose products fit the warps' registers in one pass, the
// largest that keeps the card's block slots busy), each at a row pitch NP =
// pad16(N), so both 1x1 products run over R = G*NP rows and every weight
// fragment serves G windows. No sum's order depends on G.
//   - The activations in shared memory are bf16, the type every value was
//     rounded to: x (R x C), which each head's attention overwrites in place
//     (chunk h with relu(o), chunk h + 1 with feat = o + x chunk h + 1), so
//     the cascade's running feat and the concatenated heads share x's
//     buffer; k, v and q after the conv. q itself is kept in fp32 for the
//     conv (its rounded values), and the taps, biases and bproj are fp32, as
//     they come. Rows carry 16 bytes of pad, so every
//     ldmatrix hits distinct banks; the pad rows of a window (t >= N) and
//     of a block's missing windows are zero in x (cp.async zero fill), so
//     their qkv rows are bqkv: finite, written this launch, never stale (P
//     = 0 times NaN would be NaN). Columns past C, kd and d are zero.
//   - Both products run on mma.sync m16n8k16 (bf16 in, fp32 sums; k-steps
//     in order, so the sums' order depends on the shape alone), a warp
//     holding up to kUnits 16x16 output tiles. Their weights (wqkv[h] as
//     it lies, d x (2kd+d); wproj, C x C) stream in chunks of 32 rows
//     through a ring of two slots by 16-byte cp.async, B fragments by
//     ldmatrix.trans. The chunks form one schedule over the whole launch
//     (each head's wqkv, then wproj); a chunk is issued as soon as its slot
//     is free, so head h + 1's first chunks (and its depthwise taps, tap
//     bias and qkv bias) arrive while head h's conv and attention run.
//   - The depthwise conv on q stays on the CUDA cores (fp32, the taps that
//     fall in the window in (dy, dx) order, fmaf as the float32 path does),
//     reading only the ws x ws grid; a thread takes a channel pair of a row
//     of outputs where the build knows ks and ws (`conv_rows`).
//   - The attention is bias_attend_mma.cuh's `attend_strip` (K3's and K5's
//     core), one 16-row query strip a warp, with scale 1 (q is already
//     scaled: __fmul_rn(s, 1) is exact, so s = q . k + bias) and an emit
//     that rounds o and writes relu(o) and the next feat into x's buffer,
//     pad query rows skipped.
//   - Barriers sit between phases only: one a weight chunk (its wait), one
//     after each qkv product, one after each conv.
// float32 (`cga_fused_kernel`, the CUDA cores: the tensor cores' fp32 path
// would round the inputs to TF32): one window a block of 8 warps; x in
// shared memory and each head's relu(o) in place of the chunk it consumed,
// the running feat, the head's qkv (k rows at an odd stride against bank
// conflicts) and q after the conv beside it; the two 1x1 products
// register-tiled over 8 rows a thread, the weights read through L1/L2;
// the attention is cga_attend.cuh's (one warp a query row).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "bias_attend_mma.cuh"
#include "cga_attend.cuh"
#include "cp_async.cuh"

namespace {

// ---------------------------------------------------------------- float32

constexpr int kWarps = 8;
constexpr int kRows = 8;  // rows of a register tile in the 1x1 products

struct Params {
  const float* x;      // (Nw, N, C)
  const float* bias;   // (heads, N, N)
  const float* wqkv;   // (heads, d, 2kd+d)
  const float* bqkv;   // (heads, 2kd+d)
  const float* dwk;    // (heads, ks, ks, kd)
  const float* dwb;    // (heads, kd)
  const float* wproj;  // (heads*d, C)
  const float* bproj;  // (C,)
  float* out;          // (Nw, N, C)
  int ws, heads, kd, d, ks;
  float scale;
};

__host__ __device__ constexpr size_t align16(size_t b) { return (b + 15) & ~size_t(15); }

// byte offsets of the shared-memory regions
struct Layout {
  size_t feat, qkv, qd, p, total;
  __host__ __device__ Layout(int N, int C, int kd, int d) {
    const int S = (2 * kd + d) | 1;
    feat = align16(sizeof(float) * N * C);
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
template <typename Epi>
__device__ __forceinline__ void block_gemm(const float* A, int lda, const float* __restrict__ B,
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
    const float* b = B + col;
    for (int k = 0; k < K; ++k) {
      const float bk = b[static_cast<size_t>(k) * ldb];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = fmaf(A[off[r] + k], bk, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r0 + r < M) epi(r0 + r, col, acc[r]);
  }
}

__global__ void __launch_bounds__(kWarps * 32) cga_fused_kernel(Params p) {
  extern __shared__ float4 smem4[];
  const int N = p.ws * p.ws, kd = p.kd, d = p.d, C = p.heads * d, ks = p.ks;
  const int L = 2 * kd + d, S = L | 1, pad = ks / 2;
  const Layout lay(N, C, kd, d);
  char* base = reinterpret_cast<char*>(smem4);
  float* buf = reinterpret_cast<float*>(base);              // N * C: x, then relu(o) per head
  float* feat = reinterpret_cast<float*>(base + lay.feat);  // N * d
  float* qkv = reinterpret_cast<float*>(base + lay.qkv);    // N * S
  float* qd = reinterpret_cast<float*>(base + lay.qd);      // N * kd
  float* p_s = reinterpret_cast<float*>(base + lay.p);

  const size_t w0 = static_cast<size_t>(blockIdx.x) * N * C;
  const float* x = p.x + w0;
  for (int i = threadIdx.x; i < N * C; i += blockDim.x) {
    const float xv = x[i];
    buf[i] = xv;
    if (i % C < d) feat[(i / C) * d + i % C] = xv;
  }
  __syncthreads();

  for (int h = 0; h < p.heads; ++h) {
    const float* bq = p.bqkv + h * L;
    block_gemm(feat, d, p.wqkv + static_cast<size_t>(h) * d * L, L, N, d, L,
               [&](int n, int j, float acc) { qkv[n * S + j] = acc + bq[j]; });
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
      qd[i] = acc * p.scale;
    }
    __syncthreads();

    const bool last = h + 1 == p.heads;
    const float* bias = p.bias + static_cast<size_t>(h) * N * N;
    // q is already scaled: the scores are q.k + bias
    cga::attend_rows<float, 2, false>(
        qd, kd, qkv + kd, S, qkv + 2 * kd, S, bias, 1.f, N, kd, d, p_s,
        [&](int n, int c, float o) {
          float* row = buf + n * C;
          if (!last) feat[n * d + c] = o + row[(h + 1) * d + c];
          row[h * d + c] = fmaxf(o, 0.f);
        });
    __syncthreads();
  }

  float* out = p.out + w0;
  block_gemm(buf, C, p.wproj, C, N, C, C,
             [&](int n, int c, float acc) { out[n * C + c] = acc + p.bproj[c]; });
}

cudaError_t launch_fp32(const Params& p, int Nw, cudaStream_t stream) {
  const size_t smem = Layout(p.ws * p.ws, p.heads * p.d, p.kd, p.d).total;
  auto kern = cga_fused_kernel;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<Nw, kWarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bfloat16

namespace b16 {

using bf16 = __nv_bfloat16;
using bam::pad16;
using cpa::cp_async16;
using cpa::cp_async_commit;
using cpa::cp_async_wait;
using tc::ldsm_x4;
using tc::ldsm_x4_trans;
using tc::mma_bf16;
using tc::pack_bf16;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnits = 9;       // 16x16 output tiles a warp holds in one pass of a product
constexpr int kChunk = 32;      // weight rows a ring slot holds: two k-steps
constexpr int kMaxG = 8;        // windows a block
// a block's shared memory when two share an SM ((228 KB less 1 KB reserved
// a block) / 2), and the most one block may use
constexpr size_t kSmemPair = 115712;
constexpr size_t kSmemMax = 232448;
constexpr int kSMs = 132;       // the H100's SMs: the plan fills waves of two blocks each

// Element counts, row strides (bf16 elements: 16 bytes over a multiple of
// 16, so ldmatrix's eight rows fall in distinct banks) and byte offsets of
// the shared-memory regions of a block of G windows: x (bf16), q (fp32, the
// conv's input), k and q after the conv (bf16), v (bf16), the weight ring,
// three slots of a head's taps, tap bias and qkv bias (fp32), bproj (fp32)
struct Dims {
  int ws, N, NP, heads, kd, d, C, L, ks, G, R, MT, XS, QS, VS, BS;
  size_t q, k, qd, v, w, dw, bp, total;

  __host__ __device__ Dims(int ws_, int heads_, int kd_, int d_, int ks_, int G_)
      : ws(ws_), N(ws_ * ws_), NP(pad16(ws_ * ws_)), heads(heads_), kd(kd_), d(d_),
        C(heads_ * d_), L(2 * kd_ + d_), ks(ks_), G(G_) {
    R = G * NP;                 // rows of the block's products
    MT = R / 16;                // their m-tiles
    XS = pad16(C) + 8;          // x / feat / cat
    QS = pad16(kd) + 8;         // q, k, q after the conv
    VS = pad16(d) + 8;          // v
    BS = XS > pad16(L) + 8 ? XS : pad16(L) + 8;   // a ring slot's rows (wqkv or wproj)
    q = 2 * static_cast<size_t>(R) * XS;
    k = q + 4 * static_cast<size_t>(R) * kd;
    qd = k + 2 * static_cast<size_t>(R) * QS;
    v = qd + 2 * static_cast<size_t>(R) * QS;
    w = v + 2 * static_cast<size_t>(R) * VS;
    dw = w + 2 * 2 * static_cast<size_t>(kChunk) * BS;
    bp = dw + 4 * 3 * static_cast<size_t>(slot());
    total = bp + 4 * static_cast<size_t>(C);
  }
  // floats a head's slot holds: its taps (ks, ks, kd), their bias, bqkv
  __host__ __device__ int slot() const { return ks * ks * kd + kd + L; }
};

// passes of a product over MT m-tiles and nq 16-column n-pairs: the fewest
// whose share of the n-pairs keeps every warp within kUnits tiles
__host__ __device__ inline int passes(int MT, int nq) {
  int p = 1;
  while (MT * ((nq + p - 1) / p) > kWarps * kUnits) ++p;
  return p;
}

// The share of the card's block slots (two an SM) that Nw windows at G a
// block keep busy over their waves
inline double wave_fill(long long Nw, int G) {
  const long long blocks = (Nw + G - 1) / G, slots = 2LL * kSMs;
  return static_cast<double>(blocks) / (((blocks + slots - 1) / slots) * slots);
}

// The launch plan for Nw windows: among the window counts G (at most kMaxG)
// whose shared memory lets two blocks share an SM and whose products each
// take one pass, the largest that fills at least 90% of its waves' block
// slots, else the one that fills most; one window a block if none of them
// fits but one fits an SM alone; 0 if nothing fits. G moves no sum: each
// window's rows are m-tiles of their own. Mirrored by ops/cga.py
// `launch_plan`.
inline int plan_windows(long long Nw, int ws, int heads, int kd, int d, int ks) {
  if (kd % 8 || d % 8) return 0;
  int best = 0;
  for (int G = 1; G <= kMaxG; ++G) {
    const Dims D(ws, heads, kd, d, ks, G);
    if (D.total > kSmemPair || passes(D.MT, pad16(D.C) / 16) > 1 ||
        passes(D.MT, pad16(D.L) / 16) > 1)
      break;
    if (!best || wave_fill(Nw, G) >= 0.9 || wave_fill(Nw, G) >= wave_fill(Nw, best)) best = G;
  }
  if (best) return best;
  return Dims(ws, heads, kd, d, ks, 1).total <= kSmemMax ? 1 : 0;
}

struct Args {
  const bf16* x;        // (Nw, N, C)
  const float* bias;    // (heads, N, N)
  const bf16* wqkv;     // (heads, d, L)
  const float* bqkv;    // (heads, L)
  const float* dwk;     // (heads, ks, ks, kd)
  const float* dwb;     // (heads, kd)
  const bf16* wproj;    // (C, C)
  const float* bproj;   // (C,)
  bf16* out;            // (Nw, N, C)
  long long Nw;
  float scale;
};

__device__ __forceinline__ float2 bf16x2_at(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// A warp's tiles in one pass of a product over MT m-tiles and the n-pairs
// [q0, q0 + nq): tile u = warp + kWarps * j is (m-tile u % MT, n-pair q0 +
// u / MT), packed as m | q << 16
struct Tiles {
  int n;
  int mq[kUnits];
  __device__ Tiles(int MT, int q0, int nq, int warp) : n(0) {
#pragma unroll
    for (int j = 0; j < kUnits; ++j) {
      const int u = warp + kWarps * j;
      mq[j] = 0;
      if (u < MT * nq) {
        mq[j] = u % MT | (q0 + u / MT) << 16;
        n = j + 1;
      }
    }
  }
};

// acc[j] += A . B over `ksteps` k-steps for the warp's NU tiles: A rows
// 16m.. at `A` (row stride lda, its first k column), B rows at `B` (row
// stride ldb, row-major (k, n)). ldmatrix and mma.sync stay in program order
// (both are volatile asm), so tile j + 1's B fragment is loaded before tile
// j's products, and A's only where m changes.
template <int NU>
__device__ __forceinline__ void mma_steps(float (&acc)[kUnits][2][4], const Tiles& t,
                                          const bf16* A, int lda, const bf16* B, int ldb,
                                          int ksteps, int lane) {
  for (int kk = 0; kk < ksteps; ++kk) {
    const bf16* Bk = B + 16 * kk * ldb;
    uint32_t a[4], b[2][4];
    int m_prev = t.mq[0] & 0xffff;
    ldsm_x4(a, A + 16 * m_prev * lda + 16 * kk, lda, lane);
    ldsm_x4_trans(b[0], Bk + 16 * (t.mq[0] >> 16), ldb, lane);
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      if (j + 1 < NU) ldsm_x4_trans(b[(j + 1) & 1], Bk + 16 * (t.mq[j + 1] >> 16), ldb, lane);
      const int m = t.mq[j] & 0xffff;
      if (m != m_prev) {
        ldsm_x4(a, A + 16 * m * lda + 16 * kk, lda, lane);
        m_prev = m;
      }
      mma_bf16(acc[j][0], a, b[j & 1][0], b[j & 1][1]);
      mma_bf16(acc[j][1], a, b[j & 1][2], b[j & 1][3]);
    }
  }
}

// mma_steps for the warp's t.n tiles
__device__ __forceinline__ void mma_tiles(float (&acc)[kUnits][2][4], const Tiles& t,
                                          const bf16* A, int lda, const bf16* B, int ldb,
                                          int ksteps, int lane) {
  switch (t.n) {
    case 1: return mma_steps<1>(acc, t, A, lda, B, ldb, ksteps, lane);
    case 2: return mma_steps<2>(acc, t, A, lda, B, ldb, ksteps, lane);
    case 3: return mma_steps<3>(acc, t, A, lda, B, ldb, ksteps, lane);
    case 4: return mma_steps<4>(acc, t, A, lda, B, ldb, ksteps, lane);
    case 5: return mma_steps<5>(acc, t, A, lda, B, ldb, ksteps, lane);
    case 6: return mma_steps<6>(acc, t, A, lda, B, ldb, ksteps, lane);
    case 7: return mma_steps<7>(acc, t, A, lda, B, ldb, ksteps, lane);
    case 8: return mma_steps<8>(acc, t, A, lda, B, ldb, ksteps, lane);
    case 9: return mma_steps<9>(acc, t, A, lda, B, ldb, ksteps, lane);
  }
}

// The block's state and phases (see the note at the top)
struct Block {
  const Args& a;
  const Dims& D;
  bf16 *x_s, *k_s, *qd_s, *v_s, *ring;
  float *q_f, *dws, *bp;
  int tid, warp, lane, gw;
  long long w0;
  int cq, pq, cp, pp, Sq, S;  // chunks and passes of each qkv product / the projection; steps
  int issued;                 // weight chunks issued so far (one cp.async group each)
  // a thread's 16-byte column chunk and first row, and the rows it steps, in
  // a copy of x's rows (XS / 8 chunks a row) or a ring slot's (BS / 8); a
  // block that fits kSmemMax has BS < 1,773 (the ring's two 32-row slots),
  // so a row is fewer chunks than threads
  int xc, xr, xstep, bc, br, bstep;

  __device__ Block(const Args& a_, const Dims& D_, char* base) : a(a_), D(D_) {
    x_s = reinterpret_cast<bf16*>(base);
    q_f = reinterpret_cast<float*>(base + D.q);
    k_s = reinterpret_cast<bf16*>(base + D.k);
    qd_s = reinterpret_cast<bf16*>(base + D.qd);
    v_s = reinterpret_cast<bf16*>(base + D.v);
    ring = reinterpret_cast<bf16*>(base + D.w);
    dws = reinterpret_cast<float*>(base + D.dw);
    bp = reinterpret_cast<float*>(base + D.bp);
    tid = threadIdx.x;
    warp = tid / 32;
    lane = tid % 32;
    w0 = static_cast<long long>(blockIdx.x) * D.G;
    gw = static_cast<int>(min(static_cast<long long>(D.G), a.Nw - w0));
    cq = (pad16(D.d) + kChunk - 1) / kChunk;
    pq = passes(D.MT, pad16(D.L) / 16);
    cp = (pad16(D.C) + kChunk - 1) / kChunk;
    pp = passes(D.MT, pad16(D.C) / 16);
    Sq = pq * cq;
    S = D.heads * Sq + pp * cp;
    issued = 0;
    xc = tid % (D.XS / 8);
    xr = tid / (D.XS / 8);
    xstep = kThreads / (D.XS / 8);
    bc = tid % (D.BS / 8);
    br = tid / (D.BS / 8);
    bstep = kThreads / (D.BS / 8);
  }

  // x's rows of the block's windows, zero in pad rows, missing windows and
  // columns past C; and bproj
  __device__ void stage_x() const {
    for (int i = tid; i < D.C / 4; i += kThreads) cp_async16(bp + 4 * i, a.bproj + 4 * i, true);
    if (xr >= xstep) return;               // threads past the last whole row of chunks
    for (int r = xr; r < D.R; r += xstep) {
      const int g = r / D.NP, t = r - g * D.NP;
      const bool ok = g < gw && t < D.N && 8 * xc < D.C;
      const bf16* src = ok ? a.x + ((w0 + g) * D.N + t) * D.C + 8 * xc : a.x;
      cp_async16(x_s + r * D.XS + 8 * xc, src, ok);
    }
  }

  // Issues the next weight chunk of the schedule (ring slot `issued` & 1) as
  // one commit group: chunk c of pass p of head h's wqkv (rows 32c.. of d,
  // zero past d and past its L columns), with head h's taps, tap bias and
  // qkv bias (slot h % 3: a head's conv runs while the chunks of at most two
  // later heads arrive) on its first chunk, or chunk c of wproj
  __device__ void issue() {
    const int s = issued++;
    const bf16* src;
    int rows, cols, chunk;
    if (s < D.heads * Sq) {
      const int h = s / Sq;
      chunk = s % Sq % cq;
      src = a.wqkv + static_cast<size_t>(h) * D.d * D.L;
      rows = D.d;
      cols = D.L;
      if (s % Sq == 0) {
        float* dst = dws + h % 3 * D.slot();
        const int nk = D.ks * D.ks * D.kd / 4, nb = nk + D.kd / 4;
        const float* wk = a.dwk + static_cast<size_t>(h) * D.ks * D.ks * D.kd;
        for (int i = tid; i < D.slot() / 4; i += kThreads)
          cp_async16(dst + 4 * i,
                     i < nk   ? wk + 4 * i
                     : i < nb ? a.dwb + h * D.kd + 4 * (i - nk)
                              : a.bqkv + h * D.L + 4 * (i - nb),
                     true);
      }
    } else {
      chunk = (s - D.heads * Sq) % cp;
      src = a.wproj;
      rows = cols = D.C;
    }
    const int r0 = chunk * kChunk;
    bf16* dst = ring + (s & 1) * kChunk * D.BS;
    if (br < bstep) {
      for (int r = br; r < kChunk; r += bstep) {
        const bool ok = r0 + r < rows && 8 * bc < cols;
        cp_async16(dst + r * D.BS + 8 * bc,
                   ok ? src + static_cast<size_t>(r0 + r) * cols + 8 * bc : src, ok);
      }
    }
    cp_async_commit();
  }

  // One product of the schedule, steps s0..: C (R x 16 nq) = A (R x 16
  // ksteps, row stride lda) . B, B streamed through the ring in `chunks`
  // chunks a pass; `epi(r, c, v0, v1)` takes the fp32 sums of (r, c) and
  // (r, c + 1). The first step's barrier is also the barrier after the
  // previous phase.
  template <typename Epi>
  __device__ void product(int s0, int chunks, int np, int ksteps, const bf16* A, int lda, int nq,
                          Epi epi) {
    const int per = (nq + np - 1) / np;
    for (int p = 0; p < np; ++p) {
      const int q0 = p * per;
      const Tiles t(D.MT, q0, min(per, nq - q0), warp);
      float acc[kUnits][2][4];
#pragma unroll
      for (int j = 0; j < kUnits; ++j)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[j][e / 4][e % 4] = 0.f;
      for (int c = 0; c < chunks; ++c) {
        const int s = s0 + p * chunks + c;
        if (issued > s + 1)
          cp_async_wait<1>();
        else
          cp_async_wait<0>();
        __syncthreads();                 // step s landed; every warp is done with step s - 1
        if (issued == s + 1 && issued < S) issue();   // into step s - 1's slot
        mma_tiles(acc, t, A + 2 * 16 * c, lda, ring + (s & 1) * kChunk * D.BS, D.BS,
                  min(2, ksteps - 2 * c), lane);
      }
      const int gid = lane / 4, tig = lane % 4;
#pragma unroll
      for (int j = 0; j < kUnits; ++j) {
        if (j < t.n) {
          const int r = 16 * (t.mq[j] & 0xffff) + gid;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int col = 16 * (t.mq[j] >> 16) + 8 * hh + 2 * tig;
            epi(r, col, acc[j][hh][0], acc[j][hh][1]);
            epi(r + 8, col, acc[j][hh][2], acc[j][hh][3]);
          }
        }
      }
    }
  }

  // q (fp32, R x kd) -> q after the depthwise conv, times the scale, for the
  // block's windows' real rows; every output takes the taps that fall in the
  // window in (dy, dx) order, one fmaf each, the float32 path's arithmetic.
  // Where the build knows ks and ws (KS, WS: EfficientViT's 3/5/7 taps on
  // 7x7 and 4x4 windows) a thread takes a channel pair of a row of outputs:
  // it loads each input row once, the out-of-window rows are skipped and the
  // out-of-window columns never emitted. Other shapes: a thread an output.
  template <int KS, int WS>
  __device__ void conv_rows(int h) const {
    constexpr int pad = KS / 2;
    const int kd = D.kd, kh = kd / 2;
    const float* wk = dws + h % 3 * D.slot();
    const float* bk = wk + KS * KS * kd;
    for (int i = tid; i < gw * WS * kh; i += kThreads) {
      const int c = 2 * (i % kh), y = i / kh % WS, g = i / (kh * WS);
      const float* qw = q_f + g * D.NP * kd + c;
      float2 acc[WS];
#pragma unroll
      for (int x = 0; x < WS; ++x) acc[x] = *reinterpret_cast<const float2*>(bk + c);
#pragma unroll
      for (int dy = 0; dy < KS; ++dy) {
        const int yy = y + dy - pad;
        if (yy < 0 || yy >= WS) continue;
        float2 q[WS];
#pragma unroll
        for (int x = 0; x < WS; ++x) q[x] = *reinterpret_cast<const float2*>(qw + (yy * WS + x) * kd);
#pragma unroll
        for (int dx = 0; dx < KS; ++dx) {
          const float2 w = *reinterpret_cast<const float2*>(wk + (dy * KS + dx) * kd + c);
#pragma unroll
          for (int x = 0; x < WS; ++x) {
            if (x + dx - pad >= 0 && x + dx - pad < WS) {
              acc[x].x = fmaf(q[x + dx - pad].x, w.x, acc[x].x);
              acc[x].y = fmaf(q[x + dx - pad].y, w.y, acc[x].y);
            }
          }
        }
      }
#pragma unroll
      for (int x = 0; x < WS; ++x)
        *reinterpret_cast<uint32_t*>(qd_s + (g * D.NP + y * WS + x) * D.QS + c) =
            pack_bf16(acc[x].x * a.scale, acc[x].y * a.scale);
    }
  }

  __device__ void conv(int h) const {
    if (D.ws == 7 || D.ws == 4) {
      const bool w7 = D.ws == 7;
      switch (D.ks) {
        case 3: return w7 ? conv_rows<3, 7>(h) : conv_rows<3, 4>(h);
        case 5: return w7 ? conv_rows<5, 7>(h) : conv_rows<5, 4>(h);
        case 7: return w7 ? conv_rows<7, 7>(h) : conv_rows<7, 4>(h);
      }
    }
    const int ks = D.ks, kd = D.kd, kh = kd / 2, pad = ks / 2, ws = D.ws;
    const float* wk = dws + h % 3 * D.slot();
    const float* bk = wk + ks * ks * kd;
    for (int i = tid; i < gw * D.N * kh; i += kThreads) {
      const int c = 2 * (i % kh), n = i / kh % D.N, g = i / (kh * D.N);
      const int y = n / ws, x = n - y * ws;
      float2 acc = *reinterpret_cast<const float2*>(bk + c);
      const float* qw = q_f + g * D.NP * kd + c;
      const int dy1 = min(ks, ws + pad - y), dx0 = max(0, pad - x), dx1 = min(ks, ws + pad - x);
      for (int dy = max(0, pad - y); dy < dy1; ++dy) {
        const int row = (y + dy - pad) * ws + x - pad;
        const float* wr = wk + dy * ks * kd + c;
        for (int dx = dx0; dx < dx1; ++dx) {
          const float2 q = *reinterpret_cast<const float2*>(qw + (row + dx) * kd);
          const float2 w = *reinterpret_cast<const float2*>(wr + dx * kd);
          acc.x = fmaf(q.x, w.x, acc.x);
          acc.y = fmaf(q.y, w.y, acc.y);
        }
      }
      *reinterpret_cast<uint32_t*>(qd_s + (g * D.NP + n) * D.QS + c) =
          pack_bf16(acc.x * a.scale, acc.y * a.scale);
    }
  }

  // head h's attention, a 16-row query strip a warp: relu(o) into x's chunk
  // h, feat = round(o + x chunk h + 1) into chunk h + 1
  template <int NKT>
  __device__ void attend(int h) const {
    const float* bias = a.bias + static_cast<size_t>(h) * D.N * D.N;
    const int spw = D.NP / 16, d = D.d;
    const bool next = h + 1 < D.heads;
    for (int s = warp; s < gw * spw; s += kWarps) {
      const int g = s / spw;
      bf16* rows = x_s + g * D.NP * D.XS;
      bam::attend_strip<NKT>(
          qd_s + g * D.NP * D.QS, k_s + g * D.NP * D.QS, v_s + g * D.NP * D.VS, D.QS, D.VS,
          s - g * spw, D.N, D.kd, d, bias, 1.f,
          [&](int r, int c, float o0, float o1) {
            if (c >= d) return;
            bf16* row = rows + r * D.XS;
            const float2 o = __bfloat1622float2(__floats2bfloat162_rn(o0, o1));
            *reinterpret_cast<uint32_t*>(row + h * d + c) =
                pack_bf16(fmaxf(o.x, 0.f), fmaxf(o.y, 0.f));
            if (next) {
              const float2 xn = bf16x2_at(row + (h + 1) * d + c);
              *reinterpret_cast<uint32_t*>(row + (h + 1) * d + c) =
                  pack_bf16(o.x + xn.x, o.y + xn.y);
            }
          },
          lane);
    }
  }

  // zeros that no phase writes: k and q-after-conv columns past kd, and the
  // pad rows of q after the conv (pad query rows, never stored)
  __device__ void zero_pads() const {
    const uint32_t z = 0u;
    const int pc = (D.QS - D.kd) / 2, full = D.QS / 2;
    for (int i = tid; i < D.R * pc; i += kThreads) {
      const int r = i / pc, c = D.kd + 2 * (i % pc);
      *reinterpret_cast<uint32_t*>(k_s + r * D.QS + c) = z;
      *reinterpret_cast<uint32_t*>(qd_s + r * D.QS + c) = z;
    }
    for (int i = tid; i < D.R * full; i += kThreads) {
      const int r = i / full;
      if (r % D.NP >= D.N) *reinterpret_cast<uint32_t*>(qd_s + r * D.QS + 2 * (i % full)) = z;
    }
  }
};

template <int NKT>
__global__ void __launch_bounds__(kThreads, 2) cga_bf16_kernel(const Args a, const Dims D) {
  extern __shared__ uint4 smem16[];
  Block b(a, D, reinterpret_cast<char*>(smem16));
  const int C = D.C, d = D.d, kd = D.kd, L = D.L;

  b.stage_x();
  b.issue();        // with x and bproj: head 0's first wqkv chunk and its taps
  if (b.S > 1) b.issue();
  b.zero_pads();

  for (int h = 0; h < D.heads; ++h) {
    const float* bq = b.dws + h % 3 * D.slot() + D.ks * D.ks * kd + kd;
    // qkv = round(feat . wqkv[h] + bqkv[h]) over all R rows (feat = x's
    // chunk h); q kept in fp32 for the conv
    b.product(h * b.Sq, b.cq, b.pq, pad16(d) / 16, b.x_s + h * d, D.XS, pad16(L) / 16,
              [&](int r, int c, float v0, float v1) {
                if (c >= L) return;
                const float2 bb = *reinterpret_cast<const float2*>(bq + c);
                const uint32_t v = pack_bf16(v0 + bb.x, v1 + bb.y);
                if (c < kd)
                  *reinterpret_cast<float2*>(b.q_f + r * kd + c) =
                      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
                else
                  *reinterpret_cast<uint32_t*>(c < 2 * kd ? b.k_s + r * D.QS + c - kd
                                                          : b.v_s + r * D.VS + c - 2 * kd) = v;
              });
    __syncthreads();                     // q, k, v written; both ring slots free
    // the schedule's next chunk beside the one in flight (at most two ahead)
    if (b.issued == (h + 1) * b.Sq + 1 && b.issued < b.S) b.issue();
    b.conv(h);
    __syncthreads();
    b.attend<NKT>(h);
  }

  // out = round(cat . wproj + bproj) for the windows' real rows
  const int s0 = D.heads * b.Sq, NP = D.NP, N = D.N, gw = b.gw;
  const long long w0 = b.w0;
  b.product(s0, b.cp, b.pp, pad16(C) / 16, b.x_s, D.XS, pad16(C) / 16,
            [&](int r, int c, float v0, float v1) {
              const int g = r / NP, t = r - g * NP;   // NP is 16 or 64 on EfficientViT's windows
              if (c >= C || g >= gw || t >= N) return;
              const float2 bb = *reinterpret_cast<const float2*>(b.bp + c);
              *reinterpret_cast<uint32_t*>(a.out + ((w0 + g) * N + t) * C + c) =
                  pack_bf16(v0 + bb.x, v1 + bb.y);
            });
}

template <int NKT>
cudaError_t launch_nkt(const Args& a, const Dims& D, cudaStream_t stream) {
  auto kern = cga_bf16_kernel<NKT>;
  const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(D.total));
  if (e != cudaSuccess) return e;
  const long long blocks = (a.Nw + D.G - 1) / D.G;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kern<<<static_cast<unsigned>(blocks), kThreads, D.total, stream>>>(a, D);
  return cudaGetLastError();
}

cudaError_t launch(const Args& a, const Dims& D, cudaStream_t stream) {
  switch (D.NP / 16) {   // 16-key tiles of attend_strip's scores
    case 1: return launch_nkt<1>(a, D, stream);
    case 2: return launch_nkt<2>(a, D, stream);
    case 3: return launch_nkt<3>(a, D, stream);
    case 4: return launch_nkt<4>(a, D, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace b16

bool misaligned(const void* p, uintptr_t bytes) { return reinterpret_cast<uintptr_t>(p) % bytes; }

}  // namespace

// The launch plan for Nw windows (dtype: 0 float32, 1 bfloat16): the windows
// a block takes (0 where no plan fits; float32 takes one) and, in *smem, the
// bytes of shared memory a block then needs. ops/cga.py `launch_plan`
// mirrors it.
extern "C" int cream_cga_plan(long long Nw, int ws, int heads, int kd, int d, int ks, int dtype,
                              long long* smem) {
  if (dtype == 0) {
    *smem = static_cast<long long>(Layout(ws * ws, heads * d, kd, d).total);
    return 1;
  }
  const int G = b16::plan_windows(Nw, ws, heads, kd, d, ks);
  *smem = static_cast<long long>(b16::Dims(ws, heads, kd, d, ks, G > 0 ? G : 1).total);
  return G;
}

// dtype: 0 float32, 1 bfloat16; windows: windows a block (`cream_cga_plan`'s
// for the shape; 1 for float32). The bfloat16 path copies x, wqkv, wproj
// and the fp32 operands 16 bytes at a time (16-byte aligned; kd and d
// multiples of 8).
// Returns a cudaError_t (0 on success).
extern "C" int cream_cga_fused(const void* x, const void* bias, const void* wqkv,
                               const void* bqkv, const void* dwk, const void* dwb,
                               const void* wproj, const void* bproj, void* out, long long Nw,
                               int ws, int heads, int kd, int d, int ks, int dtype, float scale,
                               int windows, void* stream) {
  if (Nw < 1 || ws < 1 || ws * ws > cga::kMaxTokens || heads < 1 || kd < 1 || d < 1 ||
      ks < 1 || ks % 2 == 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (windows != 1 || Nw > 0x7fffffffLL) return cudaErrorInvalidValue;
    const auto f = [](const void* t) { return static_cast<const float*>(t); };
    const Params p{f(x),    f(bias), f(wqkv),  f(bqkv),
                   f(dwk),  f(dwb),  f(wproj), f(bproj),
                   static_cast<float*>(out), ws, heads, kd, d, ks, scale};
    return launch_fp32(p, static_cast<int>(Nw), s);
  }
  if (dtype != 1 || windows < 1 || windows > b16::kMaxG || kd % 8 || d % 8 ||
      misaligned(x, 16) || misaligned(wqkv, 16) || misaligned(wproj, 16) ||
      misaligned(dwk, 16) || misaligned(dwb, 16) || misaligned(bqkv, 16) ||
      misaligned(bproj, 16) || misaligned(out, 4))
    return cudaErrorInvalidValue;
  const b16::Dims D(ws, heads, kd, d, ks, windows);
  if (D.total > b16::kSmemMax) return cudaErrorInvalidValue;
  using b16::bf16;
  const b16::Args a{static_cast<const bf16*>(x), static_cast<const float*>(bias),
                    static_cast<const bf16*>(wqkv), static_cast<const float*>(bqkv),
                    static_cast<const float*>(dwk), static_cast<const float*>(dwb),
                    static_cast<const bf16*>(wproj), static_cast<const float*>(bproj),
                    static_cast<bf16*>(out), Nw, scale};
  return b16::launch(a, D, s);
}
