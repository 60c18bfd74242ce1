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
// forward), P kept in fp32 (not rounded, unlike the forward's), dQ/dK/dV
// stored in the input type at the qkv lanes of `layout`, and
// dbias[h] = sum of dS over every window and image, in fp32. The mask gets
// no gradient; d(qkv bias) is a token sum the caller takes of dqkv.
//
// What bounds it on Hopper: per (window, head) it reads N*(2kd+dv) values
// of qkv and N*dv of dout and writes N*(2kd+dv), and does 5 products of
// 2*N*N*d flops (N = 196 at TinyViT-21M stage 2: ~12 Mflop against ~30 KB),
// so it is bound by arithmetic, here fp32 FMAs on CUDA cores (tensor cores
// are later work), and by how many of them each shared-memory load feeds.
// Its design:
//   * one block of 8 warps per (head, run of consecutive windows); the block
//     walks its windows in order. Addresses come from the window index and
//     the NHWC strides, so nothing is transposed in memory on either side.
//   * K and V of the window are staged in shared memory as fp32, rows
//     padded to an odd multiple of 16 bytes so float4 reads of eight lanes
//     on eight keys hit distinct banks; keys are padded to a multiple of 4
//     with zero rows, and ragged keys are otherwise bounded by an index.
//   * query rows go in tiles of 32, 4 per warp. Phase A: a warp computes the
//     scores and dP of its 4 rows together (lanes over keys), so each K or V
//     float4 it loads feeds 16 FMAs; softmax, rowsum(dP*P) and dS by warp
//     shuffles; P and dS go to shared memory. Phase C: dQ of the tile,
//     threads over (row, channel). Phase B: dK += dS^T.Q and dV += P^T.dO,
//     each thread a 4x4 (keys x channels) block of float4 loads; the sums
//     over tiles live in shared memory (or, where the block's shared memory
//     cannot hold them, N = 256 with d = 64, in a scratch of the block's own
//     in device memory).
//   * keys per lane in phase A are a template parameter: 2 for windows of
//     up to 64 tokens (TinyViT's 7x7), else 8, so a small window's scores
//     hold a quarter of the registers and more blocks fit an SM.
//   * dbias: in phase A the warp adds its dS rows into a partial of the
//     block's own, (groups, heads, N, N) fp32 in device memory (the first
//     window stores, the others add; a lane's loads are issued together),
//     and a second kernel sums the partials over the groups in a fixed
//     order. No atomics: every launch gives the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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
template <typename T, int KD, int DV, int KPL>
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

  const T* qkv = static_cast<const T*>(p.qkv);
  const T* qb = static_cast<const T*>(p.qkv_bias);
  const T* dout = static_cast<const T*>(p.dout);
  T* dqkv = static_cast<T*>(p.dqkv);
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
        x = to_f(qkv[pix(t) * L + ko + d]);
        if (qb) x = round_to<T>(x + to_f(qb[ko + d]));
      }
      k_s[t * KS + d] = x;
    }
    for (int i = tid; i < N4 * DV; i += kThreads) {
      const int t = i / DV, d = i % DV;
      float x = 0.f;
      if (t < N) {
        x = to_f(qkv[pix(t) * L + vo + d]);
        if (qb) x = round_to<T>(x + to_f(qb[vo + d]));
      }
      v_s[t * VS + d] = x;
    }

    for (int n0 = 0; n0 < N; n0 += kRows) {
      const int rows = min(kRows, N - n0);
      for (int i = tid; i < rows * KD; i += kThreads) {
        const int r = i / KD, d = i % KD;
        float x = to_f(qkv[pix(n0 + r) * L + qo + d]);
        if (qb) x = round_to<T>(x + to_f(qb[qo + d]));
        q_t[r * KS + d] = x;
      }
      for (int i = tid; i < rows * DV; i += kThreads) {
        const int r = i / DV, d = i % DV;
        do_t[r * VS + d] = to_f(dout[pix(n0 + r) * DO + h * DV + d]);
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
          if (r < rows) dqkv[pix(n0 + r) * L + qo + d] = from_f<T>(acc[i] * p.scale);
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
      dqkv[pix(m) * L + ko + d] = from_f<T>(dk_acc[m * KD + d] * p.scale);
    }
    for (int i = tid; i < N * DV; i += kThreads) {
      const int m = i / DV, d = i % DV;
      dqkv[pix(m) * L + vo + d] = from_f<T>(dv_acc[m * DV + d]);
    }
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

template <typename T, int KD, int DV>
cudaError_t launch(const Params& p, int groups, float* dbias, cudaStream_t stream) {
  const Geometry geo(p.window, KD, DV);
  const int floats = geo.base() + (p.acc_scratch ? 0 : geo.acc(KD, DV));
  const size_t smem = sizeof(float) * static_cast<size_t>(floats);
  auto kern = geo.N <= 64 ? window_attention_bwd_kernel<T, KD, DV, 2>
                          : window_attention_bwd_kernel<T, KD, DV, 8>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(p.heads, groups), kThreads, smem, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int count = p.heads * geo.N * geo.N;
  dbias_reduce_kernel<<<(count + 255) / 256, 256, 0, stream>>>(p.partial, dbias, groups, count);
  return cudaGetLastError();
}

template <typename T, int KD>
cudaError_t dispatch_dv(int dv, const Params& p, int groups, float* dbias, cudaStream_t s) {
  switch (dv) {
    case 16: return launch<T, KD, 16>(p, groups, dbias, s);
    case 32: return launch<T, KD, 32>(p, groups, dbias, s);
    case 64: return launch<T, KD, 64>(p, groups, dbias, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_kd(int kd, int dv, const Params& p, int groups, float* dbias,
                        cudaStream_t s) {
  switch (kd) {
    case 16: return dispatch_dv<T, 16>(dv, p, groups, dbias, s);
    case 32: return dispatch_dv<T, 32>(dv, p, groups, dbias, s);
    case 64: return dispatch_dv<T, 64>(dv, p, groups, dbias, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// fp32 words of dK/dV scratch per (group, head) block that a launch with
// these sizes needs (0 when the sums fit in shared memory).
extern "C" int cream_window_attention_bwd_scratch(int window, int kd, int dv) {
  return acc_scratch_floats(window, kd, dv);
}

// dtype: 0 float32, 1 bfloat16. `partial` holds groups*heads*N*N floats,
// groups = ceil(B*nH*nW / per_group); `acc_scratch` holds
// groups*heads*cream_window_attention_bwd_scratch(...) floats, or is null
// when that is 0. Returns a cudaError_t (0 on success).
extern "C" int cream_window_attention_bwd(
    const void* qkv, const void* bias, const void* mask, const void* qkv_bias,
    const void* dout, void* dqkv, void* partial, void* acc_scratch, void* dbias,
    int B, int H, int W, int heads, int kd, int dv, int window, int layout, int dtype,
    int per_group, int groups, float scale, void* stream) {
  if (window * window > kMaxTokens || H % window || W % window || layout < 0 ||
      layout > 1 || per_group < 1)
    return cudaErrorInvalidValue;
  const int n_windows = B * (H / window) * (W / window);
  if (groups != (n_windows + per_group - 1) / per_group || groups > 65535)
    return cudaErrorInvalidValue;
  if ((acc_scratch != nullptr) != (acc_scratch_floats(window, kd, dv) > 0))
    return cudaErrorInvalidValue;
  const Params p{qkv, static_cast<const float*>(bias), static_cast<const float*>(mask),
                 qkv_bias, dout, dqkv, static_cast<float*>(partial),
                 static_cast<float*>(acc_scratch), H, W, heads, window, layout,
                 n_windows, per_group, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* db = static_cast<float*>(dbias);
  switch (dtype) {
    case 0: return dispatch_kd<float>(kd, dv, p, groups, db, s);
    case 1: return dispatch_kd<__nv_bfloat16>(kd, dv, p, groups, db, s);
  }
  return cudaErrorInvalidValue;
}
