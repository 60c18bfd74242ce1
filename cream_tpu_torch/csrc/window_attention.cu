// Window bias-attention forward, read straight from the NHWC qkv tensor.
//
// Replaces: cream_tpu/ops/pallas/window_attention.py `_kernel` (reached
// through `fused_window_attention` -> `_fwa` -> `_pallas_fwd`), the forward
// of the fused window attention that TinyViT and Swin call once per block.
//
// What it computes, per window, head and query row n:
//   out[n] = softmax(q[n] . K^T * scale + bias[h][n] (+ mask[win][n])) . V
// with fp32 scores, the exact per-row max, fp32 sums, P divided by its row
// sum and then rounded to the input type before P.V, P.V accumulated in fp32
// and the result stored in the input type at (B, H, W, heads*dv). An
// optional qkv projection bias is added to q/k/v on load and rounded to the
// input type, as the caller's GEMM epilogue would have done. Two lane
// packings of the qkv row: head_major ([q_h|k_h|v_h] per head) and qkv_major
// ([q all|k all|v all]). The score is (S * scale) + bias (+ mask), each
// operation rounded on its own (__fmul_rn/__fadd_rn) as the plain version
// does: no FMA contraction.
//
// What bounds it on Hopper: per (window, head) it reads N*(2kd+dv) values of
// qkv and writes N*dv, and does 2*N*N*(kd+dv) flops. At TinyViT-21M's stage 2
// (N = 196, d = 32, bs256) that is 15.1 Gflop, 0.015 ms at 989 TFLOP/s, against
// 0.047 ms for its qkv and output bytes at 3.35 TB/s: the bound is bytes. The
// fp32 bias (heads, N, N) is read again by every window, from L2: at stage 2
// ~4x the bytes of qkv, and the largest traffic once the products run on
// the tensor cores.
//
// bfloat16 (the model path): both products on the tensor cores, mma.sync
// m16n8k16 with fp32 sums (bf16_mma.cuh). It replaces PR 1's CUDA-core bf16
// kernel (one warp per query row, fp32 FMAs; 16.84 ms per TinyViT-21M-224
// bs256 forward). One block of 4 warps per (head, window, image):
//   * K and V of the window go to shared memory as bf16, bias-folded on
//     load (16 bytes a thread through registers, every load of a thread in
//     flight at once), rows padded to NP, the next multiple of 16, with
//     zeros (a padded K or V row must be zero, not stale: P = 0 times NaN is
//     NaN). Rows are padded by 16 bytes so every fragment load hits 32
//     distinct banks. Q goes there too where a warp takes several strips;
//     in windows of up to 64 tokens a warp's only strip loads its Q A
//     fragments straight from device memory, beside K and V.
//   * each warp takes 16-row query strips. S = Q.K^T for the whole strip
//     stays in registers, at most 32 n-tiles x 4 floats (NKT, the strip's
//     16-key tiles, is a template parameter in buckets 4/9/13/16, so a
//     49-token window holds 32 floats, not 128); n-tiles past the last key
//     are skipped. Padded keys drop out of the max and the sum; the row max
//     and sum go over the four lanes of a quad by shuffles.
//   * P = e / sum, the correctly rounded quotient (tc::div_rn), is packed to
//     bf16 straight from the C fragments into the A fragments of P.V (two
//     adjacent n-tiles are one k-tile), and V is the B operand through
//     ldmatrix.trans. The (N, N) scores never leave the registers; padded
//     query rows are never stored.
// float32: the CUDA-core kernel as before (tensor cores would round the
// inputs to TF32, past the fp32 bound): one warp per query row, K and V in
// shared memory as fp32 with odd-multiple-of-16-byte rows, scores in
// registers (lanes over keys), P through a per-warp row of shared memory,
// a lane per output channel.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "bf16_mma.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kMaxTokens = 256;
constexpr int kKeysPerLane = kMaxTokens / 32;

struct Params {
  const void* qkv;       // (B, H, W, L), L = heads * (2*kd + dv)
  const float* bias;     // (heads, N, N)
  const float* mask;     // (nH*nW, N, N) or null
  const void* qkv_bias;  // (L,) in the input type, or null
  void* out;             // (B, H, W, heads*dv)
  int H, W, heads, window, layout;  // layout 0: head_major, 1: qkv_major
  float scale;
};

// Lane offsets of head h's q, k and v in a qkv row
struct Lanes {
  int q, k, v;
  __device__ Lanes(int layout, int heads, int h, int kd, int dv) {
    if (layout == 0) {
      q = h * (2 * kd + dv); k = q + kd; v = q + 2 * kd;
    } else {
      q = h * kd; k = heads * kd + h * kd; v = 2 * heads * kd + h * dv;
    }
  }
};

// ---------------------------------------------------------------- float32

template <int KD, int DV>
__global__ void __launch_bounds__(kWarps * 32)
window_attention_fwd_kernel(Params p) {
  constexpr int KS = KD + 4;  // padded K row stride in floats
  extern __shared__ float4 smem4[];
  const int N = p.window * p.window;
  float* k_s = reinterpret_cast<float*>(smem4);  // N * KS
  float* v_s = k_s + N * KS;                      // N * DV
  float* p_s = v_s + N * DV;                      // kWarps * N

  const float* qkv = static_cast<const float*>(p.qkv);
  const float* qb = static_cast<const float*>(p.qkv_bias);
  float* out = static_cast<float*>(p.out);
  const int h = blockIdx.x, win = blockIdx.y, b = blockIdx.z;
  const int nW = p.W / p.window;
  const int y0 = (win / nW) * p.window, x0 = (win % nW) * p.window;
  const int L = p.heads * (2 * KD + DV);
  const Lanes ln(p.layout, p.heads, h, KD, DV);
  // pixel index of window token t: the window is row-major inside the map
  auto pix = [&](int t) -> long long {
    return (static_cast<long long>(b) * p.H + y0 + t / p.window) * p.W + x0 + t % p.window;
  };

  for (int i = threadIdx.x; i < N * KD; i += blockDim.x) {
    const int t = i / KD, d = i % KD;
    float x = qkv[pix(t) * L + ln.k + d];
    if (qb) x += qb[ln.k + d];
    k_s[t * KS + d] = x;
  }
  for (int i = threadIdx.x; i < N * DV; i += blockDim.x) {
    const int t = i / DV, d = i % DV;
    float x = qkv[pix(t) * L + ln.v + d];
    if (qb) x += qb[ln.v + d];
    v_s[t * DV + d] = x;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* p_w = p_s + warp * N;
  const float* bias_h = p.bias + static_cast<size_t>(h) * N * N;
  const float* mask_w = p.mask ? p.mask + static_cast<size_t>(win) * N * N : nullptr;

  for (int n = warp; n < N; n += kWarps) {
    // the query row, held whole by every lane (a broadcast load)
    float q[KD];
    const float* qp = qkv + pix(n) * L + ln.q;
#pragma unroll
    for (int d = 0; d < KD; ++d) q[d] = qb ? qp[d] + qb[ln.q + d] : qp[d];

    float s[kKeysPerLane];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      const int m = lane + 32 * i;
      s[i] = -INFINITY;
      if (m < N) {
        const float4* kr = reinterpret_cast<const float4*>(k_s + m * KS);
        float acc = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < KD / 4; ++d4) {
          const float4 kk = kr[d4];
          acc = fmaf(q[4 * d4 + 0], kk.x, acc);
          acc = fmaf(q[4 * d4 + 1], kk.y, acc);
          acc = fmaf(q[4 * d4 + 2], kk.z, acc);
          acc = fmaf(q[4 * d4 + 3], kk.w, acc);
        }
        float sc = acc * p.scale + bias_h[n * N + m];
        if (mask_w) sc += mask_w[n * N + m];
        s[i] = sc;
        mx = fmaxf(mx, sc);
      }
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));

    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      const float e = (lane + 32 * i < N) ? expf(s[i] - mx) : 0.f;
      s[i] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);

#pragma unroll
    for (int i = 0; i < kKeysPerLane; ++i) {
      const int m = lane + 32 * i;
      if (m < N) p_w[m] = s[i] / sum;
    }
    __syncwarp();

    float* op = out + pix(n) * (p.heads * DV) + h * DV;
    for (int d = lane; d < DV; d += 32) {
      float acc = 0.f;
      for (int m = 0; m < N; ++m) acc = fmaf(p_w[m], v_s[m * DV + d], acc);
      op[d] = acc;
    }
    __syncwarp();  // p_w is rewritten by this warp's next row
  }
}

// ---------------------------------------------------------------- bfloat16

using bf16 = __nv_bfloat16;

// NKT: 16-key tiles a strip's scores hold in registers (N <= 16 * NKT)
template <int KD, int DV, int NKT>
__global__ void __launch_bounds__(kWarps * 32)
window_attention_fwd_mma_kernel(Params p) {
  constexpr int QS = KD + 8, VS = DV + 8;  // row strides (elements), 16-byte pad
  // windows of up to 16 * kWarps tokens give a warp one strip: its Q goes
  // from device memory straight to A fragments, loaded with K and V, and
  // shared memory holds K and V only
  constexpr bool kOneStrip = NKT <= kWarps;
  extern __shared__ uint4 smem16[];
  const int N = p.window * p.window;
  const int nkt = (N + 15) / 16, NP = 16 * nkt;
  const int nt = (N + 7) / 8;                    // 8-key n-tiles with a key
  bf16* k_s = reinterpret_cast<bf16*>(smem16);  // NP * QS
  bf16* v_s = k_s + NP * QS;                     // NP * VS
  bf16* q_s = v_s + NP * VS;                     // NP * QS, unless kOneStrip

  const bf16* qkv = static_cast<const bf16*>(p.qkv);
  const bf16* qb = static_cast<const bf16*>(p.qkv_bias);
  bf16* out = static_cast<bf16*>(p.out);
  const int h = blockIdx.x, win = blockIdx.y, b = blockIdx.z;
  const int nW = p.W / p.window;
  const int y0 = (win / nW) * p.window, x0 = (win % nW) * p.window;
  const int L = p.heads * (2 * KD + DV), HD = p.heads * DV;
  const Lanes ln(p.layout, p.heads, h, KD, DV);
  auto pix = [&](int t) -> long long {
    return (static_cast<long long>(b) * p.H + y0 + t / p.window) * p.W + x0 + t % p.window;
  };
  auto seg = [&](int off) {
    return [=](int t) { return qkv + pix(t) * L + off; };
  };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane >> 2, tig = lane & 3;
  uint32_t a[KD / 16][4];   // Q of the strip
  if constexpr (kOneStrip) {
    const int ra = 16 * warp + gid, rb = ra + 8;
    if (warp < nkt)
      tc::load_a_rows<KD>(a, ra < N ? qkv + pix(ra) * L + ln.q : nullptr,
                          rb < N ? qkv + pix(rb) * L + ln.q : nullptr,
                          qb ? qb + ln.q : nullptr, lane);
  }
  const auto ks = tc::segment(seg(ln.k), qb ? qb + ln.k : nullptr, k_s);
  const auto vs = tc::segment(seg(ln.v), qb ? qb + ln.v : nullptr, v_s);
  const auto qs = tc::segment(seg(ln.q), qb ? qb + ln.q : nullptr, q_s);
  // every load of the staging in flight at once where the widths allow
  constexpr int BK = tc::stage_batch(16 * NKT * KD / 8, kWarps * 32);
  constexpr int BV = tc::stage_batch(16 * NKT * DV / 8, kWarps * 32);
  if constexpr (kOneStrip && KD == DV) {
    tc::stage_rows<KD, BK>(QS, N, NP, ks, vs);
  } else if constexpr (kOneStrip) {
    tc::stage_rows<KD, BK>(QS, N, NP, ks);
    tc::stage_rows<DV, BV>(VS, N, NP, vs);
  } else if constexpr (KD == DV) {
    tc::stage_rows<KD, BK>(QS, N, NP, ks, qs, vs);
  } else {
    tc::stage_rows<KD, BK>(QS, N, NP, ks, qs);
    tc::stage_rows<DV, BV>(VS, N, NP, vs);
  }
  __syncthreads();

  const float* bias_h = p.bias + static_cast<size_t>(h) * N * N;
  const float* mask_w = p.mask ? p.mask + static_cast<size_t>(win) * N * N : nullptr;

  for (int mt = warp; mt < nkt; mt += kWarps) {
    const int r0 = 16 * mt;
    if constexpr (!kOneStrip) {
#pragma unroll
      for (int k = 0; k < KD / 16; ++k) tc::load_a(a[k], q_s + r0 * QS, QS, 16 * k, lane);
    }
    float s[2 * NKT][4];
#pragma unroll
    for (int t = 0; t < 2 * NKT; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
    tc::mma_abt<KD, 2 * NKT>(s, a, k_s, QS, nt, lane);

    // rows ra (c0, c1) and rb (c2, c3) of the strip; padded rows read row
    // N - 1 of the bias and are never stored
    const int ra = r0 + gid, rb = ra + 8;
    const size_t oa = static_cast<size_t>(min(ra, N - 1)) * N;
    const size_t ob = static_cast<size_t>(min(rb, N - 1)) * N;
    float mxa = -INFINITY, mxb = -INFINITY;
#pragma unroll
    for (int t = 0; t < 2 * NKT; ++t) {
      if (t < nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * t + 2 * tig + e;
          if (c < N) {
            float sa = __fadd_rn(__fmul_rn(s[t][e], p.scale), bias_h[oa + c]);
            float sb = __fadd_rn(__fmul_rn(s[t][2 + e], p.scale), bias_h[ob + c]);
            if (mask_w) {
              sa = __fadd_rn(sa, mask_w[oa + c]);
              sb = __fadd_rn(sb, mask_w[ob + c]);
            }
            s[t][e] = sa;
            s[t][2 + e] = sb;
            mxa = fmaxf(mxa, sa);
            mxb = fmaxf(mxb, sb);
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
#pragma unroll
    for (int t = 0; t < 2 * NKT; ++t) {
      if (t < nt) {
        s[t][0] = tc::div_rn(s[t][0], suma, ria);
        s[t][1] = tc::div_rn(s[t][1], suma, ria);
        s[t][2] = tc::div_rn(s[t][2], sumb, rib);
        s[t][3] = tc::div_rn(s[t][3], sumb, rib);
      }
    }

    // O = P.V: P (bf16) from the score registers, V through ldmatrix.trans;
    // the n-tiles past nt hold zeros
    float o[DV / 8][4];
#pragma unroll
    for (int t = 0; t < DV / 8; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < NKT; ++kt) {
      if (kt < nkt) {
        uint32_t pa[4];
        tc::c_to_a(s[2 * kt], s[2 * kt + 1], pa);
#pragma unroll
        for (int n2 = 0; n2 < DV / 16; ++n2) {
          uint32_t bv[4];
          tc::ldsm_x4_trans(bv, v_s + (16 * kt) * VS + 16 * n2, VS, lane);
          tc::mma_bf16(o[2 * n2], pa, bv[0], bv[1]);
          tc::mma_bf16(o[2 * n2 + 1], pa, bv[2], bv[3]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < DV / 8; ++t) {
      const int c = h * DV + 8 * t + 2 * tig;
      if (ra < N)
        *reinterpret_cast<uint32_t*>(out + pix(ra) * HD + c) = tc::pack_bf16(o[t][0], o[t][1]);
      if (rb < N)
        *reinterpret_cast<uint32_t*>(out + pix(rb) * HD + c) = tc::pack_bf16(o[t][2], o[t][3]);
    }
  }
}

template <typename Kern>
cudaError_t launch_kernel(Kern kern, const Params& p, int B, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(p.heads, (p.H / p.window) * (p.W / p.window), B);
  kern<<<grid, kWarps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int KD, int DV>
cudaError_t launch_fp32(const Params& p, int B, cudaStream_t stream) {
  const size_t N = p.window * p.window;
  const size_t smem = sizeof(float) * (N * (KD + 4) + N * DV + kWarps * N);
  return launch_kernel(window_attention_fwd_kernel<KD, DV>, p, B, smem, stream);
}

template <int KD, int DV>
cudaError_t launch_bf16(const Params& p, int B, cudaStream_t stream) {
  const int N = p.window * p.window;
  const size_t NP = (N + 15) / 16 * 16;
  const bool one_strip = NP <= 16 * kWarps;   // no Q in shared memory
  const size_t smem = sizeof(bf16) * NP * (KD + 8 + DV + 8 + (one_strip ? 0 : KD + 8));
  if (N <= 64) return launch_kernel(window_attention_fwd_mma_kernel<KD, DV, 4>, p, B, smem, stream);
  if (N <= 144) return launch_kernel(window_attention_fwd_mma_kernel<KD, DV, 9>, p, B, smem, stream);
  if (N <= 208) return launch_kernel(window_attention_fwd_mma_kernel<KD, DV, 13>, p, B, smem, stream);
  return launch_kernel(window_attention_fwd_mma_kernel<KD, DV, 16>, p, B, smem, stream);
}

template <int KD, int DV>
cudaError_t launch(int dtype, const Params& p, int B, cudaStream_t s) {
  switch (dtype) {
    case 0: return launch_fp32<KD, DV>(p, B, s);
    case 1: return launch_bf16<KD, DV>(p, B, s);
  }
  return cudaErrorInvalidValue;
}

template <int KD>
cudaError_t dispatch_dv(int dv, int dtype, const Params& p, int B, cudaStream_t s) {
  switch (dv) {
    case 16: return launch<KD, 16>(dtype, p, B, s);
    case 32: return launch<KD, 32>(dtype, p, B, s);
    case 64: return launch<KD, 64>(dtype, p, B, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 float32 (CUDA cores), 1 bfloat16 (tensor cores). The bf16
// kernel reads qkv and qkv_bias 16 bytes at a time: both must start on a
// 16-byte boundary. Returns a cudaError_t (0 on success).
extern "C" int cream_window_attention_fwd(
    const void* qkv, const void* bias, const void* mask, const void* qkv_bias,
    void* out, int B, int H, int W, int heads, int kd, int dv, int window,
    int layout, int dtype, float scale, void* stream) {
  if (window * window > kMaxTokens || H % window || W % window || layout < 0 || layout > 1)
    return cudaErrorInvalidValue;
  if (dtype == 1 && ((reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(qkv_bias)) & 15))
    return cudaErrorMisalignedAddress;
  const Params p{qkv, static_cast<const float*>(bias), static_cast<const float*>(mask),
                 qkv_bias, out, H, W, heads, window, layout, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kd) {
    case 16: return dispatch_dv<16>(dv, dtype, p, B, s);
    case 32: return dispatch_dv<32>(dv, dtype, p, B, s);
    case 64: return dispatch_dv<64>(dv, dtype, p, B, s);
  }
  return cudaErrorInvalidValue;
}
