// bf16 tensor-core pieces shared by the window-attention kernels
// (window_attention.cu, window_attention_bwd.cu) and the fused MBConv
// (mbconv.cu): mma.sync m16n8k16 with fp32 sums, and its fragment loads.
//
// Fragment layout of m16n8k16 (lane = 4 * gid + tig):
//   A (16x16, row-major): a0 = A[gid][2tig..+1], a1 = A[gid+8][2tig..+1],
//                         a2 = A[gid][2tig+8..+9], a3 = A[gid+8][2tig+8..+9]
//   B (16x8, k-major):    b0 = B[2tig..+1][gid], b1 = B[2tig+8..+9][gid]
//   C (16x8, fp32):       c0, c1 = C[gid][2tig..+1], c2, c3 = C[gid+8][2tig..+1]
// so the C fragments of two adjacent n-tiles, packed to bf16 pairs, are the A
// fragment of a 16-deep k-tile: {c(t)[0,1], c(t)[2,3], c(t+1)[0,1], c(t+1)[2,3]}.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace tc {

// d += a (16x16, row-major) . b (16x8, k-major): bf16 in, fp32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragment of a 16x16 tile of a row-major matrix in shared memory at
// `p` = &M[r0][k0], row stride `stride` elements (rows 16-byte aligned):
// the four 8x8 quarters in a0..a3 order, as load_a gives them
__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], const __nv_bfloat16* p, int stride,
                                        int lane) {
  const __nv_bfloat16* row = p + ((lane & 7) + ((lane >> 3) & 1) * 8) * stride + (lane >> 4) * 8;
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// The B fragments of two adjacent n-tiles from a row-major (k, n) matrix in
// shared memory: rows k0..k0+15, columns n0..n0+15 at `p` = &M[k0][n0], row
// stride `stride` elements (rows 16-byte aligned). b[0], b[1] are n-tile n0,
// b[2], b[3] n-tile n0 + 8.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&b)[4], const __nv_bfloat16* p,
                                              int stride, int lane) {
  const __nv_bfloat16* row = p + ((lane & 7) + ((lane >> 3) & 1) * 8) * stride + (lane >> 4) * 8;
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(addr));
}

// (lo, hi) rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x = hi + lo to ~16 significant bits: hi = bf16(x), lo = bf16(x - hi),
// each pair packed as pack_bf16 does
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The A fragment of k-tile t from the C fragments c[2t], c[2t+1] of a 16-row
// strip (see the layout note above)
__device__ __forceinline__ void c_to_a(const float (&c0)[4], const float (&c1)[4],
                                       uint32_t (&a)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// The same, split into hi and lo fragments
__device__ __forceinline__ void c_to_a_split(const float (&c0)[4], const float (&c1)[4],
                                             uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_bf16(c0[0], c0[1], hi[0], lo[0]);
  split_bf16(c0[2], c0[3], hi[1], lo[1]);
  split_bf16(c1[0], c1[1], hi[2], lo[2]);
  split_bf16(c1[2], c1[3], hi[3], lo[3]);
}

// An 8x8 bf16 matrix held as A fragments hold theirs (lane 4r + c: row r,
// columns 2c, 2c + 1), transposed across the warp
__device__ __forceinline__ uint32_t movmatrix_t(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// The A fragment of the transpose of the 16x16 tile whose A fragment is
// `a`: each 8x8 quarter transposed, the off-diagonal two swapped
__device__ __forceinline__ void transpose_a(const uint32_t (&a)[4], uint32_t (&t)[4]) {
  t[0] = movmatrix_t(a[0]);
  t[1] = movmatrix_t(a[2]);
  t[2] = movmatrix_t(a[1]);
  t[3] = movmatrix_t(a[3]);
}

// The A fragment of a 16-row strip at `p` (row-major, row stride `stride`),
// k-tile starting at column k0
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* p, int stride,
                                       int k0, int lane) {
  const __nv_bfloat16* r = p + (lane >> 2) * stride + k0 + 2 * (lane & 3);
  a[0] = ld32(r);
  a[1] = ld32(r + 8 * stride);
  a[2] = ld32(r + 8);
  a[3] = ld32(r + 8 * stride + 8);
}

// acc[t] += A . B^T for the A fragments `a` (K / 16 k-tiles of a 16-row
// strip) and the rows 8t .. 8t+7 of B at `b` (row-major, K columns, row
// stride `stride`), for the n-tiles t < nt (NT of them at most)
template <int K, int NT>
__device__ __forceinline__ void mma_abt(float (&acc)[NT][4], const uint32_t (&a)[K / 16][4],
                                        const __nv_bfloat16* b, int stride, int nt, int lane) {
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (t < nt) {
      const __nv_bfloat16* br = b + (8 * t + (lane >> 2)) * stride + 2 * (lane & 3);
#pragma unroll
      for (int k = 0; k < K / 16; ++k) mma_bf16(acc[t], a[k], ld32(br + 16 * k), ld32(br + 16 * k + 8));
    }
  }
}

// One D-wide bf16 segment of the window's token rows, for stage_rows: row
// t < n is `row(t)` (16-byte aligned), `qb` its qkv bias (D values) or null,
// `dst` its place in shared memory (row stride DS elements, 16-byte rows).
template <typename Row>
struct Segment {
  Row row;
  const __nv_bfloat16* qb;
  __nv_bfloat16* dst;
};

template <typename Row>
__device__ __forceinline__ Segment<Row> segment(const Row& row, const __nv_bfloat16* qb,
                                                __nv_bfloat16* dst) {
  return {row, qb, dst};
}

// A thread's loads of one batch of a segment: rows (i0 + j * blockDim.x) /
// (D / 8), j < BATCH, chunk c; zero past row n
template <int D, int BATCH, typename Row>
__device__ __forceinline__ void stage_load(uint4 (&v)[BATCH], const Segment<Row>& sg, int i0,
                                           int n, int c) {
#pragma unroll
  for (int j = 0; j < BATCH; ++j) {
    const int t = (i0 + j * blockDim.x) / (D / 8);
    v[j] = make_uint4(0u, 0u, 0u, 0u);
    if (t < n) v[j] = *reinterpret_cast<const uint4*>(sg.row(t) + c);
  }
}

// ... and their stores, rows below `rows`, with the qkv bias folded in
template <int D, int BATCH, typename Row>
__device__ __forceinline__ void stage_store(uint4 (&v)[BATCH], const Segment<Row>& sg, int i0,
                                            int n, int rows, int c, int DS) {
  uint4 bias = make_uint4(0u, 0u, 0u, 0u);
  if (sg.qb) bias = *reinterpret_cast<const uint4*>(sg.qb + c);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&bias);
#pragma unroll
  for (int j = 0; j < BATCH; ++j) {
    const int t = (i0 + j * blockDim.x) / (D / 8);
    if (t < rows) {
      if (sg.qb && t < n) {
        __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&v[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 xf = __bfloat1622float2(x[e]), yf = __bfloat1622float2(y[e]);
          x[e] = __floats2bfloat162_rn(xf.x + yf.x, xf.y + yf.y);
        }
      }
      *reinterpret_cast<uint4*>(sg.dst + t * DS + c) = v[j];
    }
  }
}

template <int D, int BATCH, typename... Rows, size_t... I>
__device__ __forceinline__ void stage_rows_impl(std::index_sequence<I...>, int DS, int n,
                                                int rows, const Segment<Rows>&... segs) {
  const int c = (threadIdx.x % (D / 8)) * 8;
  for (int i0 = threadIdx.x; i0 < rows * (D / 8); i0 += BATCH * blockDim.x) {
    uint4 v[sizeof...(Rows)][BATCH];
    (stage_load<D, BATCH>(v[I], segs, i0, n, c), ...);
    (stage_store<D, BATCH>(v[I], segs, i0, n, rows, c, DS), ...);
  }
}

// Loads a thread keeps in flight per segment: enough for `chunks` 16-byte
// chunks over `threads` threads in one batch, at most 8
__host__ __device__ constexpr int stage_batch(int chunks, int threads) {
  return (chunks + threads - 1) / threads < 8 ? (chunks + threads - 1) / threads : 8;
}

// Rows t < rows of segments of width D into shared memory, 16 bytes a
// thread: the token row plus its qkv bias added in fp32 and rounded back to
// bf16, as the bf16 add of the plain version rounds it; rows n <= t < rows
// are zero. A thread issues BATCH loads of every segment before it uses any,
// so their latencies overlap: with BATCH * blockDim.x >= rows * D / 8, all
// the loads of the segments are in flight together. blockDim.x must be a
// multiple of D / 8 (a thread then keeps one chunk of every row).
template <int D, int BATCH, typename... Rows>
__device__ __forceinline__ void stage_rows(int DS, int n, int rows, const Segment<Rows>&... segs) {
  stage_rows_impl<D, BATCH>(std::index_sequence_for<Rows...>{}, DS, n, rows, segs...);
}

// A bf16 pair at `p` (4-byte aligned; null: zeros) plus the qkv bias pair at
// `qb` (or null), added in fp32 and rounded back to bf16 as stage_rows does
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p, const __nv_bfloat16* qb) {
  if (!p) return 0u;
  uint32_t v = ld32(p);
  if (qb) {
    const uint32_t b = ld32(qb);
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&b));
    v = pack_bf16(x.x + y.x, x.y + y.y);
  }
  return v;
}

// The A fragments (K / 16 k-tiles) of a 16-row strip straight from global
// memory: `ra` and `rb` point at the strip's rows gid and gid + 8 (null past
// the window), `qb` at the bias of their first column (or null)
template <int K>
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[K / 16][4], const __nv_bfloat16* ra,
                                            const __nv_bfloat16* rb, const __nv_bfloat16* qb,
                                            int lane) {
  const int c = 2 * (lane & 3);
#pragma unroll
  for (int k = 0; k < K / 16; ++k) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = 16 * k + 8 * h + c;
      const __nv_bfloat16* bq = qb ? qb + col : nullptr;
      a[k][2 * h] = load_pair(ra ? ra + col : nullptr, bq);
      a[k][2 * h + 1] = load_pair(rb ? rb + col : nullptr, bq);
    }
  }
}

// (x[c], x[c + 1]) of an fp32 row of n values, the second 0 past the row:
// one 8-byte load where `even` (n even, x 8-byte aligned and c even)
__device__ __forceinline__ float2 row_pair(const float* x, int c, int n, bool even) {
  if (even) return *reinterpret_cast<const float2*>(x + c);
  return make_float2(x[c], c + 1 < n ? x[c + 1] : 0.f);
}

// a / b rounded to nearest even, as IEEE division rounds it, from rb =
// 1 / b (itself correctly rounded): q = a * rb is within an ulp of a / b,
// and one correction with the exact residual a - q * b (an FMA) rounds it
// correctly (Markstein). Three operations where `/` takes a reciprocal, a
// Newton step and a range check. For 0 <= a <= 1 <= b, as P = e / sum is;
// results below 2^-126 (e that small) may be off by an ulp.
__device__ __forceinline__ float div_rn(float a, float b, float rb) {
  const float q = __fmul_rn(a, rb);
  return __fmaf_rn(__fmaf_rn(-q, b, a), rb, q);
}

// max and sum over the four lanes of a quad (the lanes that share C rows)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace tc
