// Window partition and reverse of an NHWC map, as block copies.
//
// Replaces: cream_tpu/ops/pallas/window_relayout.py `_part_kernel` and
// `_rev_kernel` (reached through `window_partition_pallas` and
// `window_reverse_pallas`), which move whole (window x window) tiles between
// a (B, H, W, C) map and the (B*nH*nW, window*window, C) window stack.
//
// What it computes: partition
//   out[(b*nH + i)*nW + j][ty*ws + tx][c] = x[b][i*ws + ty][j*ws + tx][c]
// and reverse, its inverse, for H and W multiples of the window (the wrappers
// refuse ragged maps). Values are moved, never changed.
//
// What bounds it on Hopper: bytes only, each element read once and written
// once (at (256, 28, 28, 192) bf16, 77 MB each way: 46 us at 3.35 TB/s). The
// TPU kernels existed to pin XLA's layouts; here the point is a copy at HBM
// rate. Its design: one thread per vector of V bytes (16 when a pixel's C
// channels and both pointers allow, else 8, 4 or 2) of the output, its source
// computed from the window geometry, so each warp writes contiguous bytes and
// reads runs of a pixel's channels; a grid-stride loop covers any size.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Geometry {
  int H, W, ws, nH, nW, rowv;  // rowv: vectors per pixel (C * itemsize / V)
};

// index of the map pixel that window pixel (win, t) holds
__device__ __forceinline__ long long map_pixel(const Geometry& g, long long win, int t) {
  const long long per_img = static_cast<long long>(g.nH) * g.nW;
  const long long b = win / per_img;
  const int rem = static_cast<int>(win - b * per_img);
  const int i = rem / g.nW, j = rem % g.nW;
  return (b * g.H + i * g.ws + t / g.ws) * g.W + j * g.ws + t % g.ws;
}

template <typename V>
__global__ void partition_kernel(const V* __restrict__ x, V* __restrict__ out, Geometry g,
                                 long long total) {
  const int N = g.ws * g.ws;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long o_pix = idx / g.rowv;
    const int v = static_cast<int>(idx - o_pix * g.rowv);
    const long long win = o_pix / N;
    const int t = static_cast<int>(o_pix - win * N);
    out[idx] = x[map_pixel(g, win, t) * g.rowv + v];
  }
}

template <typename V>
__global__ void reverse_kernel(const V* __restrict__ windows, V* __restrict__ out, Geometry g,
                               long long total) {
  const int N = g.ws * g.ws;
  for (long long idx = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       idx < total; idx += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long pix = idx / g.rowv;
    const int v = static_cast<int>(idx - pix * g.rowv);
    const long long row = pix / g.W;             // b * H + y
    const int xx = static_cast<int>(pix - row * g.W);
    const long long b = row / g.H;
    const int y = static_cast<int>(row - b * g.H);
    const long long win = (b * g.nH + y / g.ws) * g.nW + xx / g.ws;
    const int t = (y % g.ws) * g.ws + xx % g.ws;
    out[idx] = windows[(win * N + t) * g.rowv + v];
  }
}

template <typename V>
cudaError_t launch(bool reverse, const void* src, void* dst, Geometry g, long long total,
                   cudaStream_t stream) {
  constexpr int kThreads = 256;
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 64 ? want : 132 * 64);
  if (reverse)
    reverse_kernel<V><<<blocks, kThreads, 0, stream>>>(static_cast<const V*>(src),
                                                       static_cast<V*>(dst), g, total);
  else
    partition_kernel<V><<<blocks, kThreads, 0, stream>>>(static_cast<const V*>(src),
                                                         static_cast<V*>(dst), g, total);
  return cudaGetLastError();
}

}  // namespace

// Partition (reverse = 0) of a (B, H, W, C) map into (B*nH*nW, ws*ws, C)
// windows, or reverse (reverse = 1). row_bytes = C * itemsize; vec_bytes in
// {2, 4, 8, 16} divides it and both pointers' alignment. Returns a
// cudaError_t (0 on success).
extern "C" int cream_window_relayout(const void* src, void* dst, int reverse, int B, int H,
                                     int W, int ws, int row_bytes, int vec_bytes,
                                     void* stream) {
  if (B < 1 || ws < 1 || H < ws || W < ws || H % ws || W % ws || row_bytes < 1 ||
      vec_bytes < 2 || row_bytes % vec_bytes ||
      (reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) % vec_bytes)
    return cudaErrorInvalidValue;
  const Geometry g{H, W, ws, H / ws, W / ws, row_bytes / vec_bytes};
  const long long total = static_cast<long long>(B) * H * W * g.rowv;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_bytes) {
    case 16: return launch<uint4>(reverse, src, dst, g, total, s);
    case 8: return launch<uint2>(reverse, src, dst, g, total, s);
    case 4: return launch<uint32_t>(reverse, src, dst, g, total, s);
    case 2: return launch<uint16_t>(reverse, src, dst, g, total, s);
  }
  return cudaErrorInvalidValue;
}
