// Identity copy of a tensor into a new row-major buffer.
//
// Replaces: cream_tpu/ops/pallas/layout_pin.py `_copy_kernel` (reached
// through `layout_pin` -> `_pin`), which TinyViT calls after each
// PatchMerging when `pin_layouts` is on.
//
// What it computes: out[i] = x[i] for every byte of a contiguous tensor. On
// the TPU the copy existed to force XLA's row-major layout on the stage
// tensors; PyTorch's NHWC stage tensors are already row-major, so here it is
// only the copy, kept as the route's measured cost.
//
// What bounds it on Hopper: bytes only, each read once and written once
// (TinyViT-21M bs256's three stage tensors, 77 + 39 + 14 MB in bf16: 78 us at
// 3.35 TB/s for all three). Its design: one thread per 16-byte vector (8, 4, 2
// or 1 byte where size or alignment demands) in a grid-stride loop, so every
// warp reads and writes 512 contiguous bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename V>
__global__ void copy_kernel(const V* __restrict__ x, V* __restrict__ out, long long n) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x)
    out[i] = x[i];
}

template <typename V>
cudaError_t launch(const void* x, void* out, long long nbytes, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const long long n = nbytes / static_cast<long long>(sizeof(V));
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 64 ? want : 132 * 64);
  copy_kernel<V><<<blocks, kThreads, 0, stream>>>(static_cast<const V*>(x),
                                                  static_cast<V*>(out), n);
  return cudaGetLastError();
}

}  // namespace

// Copies nbytes from x to out (distinct buffers). Returns a cudaError_t (0 on
// success).
extern "C" int cream_layout_pin(const void* x, void* out, long long nbytes, void* stream) {
  if (nbytes < 1) return cudaErrorInvalidValue;
  const uintptr_t a = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
                      static_cast<uintptr_t>(nbytes);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a % 16 == 0) return launch<uint4>(x, out, nbytes, s);
  if (a % 8 == 0) return launch<uint2>(x, out, nbytes, s);
  if (a % 4 == 0) return launch<uint32_t>(x, out, nbytes, s);
  if (a % 2 == 0) return launch<uint16_t>(x, out, nbytes, s);
  return launch<uint8_t>(x, out, nbytes, s);
}
