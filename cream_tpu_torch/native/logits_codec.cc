// Native codec for the sparse teacher-logits store (cream_tpu_torch/distill),
// the port's own copy of the JAX package's native/logits_codec.cc.
//
// The reference offloads logits packing to an async writer *process*
// (TinyViT/data/augmentation/manager.py:6-63). Here the pack/unpack hot path
// (fp32 -> fp16 conversion + record interleave + pwrite/pread at
// dataset-index offsets) is C++ with OpenMP-free std::thread sharding, called
// from Python via ctypes. Record layout must match
// cream_tpu_torch/distill/logits_store.py (and the JAX package's store, byte
// for byte): seed:int32 | K fp16 values | K int16 ids.
//
// Built at first use by cream_tpu_torch/distill/native.py into build/:
//   g++ -O3 -std=c++17 -fPIC -shared -o <library> logits_codec.cc -lpthread

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <functional>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

// scalar fp32 -> fp16 (round-to-nearest-even), no hardware dependence
inline uint16_t f32_to_f16(float f) {
  uint32_t x;
  std::memcpy(&x, &f, 4);
  uint32_t sign = (x >> 16) & 0x8000u;
  int32_t exp = static_cast<int32_t>((x >> 23) & 0xFF) - 127 + 15;
  uint32_t mant = x & 0x7FFFFFu;
  if (exp <= 0) {  // subnormal / underflow
    if (exp < -10) return static_cast<uint16_t>(sign);
    mant |= 0x800000u;
    uint32_t shift = static_cast<uint32_t>(14 - exp);
    uint32_t half = mant >> shift;
    uint32_t rem = mant & ((1u << shift) - 1);
    if (rem > (1u << (shift - 1)) ||
        (rem == (1u << (shift - 1)) && (half & 1u)))
      half++;
    return static_cast<uint16_t>(sign | half);
  }
  if (exp >= 31) {  // inf/NaN — preserve NaN (quiet) like the numpy fallback
    uint32_t nan_bit = (((x >> 23) & 0xFF) == 0xFF && mant) ? 0x200u : 0u;
    return static_cast<uint16_t>(sign | 0x7C00u | nan_bit);
  }
  uint32_t half = sign | (static_cast<uint32_t>(exp) << 10) | (mant >> 13);
  uint32_t rem = mant & 0x1FFFu;
  if (rem > 0x1000u || (rem == 0x1000u && (half & 1u))) half++;
  return static_cast<uint16_t>(half);
}

inline float f16_to_f32(uint16_t h) {
  uint32_t sign = (static_cast<uint32_t>(h) & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1Fu;
  uint32_t mant = h & 0x3FFu;
  uint32_t x;
  if (exp == 0) {
    if (mant == 0) {
      x = sign;
    } else {  // subnormal
      exp = 127 - 15 + 1;
      while ((mant & 0x400u) == 0) {
        mant <<= 1;
        exp--;
      }
      mant &= 0x3FFu;
      x = sign | (exp << 23) | (mant << 13);
    }
  } else if (exp == 31) {
    x = sign | 0x7F800000u | (mant << 13);
  } else {
    x = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float f;
  std::memcpy(&f, &x, 4);
  return f;
}

void pack_range(const float* values, const int32_t* indices,
                const int32_t* seeds, int K, int rec_size, int64_t b0,
                int64_t b1, uint8_t* out) {
  for (int64_t b = b0; b < b1; ++b) {
    uint8_t* rec = out + b * rec_size;
    std::memcpy(rec, seeds + b, 4);
    uint16_t* vals = reinterpret_cast<uint16_t*>(rec + 4);
    int16_t* ids = reinterpret_cast<int16_t*>(rec + 4 + 2 * K);
    const float* vrow = values + b * K;
    const int32_t* irow = indices + b * K;
    for (int k = 0; k < K; ++k) {
      vals[k] = f32_to_f16(vrow[k]);
      ids[k] = static_cast<int16_t>(irow[k]);
    }
  }
}

void run_sharded(int64_t n, int n_threads,
                 const std::function<void(int64_t, int64_t)>& fn) {
  n_threads = std::max(1, std::min<int>(n_threads, 16));
  if (n < 1024 || n_threads == 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t b0 = t * chunk, b1 = std::min<int64_t>(n, b0 + chunk);
    if (b0 >= b1) break;
    ts.emplace_back(fn, b0, b1);
  }
  for (auto& t : ts) t.join();
}

}  // namespace

extern "C" {

// Pack B records and pwrite each at sample_index*rec_size in fd.
// Returns 0 on success, -1 on IO error.
int logits_pack_write(int fd, const float* values, const int32_t* indices,
                      const int32_t* seeds, const int64_t* sample_idx,
                      int64_t B, int K, int n_threads) {
  const int rec_size = 4 + 4 * K;
  std::vector<uint8_t> buf(static_cast<size_t>(B) * rec_size);
  run_sharded(B, n_threads, [&](int64_t b0, int64_t b1) {
    pack_range(values, indices, seeds, K, rec_size, b0, b1, buf.data());
  });
  int err = 0;
  for (int64_t b = 0; b < B; ++b) {
    off_t off = static_cast<off_t>(sample_idx[b]) * rec_size;
    if (pwrite(fd, buf.data() + b * rec_size, rec_size, off) != rec_size)
      err = -1;
  }
  return err;
}

// pread + unpack B records (by sample index) into fp32/int32/int32 outputs.
int logits_read_unpack(int fd, const int64_t* sample_idx, int64_t B, int K,
                       float* values, int32_t* indices, int32_t* seeds,
                       int n_threads) {
  const int rec_size = 4 + 4 * K;
  std::vector<uint8_t> buf(static_cast<size_t>(B) * rec_size);
  int err = 0;
  for (int64_t b = 0; b < B; ++b) {
    off_t off = static_cast<off_t>(sample_idx[b]) * rec_size;
    if (pread(fd, buf.data() + b * rec_size, rec_size, off) != rec_size)
      err = -1;
  }
  run_sharded(B, n_threads, [&](int64_t b0, int64_t b1) {
    for (int64_t b = b0; b < b1; ++b) {
      const uint8_t* rec = buf.data() + b * rec_size;
      std::memcpy(seeds + b, rec, 4);
      const uint16_t* vals = reinterpret_cast<const uint16_t*>(rec + 4);
      const int16_t* ids = reinterpret_cast<const int16_t*>(rec + 4 + 2 * K);
      for (int k = 0; k < K; ++k) {
        values[b * K + k] = f16_to_f32(vals[k]);
        indices[b * K + k] = ids[k];
      }
    }
  });
  return err;
}

}  // extern "C"
