// Shared definitions of the port's hand-written kernels.
//
// Everything is integer: keys are rows of `width` uint32 words (W
// big-endian words plus a length word, ops/keys.py), compared
// lexicographically; versions are int32 offsets. No floats and no
// order-dependent atomics, so every kernel is bit-exact against its
// plain PyTorch version.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#define FDB_API extern "C" __attribute__((visibility("default")))

namespace fdb {

constexpr int32_t VDEAD = -(1 << 30);          // ops/rmq.py VDEAD
constexpr int32_t SNAP_CLAMP = (1 << 30) + 1;  // ops/conflict_kernel.py
constexpr uint32_t INF_WORD = 0xFFFFFFFFu;
constexpr int RMQ_BLOCK = 128;                 // ops/rmq.py BLOCK
constexpr int ERR_BAD_ARGS = 10001;            // reported by fdb_error_string
constexpr int ERR_SCRATCH = 10002;

__device__ __forceinline__ int row_cmp(const uint32_t* a, const uint32_t* b,
                                       int width) {
  for (int w = 0; w < width; ++w) {
    uint32_t x = a[w], y = b[w];
    if (x != y) return x < y ? -1 : 1;
  }
  return 0;
}

__device__ __forceinline__ bool row_is_inf(const uint32_t* a, int width) {
  for (int w = 0; w < width; ++w)
    if (a[w] != INF_WORD) return false;
  return true;
}

// count of rows < q (upper=false) or <= q (upper=true) in a sorted table
__device__ __forceinline__ int row_bound(const uint32_t* tab, int n,
                                         const uint32_t* q, int width,
                                         bool upper) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    int c = row_cmp(tab + (size_t)mid * width, q, width);
    if (upper ? c <= 0 : c < 0) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// a flag array is bool (1 byte) in the unpacked feed and uint32 in the
// packed feed; nonzero is true in both
__device__ __forceinline__ bool flag_at(const void* p, int i, int bytes) {
  return bytes == 4 ? static_cast<const uint32_t*>(p)[i] != 0u
                    : static_cast<const uint8_t*>(p)[i] != 0;
}

inline int blocks_for(long long n, int threads) {
  return static_cast<int>((n + threads - 1) / threads);
}

inline size_t align_up(size_t x) { return (x + 255) & ~size_t(255); }

// bump allocator over one caller-provided scratch buffer
struct Carver {
  char* base;
  size_t off;
  template <typename T>
  T* take(size_t n) {
    T* p = reinterpret_cast<T*>(base ? base + off : nullptr);
    off = align_up(off + n * sizeof(T));
    return p;
  }
};

}  // namespace fdb

// launchers shared between translation units (K3 launches K1 and K2)
cudaError_t fdb_searchsorted_launch(const int32_t* table, int n,
                                    const int32_t* queries, int q, int right,
                                    int32_t* out, cudaStream_t stream);
size_t fdb_range_max_scratch(int n);
cudaError_t fdb_range_max_launch(const int32_t* vals, int n,
                                 const int32_t* lo, const int32_t* hi, int q,
                                 int32_t* out, void* scratch,
                                 cudaStream_t stream);
