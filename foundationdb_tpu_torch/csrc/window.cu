// K4: upkeep of the int32 version window stored in the history's HV.
//
// Replaces foundationdb_tpu/ops/conflict_kernel.py:628 make_rebase_fn,
// :636 make_reset_fn, :645 make_jump_fixup_fn and :657
// make_jump_fixup_large_fn, one mode each:
//   0 rebase       out = max(hv, VDEAD + a) - a            (a = delta)
//   1 reset        out = VDEAD
//   2 jump fixup   out = hv == a ? b : max(hv, VDEAD + c) - c
//   3 large jump   out = hv == a ? b : VDEAD
// (a = placeholder, b = commit offset, c = delta for modes 2 and 3).
//
// Bound: bytes. Modes 0, 2 and 3 read and write 4 bytes an element (8
// MiB at the interval cell's 2^20 rows); RESET writes 4 and reads
// nothing. The mode is a template parameter, so an element costs its
// mode's few instructions and RESET is pure stores. The grid holds as
// many blocks as fit on the card at once, each thread moving UNROLL
// int4s a round (all loads of a round before its stores), so the whole
// array is in flight in one or two rounds. The kernel runs on the
// resolve step's stream, ordered with the steps around it; `out` may
// alias `hv` (the resolver updates its history in place): an element is
// read and written by the same thread. int4 accesses when both pointers
// are 16-byte aligned, the last n % 4 elements one at a time.

#include "common.cuh"

namespace {

constexpr int WIN_THREADS = 256;
constexpr int UNROLL = 4;

template <int kMode>
__device__ __forceinline__ int32_t upkeep(int32_t v, int a, int b, int c) {
  if constexpr (kMode == 0) return max(v, fdb::VDEAD + a) - a;
  if constexpr (kMode == 1) return fdb::VDEAD;
  if constexpr (kMode == 2) return v == a ? b : max(v, fdb::VDEAD + c) - c;
  return v == a ? b : fdb::VDEAD;
}

template <int kMode>
__device__ __forceinline__ int4 upkeep4(int4 x, int a, int b, int c) {
  return make_int4(upkeep<kMode>(x.x, a, b, c), upkeep<kMode>(x.y, a, b, c),
                   upkeep<kMode>(x.z, a, b, c), upkeep<kMode>(x.w, a, b, c));
}

// n4 int4s from hv4 to out4, then the scalar elements [scalar0, n)
template <int kMode>
__global__ void __launch_bounds__(WIN_THREADS)
    window_kernel(const int32_t* hv, int32_t* out, long long n4,
                  long long scalar0, long long n, int a, int b, int c) {
  const int4* hv4 = reinterpret_cast<const int4*>(hv);
  int4* out4 = reinterpret_cast<int4*>(out);
  const long long stride = (long long)gridDim.x * WIN_THREADS * UNROLL;
  for (long long base = (long long)blockIdx.x * WIN_THREADS * UNROLL +
                        threadIdx.x;
       base < n4; base += stride) {
    int4 x[UNROLL] = {};
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + (long long)u * WIN_THREADS;
      if (kMode != 1 && i < n4) x[u] = hv4[i];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = base + (long long)u * WIN_THREADS;
      if (i < n4) out4[i] = upkeep4<kMode>(x[u], a, b, c);
    }
  }
  const long long t = (long long)blockIdx.x * WIN_THREADS + threadIdx.x;
  for (long long i = scalar0 + t; i < n;
       i += (long long)gridDim.x * WIN_THREADS)
    out[i] = upkeep<kMode>(kMode == 1 ? 0 : hv[i], a, b, c);
}

template <int kMode>
void launch(const int32_t* hv, int32_t* out, long long n, bool vec, int a,
            int b, int c, cudaStream_t st) {
  const long long n4 = vec ? n / 4 : 0;
  const long long scalar0 = 4 * n4;
  const long long work = n4 > 0 ? (n4 + UNROLL - 1) / UNROLL : n - scalar0;
  const int grid = fdb::coop_grid<window_kernel<kMode>, WIN_THREADS>(
      fdb::blocks_for(work, WIN_THREADS));
  window_kernel<kMode><<<grid, WIN_THREADS, 0, st>>>(hv, out, n4, scalar0,
                                                      n, a, b, c);
}

}  // namespace

FDB_API int fdb_window_upkeep(const int32_t* hv, int32_t* out, int n,
                              int mode, int a, int b, int c, void* stream) {
  if (n < 0 || mode < 0 || mode > 3) return fdb::ERR_BAD_ARGS;
  if (n == 0) return 0;
  const bool vec = ((reinterpret_cast<uintptr_t>(hv) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: launch<0>(hv, out, n, vec, a, b, c, st); break;
    case 1: launch<1>(hv, out, n, vec, a, b, c, st); break;
    case 2: launch<2>(hv, out, n, vec, a, b, c, st); break;
    default: launch<3>(hv, out, n, vec, a, b, c, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}
