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
// Bound: bytes. One read and one write of 4 bytes per element (8 MiB at
// the slice's 2^20 rows). The kernel runs on the resolve step's stream,
// so it is ordered with the K3 launches around it; `out` may alias `hv`
// (the resolver updates its history in place). int4 vector loads and
// stores when the length allows.

#include "common.cuh"

namespace {

__device__ __forceinline__ int32_t upkeep(int32_t v, int mode, int a, int b,
                                          int c) {
  switch (mode) {
    case 0: return max(v, fdb::VDEAD + a) - a;
    case 1: return fdb::VDEAD;
    case 2: return v == a ? b : max(v, fdb::VDEAD + c) - c;
    default: return v == a ? b : fdb::VDEAD;
  }
}

__global__ void window_kernel(const int32_t* hv, int32_t* out, int n,
                              int vec, int mode, int a, int b, int c) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (vec) {
    if (i >= n / 4) return;
    int4 x = reinterpret_cast<const int4*>(hv)[i];
    x.x = upkeep(x.x, mode, a, b, c);
    x.y = upkeep(x.y, mode, a, b, c);
    x.z = upkeep(x.z, mode, a, b, c);
    x.w = upkeep(x.w, mode, a, b, c);
    reinterpret_cast<int4*>(out)[i] = x;
  } else if (i < n) {
    out[i] = upkeep(hv[i], mode, a, b, c);
  }
}

}  // namespace

FDB_API int fdb_window_upkeep(const int32_t* hv, int32_t* out, int n,
                              int mode, int a, int b, int c, void* stream) {
  if (n < 0 || mode < 0 || mode > 3) return fdb::ERR_BAD_ARGS;
  if (n == 0) return 0;
  int vec = (n & 3) == 0 &&
            ((reinterpret_cast<uintptr_t>(hv) |
              reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  int work = vec ? n / 4 : n;
  window_kernel<<<fdb::blocks_for(work, 256), 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(hv, out, n, vec, mode,
                                                       a, b, c);
  return static_cast<int>(cudaGetLastError());
}
