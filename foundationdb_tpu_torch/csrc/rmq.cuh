// K2's two halves as device functions: range_max.cu's two kernels run
// them, and K8e (shard_step.cu) runs both inside its one launch.
#pragma once

#include "common.cuh"

namespace fdb {
namespace {

constexpr int RMQ_SUPER = 64;      // blocks of 128 values a super-block
constexpr int RMQ_SHORT = 8;       // values a thread scans by itself

// the summary of super-block sb of one array v [nb * 128] by one block
// of WARPS warps (coalesced loads, one __reduce_max a block): every
// block's max into bmax [nb], the super-block's into smax[sb]. Every
// thread of the block must call it.
template <int WARPS>
__device__ void rmq_summarize(const int32_t* v, int nb, int sb,
                              int32_t* bmax, int32_t* smax) {
  __shared__ int32_t wmax[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int PER = RMQ_SUPER / WARPS;
  int32_t x[PER][4];
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int blk = sb * RMQ_SUPER + t * WARPS + warp;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      x[t][j] = blk < nb ? v[(size_t)blk * RMQ_BLOCK + j * 32 + lane]
                         : VDEAD;
  }
  int32_t m = VDEAD;
#pragma unroll
  for (int t = 0; t < PER; ++t) {
    const int blk = sb * RMQ_SUPER + t * WARPS + warp;
    int32_t b = __reduce_max_sync(FULL_MASK, max(max(x[t][0], x[t][1]),
                                                 max(x[t][2], x[t][3])));
    if (lane == 0 && blk < nb) bmax[blk] = b;
    m = max(m, b);
  }
  if (lane == 0) wmax[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 1; w < WARPS; ++w) m = max(m, wmax[w]);
    smax[sb] = m;
  }
}

// the max of v[a..b] (inclusive, a <= b, both in range) by the whole
// warp, every lane calling with the same range; each lane gets it. bm
// and sm are v's summary.
__device__ int32_t warp_range_max(const int32_t* v, const int32_t* bm,
                                  const int32_t* sm, int a, int b,
                                  int lane) {
  int32_t m = VDEAD;
  const int ab = a / RMQ_BLOCK, bb = b / RMQ_BLOCK;
  if (ab == bb) {
    for (int j = a + lane; j <= b; j += 32) m = max(m, v[j]);
  } else {
    for (int j = a + lane; j < (ab + 1) * RMQ_BLOCK; j += 32)
      m = max(m, v[j]);
    for (int j = bb * RMQ_BLOCK + lane; j <= b; j += 32) m = max(m, v[j]);
    const int x = ab + 1, y = bb - 1;  // the whole blocks between
    const int sx = x / RMQ_SUPER, sy = y / RMQ_SUPER;
    if (x <= y && sy - sx <= 1) {
      for (int j = x + lane; j <= y; j += 32) m = max(m, bm[j]);
    } else if (x <= y) {
      for (int j = x + lane; j < (sx + 1) * RMQ_SUPER; j += 32)
        m = max(m, bm[j]);
      for (int j = sy * RMQ_SUPER + lane; j <= y; j += 32) m = max(m, bm[j]);
      for (int j = sx + 1 + lane; j < sy; j += 32) m = max(m, sm[j]);
    }
  }
  return __reduce_max_sync(FULL_MASK, m);
}

}  // namespace
}  // namespace fdb
