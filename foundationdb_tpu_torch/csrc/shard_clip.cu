// K7: the lexicographic row compare and the shard clip built on it.
//
// Replaces foundationdb_tpu/ops/keys.py:101 lt_rows and :114 le_rows,
// and the clip the sharded resolver builds from them
// (foundationdb_tpu/parallel/sharded_resolver.py:49-65: rows_max of the
// begins against the shard's lower bound, rows_min of the ends against
// its upper bound, and valid & lt_rows(begin', end')).
//
// On the main path K7 runs fused: the sharded step (K8, resolve.cu)
// clips each read to its shard in registers inside the external check's
// bounds search (ext_bounds_kernel<true>), and each surviving write in
// its partition, both through common.cuh clip_range; no clipped row is
// written there, and the step's K7 count (launches[2], keys.launches
// ["shard_clip"]) counts that fused kernel, once a sharded batch. This
// file keeps the standalone entries (keys.lt_rows, keys.clip_to_shards),
// which write the clipped rows out, through the same clip_range.
//
// Bound: bytes. lt_rows reads both row sets once and writes one byte
// per row. The clip reads N begin rows, N end rows and N flags once and
// the S bounds, and writes S*N clipped begins and ends and S*N flags:
// at the sharded cell's shapes (S = 4, 16,384 reads of 5 words) ~0.7 MB
// read and ~2.7 MB written, ~1.0 us at 3.35 TB/s (chip_smoke.py
// computes it from the run's shapes).
// Design: a block of CLIP_ROWS (shard, row) pairs, one thread per pair
// clips (the four rows' first words loaded together) and keeps which
// bound each end took; then the block writes its rows word by word, one
// thread per output word, so a warp's stores are 32 consecutive words
// (a thread writing its own row's words would store at a row's stride).
// The TPU's compare folds the words from the least significant one up
// as elementwise selects; a thread here stops at the first differing
// word, which gives the same order.

#include "common.cuh"

namespace {

constexpr int CLIP_ROWS = 256;

__global__ void lt_rows_kernel(const uint32_t* __restrict__ a, int a_step,
                               const uint32_t* __restrict__ b, int b_step,
                               int n, int width, uint8_t* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = fdb::row_cmp(a + (size_t)i * a_step * width,
                        b + (size_t)i * b_step * width, width) < 0;
}

// row i of shard s (pair s * n + i): begin' = max(begin, lo_s), end' =
// min(end, hi_s), valid' = valid && begin' < end'
__global__ void __launch_bounds__(CLIP_ROWS)
    clip_kernel(const uint32_t* __restrict__ b,
                const uint32_t* __restrict__ e, const void* valid,
                int valid_bytes, const uint32_t* __restrict__ lows,
                const uint32_t* __restrict__ highs, int S, int n, int width,
                uint32_t* __restrict__ out_b, uint32_t* __restrict__ out_e,
                uint8_t* __restrict__ out_valid) {
  __shared__ uint8_t took[CLIP_ROWS];  // bit 0: begin' = lo, bit 1: end' = hi
  const long long first = (long long)blockIdx.x * CLIP_ROWS;
  const int rows = (int)min((long long)CLIP_ROWS, (long long)S * n - first);
  const int t = threadIdx.x;
  if (t < rows) {
    const long long idx = first + t;
    const int s = (int)(idx / n), i = (int)(idx - (long long)s * n);
    fdb::Row rb = fdb::load_row(b + (size_t)i * width, width);
    fdb::Row re = fdb::load_row(e + (size_t)i * width, width);
    const fdb::Row lo = fdb::load_row(lows + (size_t)s * width, width);
    const fdb::Row hi = fdb::load_row(highs + (size_t)s * width, width);
    const bool ok = fdb::clip_range(rb, re, lo, hi, width);
    out_valid[idx] = fdb::flag_at(valid, i, valid_bytes) && ok;
    took[t] = (rb.p == lo.p ? 1 : 0) | (re.p == hi.p ? 2 : 0);
  }
  __syncthreads();
  // the block's rows are consecutive in out_b and out_e
  const size_t o = (size_t)first * width;
  for (int j = t; j < rows * width; j += CLIP_ROWS) {
    const int r = j / width, w = j - r * width;
    const long long idx = first + r;
    const int s = (int)(idx / n), i = (int)(idx - (long long)s * n);
    out_b[o + j] = took[r] & 1 ? lows[(size_t)s * width + w]
                               : b[(size_t)i * width + w];
    out_e[o + j] = took[r] & 2 ? highs[(size_t)s * width + w]
                               : e[(size_t)i * width + w];
  }
}

}  // namespace

FDB_API int fdb_lt_rows(const uint32_t* a, int a_step, const uint32_t* b,
                        int b_step, int n, int width, uint8_t* out,
                        void* stream) {
  if (n < 0 || width < 1 || a_step < 0 || a_step > 1 || b_step < 0 ||
      b_step > 1)
    return fdb::ERR_BAD_ARGS;
  if (n == 0) return 0;
  lt_rows_kernel<<<fdb::blocks_for(n, 256), 256, 0,
                   static_cast<cudaStream_t>(stream)>>>(a, a_step, b, b_step,
                                                        n, width, out);
  return static_cast<int>(cudaGetLastError());
}

FDB_API int fdb_clip_to_shards(const uint32_t* b, const uint32_t* e,
                               const void* valid, int valid_bytes,
                               const uint32_t* lows, const uint32_t* highs,
                               int S, int n, int width, uint32_t* out_b,
                               uint32_t* out_e, uint8_t* out_valid,
                               void* stream) {
  if (S < 1 || n < 0 || width < 1 || (valid_bytes != 1 && valid_bytes != 4))
    return fdb::ERR_BAD_ARGS;
  if (n == 0) return 0;
  clip_kernel<<<fdb::blocks_for((long long)S * n, CLIP_ROWS), CLIP_ROWS, 0,
                static_cast<cudaStream_t>(stream)>>>(
      b, e, valid, valid_bytes, lows, highs, S, n, width, out_b, out_e,
      out_valid);
  return static_cast<int>(cudaGetLastError());
}
