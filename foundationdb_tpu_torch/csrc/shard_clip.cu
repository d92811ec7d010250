// K7: the lexicographic row compare and the shard clip built on it.
//
// Replaces foundationdb_tpu/ops/keys.py:101 lt_rows and :114 le_rows,
// and the clip the sharded resolver builds from them
// (foundationdb_tpu/parallel/sharded_resolver.py:49-65: rows_max of the
// begins against the shard's lower bound, rows_min of the ends against
// its upper bound, and valid & lt_rows(begin', end')).
//
// Bound: bytes. lt_rows reads both row sets once and writes one byte
// per row. The clip reads N begin rows, N end rows and N flags once and
// the S bounds, and writes S*N clipped begins and ends and S*N flags:
// at the sharded slice's shapes (S = 4, 16,384 reads and 16,384 writes
// of 5 words, two launches) ~1.4 MB read and ~11 MB written, ~3.6 us at
// 3.35 TB/s (chip_smoke.py computes it from the run's shapes).
// Design: one thread per (shard, row), the same row compare as every
// other kernel (common.cuh row_cmp), neighbouring threads on
// neighbouring rows. The TPU's version folds the words from the least
// significant one up as elementwise selects; a thread here stops at the
// first differing word, which gives the same order.

#include "common.cuh"

namespace {

__global__ void lt_rows_kernel(const uint32_t* __restrict__ a, int a_step,
                               const uint32_t* __restrict__ b, int b_step,
                               int n, int width, uint8_t* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = fdb::row_cmp(a + (size_t)i * a_step * width,
                        b + (size_t)i * b_step * width, width) < 0;
}

// row i of shard s: begin' = max(begin, lo_s), end' = min(end, hi_s),
// valid' = valid && begin' < end'
__global__ void clip_kernel(const uint32_t* __restrict__ b,
                            const uint32_t* __restrict__ e, const void* valid,
                            int valid_bytes, const uint32_t* __restrict__ lows,
                            const uint32_t* __restrict__ highs, int S, int n,
                            int width, uint32_t* __restrict__ out_b,
                            uint32_t* __restrict__ out_e, void* out_valid,
                            int out_bytes) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)S * n) return;
  int s = (int)(idx / n), i = (int)(idx - (long long)s * n);
  const uint32_t* bi = b + (size_t)i * width;
  const uint32_t* ei = e + (size_t)i * width;
  const uint32_t* lo = lows + (size_t)s * width;
  const uint32_t* hi = highs + (size_t)s * width;
  const uint32_t* nb = fdb::row_cmp(bi, lo, width) < 0 ? lo : bi;
  const uint32_t* ne = fdb::row_cmp(hi, ei, width) < 0 ? hi : ei;
  uint32_t* ob = out_b + (size_t)idx * width;
  uint32_t* oe = out_e + (size_t)idx * width;
  for (int w = 0; w < width; ++w) {
    ob[w] = nb[w];
    oe[w] = ne[w];
  }
  bool v = fdb::flag_at(valid, i, valid_bytes) &&
           fdb::row_cmp(nb, ne, width) < 0;
  if (out_bytes == 4)
    static_cast<uint32_t*>(out_valid)[idx] = v;
  else
    static_cast<uint8_t*>(out_valid)[idx] = v;
}

}  // namespace

cudaError_t fdb_clip_launch(const uint32_t* b, const uint32_t* e,
                            const void* valid, int valid_bytes,
                            const uint32_t* lows, const uint32_t* highs,
                            int S, int n, int width, uint32_t* out_b,
                            uint32_t* out_e, void* out_valid, int out_bytes,
                            cudaStream_t stream) {
  if (S < 1 || n < 0 || width < 1 || (valid_bytes != 1 && valid_bytes != 4) ||
      (out_bytes != 1 && out_bytes != 4))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  clip_kernel<<<fdb::blocks_for((long long)S * n, 256), 256, 0, stream>>>(
      b, e, valid, valid_bytes, lows, highs, S, n, width, out_b, out_e,
      out_valid, out_bytes);
  return cudaGetLastError();
}

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
  return static_cast<int>(fdb_clip_launch(
      b, e, valid, valid_bytes, lows, highs, S, n, width, out_b, out_e,
      out_valid, 1, static_cast<cudaStream_t>(stream)));
}
