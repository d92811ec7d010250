// K6: branchless binary search over sorted multiword key rows.
//
// Replaces foundationdb_tpu/ops/keys.py:118 searchsorted_rows and :143
// searchsorted_rows_mixed (the point resolve step's external lookup,
// ops/point_kernel.py:125). Both run this one kernel: the side is a
// per-query byte mask (nonzero = "right", count rows <= q; zero =
// "left", count rows < q), and a null mask means every query takes the
// uniform `right` flag.
//
// Rows are `width` uint32 words compared lexicographically over all of
// them, the length word included. The probe sequence is the
// reference's exactly: log2(cap) probes from position 0 and no final
// correction step, so with no +inf pad row a query above every row
// answers cap-1, not cap (the reference's contract needs a pad row; the
// answer is kept as it is, bit for bit, for any table).
//
// Bound: bytes. At the point path's shapes (a 2^19-row, 12 MiB state;
// 16,384 queries of 5 words) the least traffic is the queries read
// once, the answers written once and the state sectors the probes
// touch (chip_smoke.py counts them): under 1 us at 3.35 TB/s. A query's
// 19 probes are a chain of dependent row reads; the top ~7 levels are
// the same few rows for a block's queries and stay in L1, the rest are
// scattered rows of the state. What the design does about it:
//  - A probed row's first ROW_CW words load together, before any
//    compare (common.cuh load_row, the row load the external check of
//    K3 and K8 shares), so a probe costs one memory round trip whatever
//    the keys' common prefix (a word-by-word compare paid one per equal
//    word: the point cell's keys share their first 8 bytes).
//  - 128-thread blocks, one query a thread: 16,384 queries spread over
//    128 SMs.
// Tried on the H100 in diagnostic builds and left out (PERF.md, PR 7):
// staging the top 11 levels in shared memory (slower: every block
// gathers the same 2,047 scattered rows at once), staging 6 or 8 levels
// (no faster than L1), loading with each probe the two rows the next
// probe may take (2 levels a round on 3 rows: slower), 16-byte loads of
// a row (no faster), and a row's second sector read only on a tie
// (slower).

#include "common.cuh"

namespace {

constexpr int RS_THREADS = 128;

__global__ void __launch_bounds__(RS_THREADS)
    searchsorted_rows_kernel(const uint32_t* __restrict__ table, int logn,
                             int width, const uint32_t* __restrict__ queries,
                             int q, const uint8_t* __restrict__ right_mask,
                             int right, int32_t* __restrict__ out) {
  const int i = blockIdx.x * RS_THREADS + threadIdx.x;
  if (i >= q) return;
  const fdb::Row qr = fdb::load_row(queries + (size_t)i * width, width);
  const bool upper = right_mask ? right_mask[i] != 0 : right != 0;
  const int cap = 1 << logn;
  int pos = 0;
  for (int lv = 0; lv < logn; ++lv) {
    const int step = cap >> (lv + 1);
    const fdb::Row x =
        fdb::load_row(table + (size_t)(pos + step - 1) * width, width);
    const int c = fdb::cmp_rows(x, qr, width);
    pos += (upper ? c <= 0 : c < 0) ? step : 0;
  }
  out[i] = pos;
}

}  // namespace

cudaError_t fdb_searchsorted_rows_launch(const uint32_t* table, int cap,
                                         int width, const uint32_t* queries,
                                         int q, const uint8_t* right_mask,
                                         int right, int32_t* out,
                                         cudaStream_t stream) {
  if (cap <= 0 || (cap & (cap - 1)) || width < 1 || q < 0)
    return cudaErrorInvalidValue;
  if (q == 0) return cudaSuccess;
  int logn = 0;
  while ((1 << logn) < cap) ++logn;
  searchsorted_rows_kernel<<<fdb::blocks_for(q, RS_THREADS), RS_THREADS, 0,
                             stream>>>(table, logn, width, queries, q,
                                       right_mask, right, out);
  return cudaGetLastError();
}

FDB_API int fdb_searchsorted_rows(const uint32_t* table, int cap, int width,
                                  const uint32_t* queries, int q,
                                  const uint8_t* right_mask, int right,
                                  int32_t* out, void* stream) {
  return static_cast<int>(fdb_searchsorted_rows_launch(
      table, cap, width, queries, q, right_mask, right, out,
      static_cast<cudaStream_t>(stream)));
}
