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
// Bound: bytes. One thread per query walks log2(cap) dependent probes
// of one row each. At the point path's shapes (a 2^19-row, 12 MiB
// state; 16,384 queries of 5 words) the least traffic is the queries
// read once and the answers written once, plus the state sectors the
// probes touch; the top levels of the search are shared by every query
// and stay in L1/L2, so the kernel is latency-bound on its 19
// dependent loads, which many resident warps hide.

#include "common.cuh"

namespace {

__global__ void searchsorted_rows_kernel(const uint32_t* __restrict__ table,
                                         int cap, int logn, int width,
                                         const uint32_t* __restrict__ queries,
                                         int q,
                                         const uint8_t* __restrict__ right_mask,
                                         int right,
                                         int32_t* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q) return;
  const uint32_t* qr = queries + (size_t)i * width;
  bool upper = right_mask ? right_mask[i] != 0 : right != 0;
  int pos = 0;
  for (int k = 0; k < logn; ++k) {
    int step = cap >> (k + 1);
    int c = fdb::row_cmp(table + (size_t)(pos + step - 1) * width, qr, width);
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
  searchsorted_rows_kernel<<<fdb::blocks_for(q, 256), 256, 0, stream>>>(
      table, cap, logn, width, queries, q, right_mask, right, out);
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
