// K1: branchless binary search over a sorted int32 array.
//
// Replaces foundationdb_tpu/ops/keys.py:166 searchsorted_i32 (the
// resolve step's r_starts, ops/conflict_kernel.py:231).
//
// Bound: bytes. One thread per query walks log2(n)+1 dependent probes;
// at the slice's shapes (a 16,384-entry table, 16,386 queries) the
// table is 64 KB and stays in L1/L2, so the floor is the 128 KB of
// query output plus the table read once. The design keeps the TPU
// version's exact probe sequence (same answers for any input, sorted
// or not) and its final correction step that makes [0, n] reachable.
// A null `queries` means query i is the integer i (the resolve step
// searches arange(T+2) and never materialises it).

#include "common.cuh"

namespace {

__global__ void searchsorted_i32_kernel(const int32_t* __restrict__ table,
                                        int n, int logn,
                                        const int32_t* __restrict__ queries,
                                        int q, int right,
                                        int32_t* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q) return;
  int32_t x = queries ? queries[i] : i;
  int pos = 0;
  for (int k = 0; k < logn; ++k) {
    int step = n >> (k + 1);
    int32_t probe = table[pos + step - 1];
    bool take = right ? probe <= x : probe < x;
    pos += take ? step : 0;
  }
  int32_t probe = table[pos];
  out[i] = pos + ((right ? probe <= x : probe < x) ? 1 : 0);
}

}  // namespace

cudaError_t fdb_searchsorted_launch(const int32_t* table, int n,
                                    const int32_t* queries, int q, int right,
                                    int32_t* out, cudaStream_t stream) {
  if (n <= 0 || (n & (n - 1)) || q < 0) return cudaErrorInvalidValue;
  if (q == 0) return cudaSuccess;
  int logn = 0;
  while ((1 << logn) < n) ++logn;
  searchsorted_i32_kernel<<<fdb::blocks_for(q, 256), 256, 0, stream>>>(
      table, n, logn, queries, q, right, out);
  return cudaGetLastError();
}

FDB_API int fdb_searchsorted_i32(const int32_t* table, int n,
                                 const int32_t* queries, int q, int right,
                                 int32_t* out, void* stream) {
  return static_cast<int>(fdb_searchsorted_launch(
      table, n, queries, q, right, out, static_cast<cudaStream_t>(stream)));
}

FDB_API const char* fdb_error_string(int code) {
  if (code == fdb::ERR_BAD_ARGS) return "bad arguments to a kernel entry";
  if (code == fdb::ERR_SCRATCH) return "scratch buffer too small";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
