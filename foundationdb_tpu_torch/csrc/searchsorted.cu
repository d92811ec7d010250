// K1: branchless binary search over a sorted int32 array.
//
// Replaces foundationdb_tpu/ops/keys.py:166 searchsorted_i32 (the
// resolve step's r_starts, ops/conflict_kernel.py:231).
//
// Bound: bytes: the table read once and one answer written per query
// (at the slice's shapes, a 16,384-entry table and 16,386 queries, 64 KB
// and 64 KB: ~0.04 us at 3.35 TB/s). Each query walks log2(n)+1
// dependent probes, so the kernel is bound by the probes' latency. A
// block stages the table's top SS_LEVELS levels in shared memory with one
// load (every (n >> SS_LEVELS)-th entry, 8 KB; the whole table up to
// 2,048 entries), then each thread walks SS_ITEMS queries side by side,
// so the probes of a level issue together: the top levels out of shared
// memory, the levels below from the table in global memory. A block
// takes SS_THREADS * SS_ITEMS = 1,024 queries, so the load is paid once
// per 1,024 searches. Staging all 14 levels of a 16,384-entry table
// (64 KB) measured slower on the H100 than staging 11 (PERF.md). The probe
// sequence is the TPU version's (same answers for any input, sorted or
// not) with its final correction step that makes [0, n] reachable. A
// null `queries` means query i is the integer i (the resolve step
// searches arange(T+2) and never materialises it).

#include <cstdint>

#include "common.cuh"

namespace {

constexpr int SS_THREADS = 256;
constexpr int SS_ITEMS = 4;
constexpr int SS_LEVELS = 11;  // 1 << 11 int32 = 8 KB of shared memory
constexpr int SS_BATCH = 8;    // staging loads in flight per thread

// top[m] = table[((m + 1) << shift) - 1] for m < 1 << lvl, shift =
// logn - lvl: the entries the first lvl probes can touch
__global__ void __launch_bounds__(SS_THREADS)
    searchsorted_i32_kernel(const int32_t* __restrict__ table, int logn,
                            int lvl, const int32_t* __restrict__ queries,
                            int q, int right, int32_t* __restrict__ out) {
  extern __shared__ int32_t top[];
  const int n = 1 << logn, ntop = 1 << lvl, shift = logn - lvl;
  // the staging load: SS_BATCH loads in flight per thread, 16-byte ones
  // over the aligned bulk of a whole table
  int head = 0, n4 = 0;
  if (shift == 0) {
    head = (int)((16 - (reinterpret_cast<uintptr_t>(table) & 15)) & 15) / 4;
    head = min(head, ntop);
    n4 = (ntop - head) / 4;
    const int4* src = reinterpret_cast<const int4*>(table + head);
    for (int b = 0; b < n4; b += SS_THREADS * SS_BATCH) {
      int4 v[SS_BATCH];
#pragma unroll
      for (int k = 0; k < SS_BATCH; ++k) {
        int i = b + k * SS_THREADS + threadIdx.x;
        if (i < n4) v[k] = src[i];
      }
#pragma unroll
      for (int k = 0; k < SS_BATCH; ++k) {
        int i = b + k * SS_THREADS + threadIdx.x;
        if (i < n4) {
          int32_t* d = top + head + 4 * i;
          d[0] = v[k].x;
          d[1] = v[k].y;
          d[2] = v[k].z;
          d[3] = v[k].w;
        }
      }
    }
  }
  // the rest one word at a time: the unaligned head and tail of a whole
  // table, or every (1 << shift)-th entry of a larger one
  const int done = head + 4 * n4, rest = ntop - done + head;
  for (int b = 0; b < rest; b += SS_THREADS * SS_BATCH) {
    int32_t v[SS_BATCH];
#pragma unroll
    for (int k = 0; k < SS_BATCH; ++k) {
      int j = b + k * SS_THREADS + threadIdx.x;
      int i = j < head ? j : done + j - head;
      if (j < rest) v[k] = table[((i + 1) << shift) - 1];
    }
#pragma unroll
    for (int k = 0; k < SS_BATCH; ++k) {
      int j = b + k * SS_THREADS + threadIdx.x;
      if (j < rest) top[j < head ? j : done + j - head] = v[k];
    }
  }
  __syncthreads();
  const int base = blockIdx.x * SS_THREADS * SS_ITEMS + threadIdx.x;
  int32_t x[SS_ITEMS];
  int pos[SS_ITEMS];
#pragma unroll
  for (int k = 0; k < SS_ITEMS; ++k) {
    int i = base + k * SS_THREADS;
    x[k] = i < q ? (queries ? queries[i] : i) : 0;
    pos[k] = 0;
  }
  for (int lv = 0; lv < logn; ++lv) {
    const int step = n >> (lv + 1);
#pragma unroll
    for (int k = 0; k < SS_ITEMS; ++k) {
      int32_t probe = lv < lvl ? top[((pos[k] + step) >> shift) - 1]
                               : table[pos[k] + step - 1];
      bool take = right ? probe <= x[k] : probe < x[k];
      pos[k] += take ? step : 0;
    }
  }
#pragma unroll
  for (int k = 0; k < SS_ITEMS; ++k) {
    int i = base + k * SS_THREADS;
    if (i >= q) continue;
    int32_t probe = shift == 0 ? top[pos[k]] : table[pos[k]];
    out[i] = pos[k] + ((right ? probe <= x[k] : probe < x[k]) ? 1 : 0);
  }
}

}  // namespace

cudaError_t fdb_searchsorted_launch(const int32_t* table, int n,
                                    const int32_t* queries, int q, int right,
                                    int32_t* out, cudaStream_t stream) {
  if (n <= 0 || (n & (n - 1)) || q < 0) return cudaErrorInvalidValue;
  if (q == 0) return cudaSuccess;
  int logn = 0;
  while ((1 << logn) < n) ++logn;
  const int lvl = logn < SS_LEVELS ? logn : SS_LEVELS;
  const size_t smem = ((size_t)1 << lvl) * sizeof(int32_t);
  searchsorted_i32_kernel<<<fdb::blocks_for(q, SS_THREADS * SS_ITEMS),
                            SS_THREADS, smem, stream>>>(
      table, logn, lvl, queries, q, right, out);
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
