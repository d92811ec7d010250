// K2: range max of S int32 version arrays over [lo, hi) per query.
//
// Replaces foundationdb_tpu/ops/rmq.py:36 build_range_max_table,
// :57 _block_range_max and :69 range_max (the resolve step's external
// check, ops/conflict_kernel.py:223; the sharded step's over every
// shard's HV at once).
//
// For array k and query i: the max of vals[k][lo..hi) with both ends of
// a non-empty range clamped into [0, n-1] and the answer floored at
// VDEAD; VDEAD for an empty or inverted range (hi <= lo). Values are
// version offsets, never below VDEAD, so this is the reference's
// sparse-table answer bit for bit.
//
// Bound: bytes. The function must read the 32-byte sectors of the
// values that its ranges touch, read (lo, hi) and write one answer per
// query. On the resolve step's point reads each range spans one or two
// values, so 16,384 queries touch about 16K sectors: ~0.5 MB plus
// 192 KB, ~0.2 us at 3.35 TB/s (chip_smoke.py computes it from the
// run's ranges).
//
// Design: two launches for all S arrays, and no table per query shape.
//  1. rmq_summary_kernel: a block per super-block of RMQ_SUPER blocks of
//     128 values, a warp per block (coalesced loads, one __reduce_max),
//     writes every block's max and every super-block's max: n/128 +
//     n/8192 int32 an array. It reads each value once, spread over
//     S * n / 8192 blocks (128 at the cells' shapes), not one SM.
//  2. rmq_query_kernel: a thread per query. A range of at most
//     RMQ_SHORT values, as every point read is, is read by its own
//     thread. Then the warp takes its long ranges one at a time, all 32
//     lanes on one range: the two partial blocks, the block maxima out
//     to the super-block edges, the super-block maxima between, reduced
//     with __reduce_max_sync. So short and long scans never share a
//     diverging warp, and a long range costs a lane about
//     (256 + 128 + n/8192) / 32 loads.
// The prefix and suffix arrays and the one-block sparse table of the
// reference's structure are gone: on point reads they were built over
// all of HV (12 MB written at 2^20) and went unread. The two halves are
// device functions in rmq.cuh, which K8e runs inside its own launch.

#include "common.cuh"
#include "rmq.cuh"

namespace {

constexpr int SUM_WARPS = 8;       // RMQ_SUPER / SUM_WARPS blocks a warp
constexpr int Q_THREADS = 256;

__global__ void __launch_bounds__(SUM_WARPS * 32)
    rmq_summary_kernel(const int32_t* __restrict__ vals, int n, int nb,
                       int nsb, int32_t* __restrict__ bmax,
                       int32_t* __restrict__ smax) {
  const int k = blockIdx.y;
  fdb::rmq_summarize<SUM_WARPS>(vals + (size_t)k * n, nb, blockIdx.x,
                                bmax + (size_t)k * nb, smax + (size_t)k * nsb);
}

__global__ void __launch_bounds__(Q_THREADS)
    rmq_query_kernel(const int32_t* __restrict__ vals,
                     const int32_t* __restrict__ bmax,
                     const int32_t* __restrict__ smax, int n, int nb,
                     int nsb, const int32_t* __restrict__ lo_a,
                     const int32_t* __restrict__ hi_a, int q,
                     long long total, int32_t* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const bool live = i < total;   // dead lanes still join the warp's work
  const int k = live ? (int)(i / q) : 0;
  const int lo = live ? lo_a[i] : 0, hi = live ? hi_a[i] : 0;
  const bool any = hi > lo;
  const int a = min(max(lo, 0), n - 1);
  const int b = min(max(hi - 1, 0), n - 1);
  const bool is_long = any && b - a >= fdb::RMQ_SHORT;
  const int32_t* v = vals + (size_t)k * n;
  int32_t m = fdb::VDEAD;
  if (any && !is_long)
    for (int j = a; j <= b; ++j) m = max(m, v[j]);
  for (unsigned longs = __ballot_sync(fdb::FULL_MASK, is_long); longs;
       longs &= longs - 1) {
    const int src = __ffs(longs) - 1;
    const int la = __shfl_sync(fdb::FULL_MASK, a, src);
    const int lb = __shfl_sync(fdb::FULL_MASK, b, src);
    const int lk = __shfl_sync(fdb::FULL_MASK, k, src);
    const int32_t r =
        fdb::warp_range_max(vals + (size_t)lk * n, bmax + (size_t)lk * nb,
                            smax + (size_t)lk * nsb, la, lb, lane);
    if (lane == src) m = r;
  }
  if (live) out[i] = m;
}

int supers_for(int nb) { return (nb + fdb::RMQ_SUPER - 1) / fdb::RMQ_SUPER; }

}  // namespace

size_t fdb_range_max_scratch(int S, int n) {
  const int nb = n / fdb::RMQ_BLOCK;
  fdb::Carver c{nullptr, 0};
  c.take<int32_t>((size_t)S * nb);
  c.take<int32_t>((size_t)S * supers_for(nb));
  return c.off;
}

cudaError_t fdb_range_max_launch(const int32_t* vals, int S, int n,
                                 const int32_t* lo, const int32_t* hi, int q,
                                 int32_t* out, void* scratch,
                                 cudaStream_t stream) {
  if (S < 1 || S > 65535 || n < fdb::RMQ_BLOCK || n % fdb::RMQ_BLOCK ||
      q < 0)
    return cudaErrorInvalidValue;
  if (q == 0) return cudaSuccess;
  const int nb = n / fdb::RMQ_BLOCK, nsb = supers_for(nb);
  fdb::Carver c{static_cast<char*>(scratch), 0};
  int32_t* bmax = c.take<int32_t>((size_t)S * nb);
  int32_t* smax = c.take<int32_t>((size_t)S * nsb);
  rmq_summary_kernel<<<dim3(nsb, S), SUM_WARPS * 32, 0, stream>>>(
      vals, n, nb, nsb, bmax, smax);
  cudaError_t e = cudaGetLastError();
  if (e) return e;
  const long long total = (long long)S * q;
  rmq_query_kernel<<<fdb::blocks_for(total, Q_THREADS), Q_THREADS, 0,
                     stream>>>(vals, bmax, smax, n, nb, nsb, lo, hi, q,
                               total, out);
  return cudaGetLastError();
}

FDB_API size_t fdb_range_max_scratch_bytes(int S, int n) {
  return fdb_range_max_scratch(S, n);
}

// vals [S, n], lo/hi/out [S, q]
FDB_API int fdb_range_max(const int32_t* vals, int S, int n,
                          const int32_t* lo, const int32_t* hi, int q,
                          int32_t* out, void* scratch, size_t scratch_bytes,
                          void* stream) {
  if (S < 1 || n < 0) return fdb::ERR_BAD_ARGS;
  if (scratch_bytes < fdb_range_max_scratch(S, n)) return fdb::ERR_SCRATCH;
  return static_cast<int>(fdb_range_max_launch(
      vals, S, n, lo, hi, q, out, scratch, static_cast<cudaStream_t>(stream)));
}
