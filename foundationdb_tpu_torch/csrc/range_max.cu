// K2: range max of an int32 version array over [lo, hi) per query.
//
// Replaces foundationdb_tpu/ops/rmq.py:36 build_range_max_table,
// :57 _block_range_max and :69 range_max (the resolve step's external
// check, ops/conflict_kernel.py:223).
//
// Bound: bytes. The function must read the 32-byte sectors of the
// values that its ranges touch, read (lo, hi) and write one answer per
// query. On the resolve step's point reads each range spans one or two
// values, so 16,384 queries touch about 16K sectors: ~0.5 MB plus
// 192 KB, ~0.2 us at 3.35 TB/s (chip_smoke.py computes it from the
// run's ranges).
// Design: the TPU structure kept as it is: one warp per 128-value block
// computes the in-block prefix and suffix max with shuffles (coalesced,
// one pass), and a doubling sparse table covers only the n/128 block
// maxima (14 levels of 8,192 at the slice's shapes, built by one
// block). A query is then at most three reads, or a short scan inside
// one block. The build reads all n values, so on short ranges the
// kernel moves ~6x the bytes the bound counts; a build-free path for
// short ranges is the known excess to remove. Empty ranges give VDEAD,
// every answer is floored at VDEAD, and indices are clamped to
// [0, n-1] as in the plain version.

#include <climits>

#include "common.cuh"

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;

__global__ void rmq_blocks_kernel(const int32_t* __restrict__ v, int nb,
                                  int32_t* __restrict__ pre,
                                  int32_t* __restrict__ suf,
                                  int32_t* __restrict__ bmax) {
  int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int lane = threadIdx.x & 31;
  if (warp >= nb) return;  // whole warps exit together
  size_t base = (size_t)warp * fdb::RMQ_BLOCK + lane * 4;
  int32_t a0 = v[base], a1 = v[base + 1], a2 = v[base + 2], a3 = v[base + 3];
  int32_t p0 = a0, p1 = max(p0, a1), p2 = max(p1, a2), p3 = max(p2, a3);
  int32_t incl = p3;
  for (int off = 1; off < 32; off <<= 1) {
    int32_t y = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl = max(incl, y);
  }
  int32_t excl = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) excl = INT_MIN;
  pre[base] = max(excl, p0);
  pre[base + 1] = max(excl, p1);
  pre[base + 2] = max(excl, p2);
  pre[base + 3] = max(excl, p3);
  int32_t s3 = a3, s2 = max(a2, s3), s1 = max(a1, s2), s0 = max(a0, s1);
  int32_t sincl = s0;
  for (int off = 1; off < 32; off <<= 1) {
    int32_t y = __shfl_down_sync(FULL, sincl, off);
    if (lane + off < 32) sincl = max(sincl, y);
  }
  int32_t sexcl = __shfl_down_sync(FULL, sincl, 1);
  if (lane == 31) sexcl = INT_MIN;
  suf[base] = max(sexcl, s0);
  suf[base + 1] = max(sexcl, s1);
  suf[base + 2] = max(sexcl, s2);
  suf[base + 3] = max(sexcl, s3);
  if (lane == 31) bmax[warp] = incl;
}

// tab[0] holds the block maxima; level k is max over 2^k blocks
__global__ void rmq_table_kernel(int32_t* tab, int nb, int levels) {
  for (int k = 1; k < levels; ++k) {
    int half = 1 << (k - 1);
    const int32_t* prev = tab + (size_t)(k - 1) * nb;
    int32_t* cur = tab + (size_t)k * nb;
    for (int j = threadIdx.x; j < nb; j += blockDim.x)
      cur[j] = max(prev[j], j + half < nb ? prev[j + half] : fdb::VDEAD);
    __syncthreads();
  }
}

__global__ void rmq_query_kernel(const int32_t* __restrict__ v,
                                 const int32_t* __restrict__ pre,
                                 const int32_t* __restrict__ suf,
                                 const int32_t* __restrict__ tab, int nb,
                                 const int32_t* __restrict__ lo_a,
                                 const int32_t* __restrict__ hi_a, int q,
                                 int32_t* __restrict__ out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= q) return;
  int lo = lo_a[i], hi = hi_a[i];
  int32_t m = fdb::VDEAD;
  if (hi > lo) {
    // clamp both ends into [0, n-1], as the plain version's gathers do
    int n_last = nb * fdb::RMQ_BLOCK - 1;
    lo = min(max(lo, 0), n_last);
    int last = min(max(hi - 1, 0), n_last);
    int lb = lo / fdb::RMQ_BLOCK, hb = last / fdb::RMQ_BLOCK;
    if (lb == hb) {
      for (int j = lo; j <= last; ++j) m = max(m, v[j]);
    } else {
      m = max(m, max(suf[lo], pre[last]));
      int a = lb + 1, len = hb - a;
      if (len > 0) {
        int k = 31 - __clz(len);
        m = max(m, max(tab[(size_t)k * nb + a],
                       tab[(size_t)k * nb + hb - (1 << k)]));
      }
    }
  }
  out[i] = m;
}

int levels_for(int nb) {
  int k = 1;
  while ((1 << k) <= nb) ++k;
  return k;
}

}  // namespace

size_t fdb_range_max_scratch(int n) {
  int nb = n / fdb::RMQ_BLOCK;
  fdb::Carver c{nullptr, 0};
  c.take<int32_t>(n);
  c.take<int32_t>(n);
  c.take<int32_t>((size_t)levels_for(nb) * nb);
  return c.off;
}

cudaError_t fdb_range_max_launch(const int32_t* vals, int n,
                                 const int32_t* lo, const int32_t* hi, int q,
                                 int32_t* out, void* scratch,
                                 cudaStream_t stream) {
  if (n < fdb::RMQ_BLOCK || n % fdb::RMQ_BLOCK || q < 0)
    return cudaErrorInvalidValue;
  int nb = n / fdb::RMQ_BLOCK, levels = levels_for(nb);
  fdb::Carver c{static_cast<char*>(scratch), 0};
  int32_t* pre = c.take<int32_t>(n);
  int32_t* suf = c.take<int32_t>(n);
  int32_t* tab = c.take<int32_t>((size_t)levels * nb);
  rmq_blocks_kernel<<<fdb::blocks_for((long long)nb * 32, 256), 256, 0,
                      stream>>>(vals, nb, pre, suf, tab);
  cudaError_t e = cudaGetLastError();
  if (e) return e;
  if (levels > 1) {
    rmq_table_kernel<<<1, 1024, 0, stream>>>(tab, nb, levels);
    if ((e = cudaGetLastError())) return e;
  }
  if (q == 0) return cudaSuccess;
  rmq_query_kernel<<<fdb::blocks_for(q, 256), 256, 0, stream>>>(
      vals, pre, suf, tab, nb, lo, hi, q, out);
  return cudaGetLastError();
}

FDB_API size_t fdb_range_max_scratch_bytes(int n) {
  return fdb_range_max_scratch(n);
}

FDB_API int fdb_range_max(const int32_t* vals, int n, const int32_t* lo,
                          const int32_t* hi, int q, int32_t* out,
                          void* scratch, size_t scratch_bytes, void* stream) {
  if (scratch_bytes < fdb_range_max_scratch(n)) return fdb::ERR_SCRATCH;
  return static_cast<int>(fdb_range_max_launch(
      vals, n, lo, hi, q, out, scratch, static_cast<cudaStream_t>(stream)));
}
