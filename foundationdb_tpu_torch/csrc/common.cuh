// Shared definitions of the port's hand-written kernels.
//
// Everything is integer: keys are rows of `width` uint32 words (W
// big-endian words plus a length word, ops/keys.py), compared
// lexicographically; versions are int32 offsets. No floats and no
// order-dependent atomics, so every kernel is bit-exact against its
// plain PyTorch version.
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

#define FDB_API extern "C" __attribute__((visibility("default")))

namespace fdb {

constexpr int32_t VDEAD = -(1 << 30);          // ops/rmq.py VDEAD
constexpr int32_t SNAP_CLAMP = (1 << 30) + 1;  // ops/conflict_kernel.py
constexpr uint32_t INF_WORD = 0xFFFFFFFFu;
constexpr int RMQ_BLOCK = 128;                 // ops/rmq.py BLOCK
constexpr int ERR_BAD_ARGS = 10001;            // reported by fdb_error_string
constexpr int ERR_SCRATCH = 10002;

__device__ __forceinline__ int row_cmp(const uint32_t* a, const uint32_t* b,
                                       int width) {
  for (int w = 0; w < width; ++w) {
    uint32_t x = a[w], y = b[w];
    if (x != y) return x < y ? -1 : 1;
  }
  return 0;
}

__device__ __forceinline__ bool row_is_inf(const uint32_t* a, int width) {
  for (int w = 0; w < width; ++w)
    if (a[w] != INF_WORD) return false;
  return true;
}

// A row read the one way the searches read it: its first ROW_CW words
// loaded together, before any compare (zeros past the width), so a
// compare costs one memory round trip whatever prefix the keys share (a
// word-by-word compare pays one per equal word); the words past them
// are read from `p` only on a tie.
constexpr int ROW_CW = 8;

struct Row {
  uint32_t w[ROW_CW];
  const uint32_t* p;
};

__device__ __forceinline__ Row load_row(const uint32_t* p, int width) {
  Row r;
  r.p = p;
#pragma unroll
  for (int j = 0; j < ROW_CW; ++j) r.w[j] = j < width ? p[j] : 0u;
  return r;
}

// -1, 0 or 1: the lexicographic order of two loaded rows
__device__ __forceinline__ int cmp_rows(const Row& a, const Row& b,
                                        int width) {
#pragma unroll
  for (int j = 0; j < ROW_CW; ++j)
    if (a.w[j] != b.w[j]) return a.w[j] < b.w[j] ? -1 : 1;
  for (int w = ROW_CW; w < width; ++w) {
    uint32_t x = a.p[w], y = b.p[w];
    if (x != y) return x < y ? -1 : 1;
  }
  return 0;
}

// N searches at once in a sorted table of n >= 0 rows: out[j] = the
// count of rows < q[j], or <= q[j] where upper[j] (a true lower or
// upper bound, in [0, n]). The probes halve [base, base + len], which
// holds the answer, until len is 1, then one last probe at base decides
// between base and base + 1; the probe count depends on n alone, so a
// warp's lanes, and the N searches of a thread, probe in lockstep and
// the N rows of a round load together. At n = 2^k the probes are K6's
// sequence plus that last probe.
template <int N>
__device__ __forceinline__ void row_bounds(const uint32_t* tab, int n,
                                           const Row (&q)[N],
                                           const bool (&upper)[N],
                                           int width, int (&out)[N]) {
  int base[N];
#pragma unroll
  for (int j = 0; j < N; ++j) base[j] = 0;
  if (n == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) out[j] = 0;
    return;
  }
  for (int len = n; len > 1;) {
    const int half = len >> 1;
    Row x[N];
#pragma unroll
    for (int j = 0; j < N; ++j)
      x[j] = load_row(tab + (size_t)(base[j] + half - 1) * width, width);
#pragma unroll
    for (int j = 0; j < N; ++j)
      base[j] += cmp_rows(x[j], q[j], width) < (int)upper[j] ? half : 0;
    len -= half;
  }
  Row x[N];
#pragma unroll
  for (int j = 0; j < N; ++j)
    x[j] = load_row(tab + (size_t)base[j] * width, width);
#pragma unroll
  for (int j = 0; j < N; ++j)
    out[j] = base[j] + (cmp_rows(x[j], q[j], width) < (int)upper[j]);
}

// count of rows < q (upper=false) or <= q (upper=true) in a sorted table
__device__ __forceinline__ int row_bound(const uint32_t* tab, int n,
                                         const uint32_t* q, int width,
                                         bool upper) {
  const Row qs[1] = {load_row(q, width)};
  const bool up[1] = {upper};
  int out[1];
  row_bounds<1>(tab, n, qs, up, width, out);
  return out[0];
}

// K7's clip of the range [b, e) to a shard's [lo, hi): b' = max(b, lo),
// e' = min(e, hi), as the reference's rows_max / rows_min do
// (foundationdb_tpu/parallel/sharded_resolver.py:49-65); true when the
// clipped range is non-empty (lt_rows(b', e')). The one definition: the
// standalone clip, the sharded step's external check and its survivor
// partition all call it.
__device__ __forceinline__ bool clip_range(Row& b, Row& e, const Row& lo,
                                           const Row& hi, int width) {
  if (cmp_rows(b, lo, width) < 0) b = lo;
  if (cmp_rows(hi, e, width) < 0) e = hi;
  return cmp_rows(b, e, width) < 0;
}

// a flag array is bool (1 byte) in the unpacked feed and uint32 in the
// packed feed; nonzero is true in both
__device__ __forceinline__ bool flag_at(const void* p, int i, int bytes) {
  return bytes == 4 ? static_cast<const uint32_t*>(p)[i] != 0u
                    : static_cast<const uint8_t*>(p)[i] != 0;
}

inline int blocks_for(long long n, int threads) {
  return static_cast<int>((n + threads - 1) / threads);
}

inline size_t align_up(size_t x) { return (x + 255) & ~size_t(255); }

constexpr unsigned FULL_MASK = 0xFFFFFFFFu;

template <bool MAX>
__device__ __forceinline__ int scan_op(int a, int b) {
  return MAX ? max(a, b) : a + b;
}

// exclusive block scan, max (MAX) or sum (identity 0: every scanned
// value is >= 0 for the max scans, and sums start at 0); `total` gets
// the block's reduction. Every thread of the block must call it.
template <bool MAX>
__device__ int block_excl_scan(int v, int& total) {
  __shared__ int wt[32];
  int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int nw = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(FULL_MASK, x, o);
    if (lane >= o) x = scan_op<MAX>(y, x);
  }
  if (lane == 31) wt[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int w = lane < nw ? wt[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(FULL_MASK, w, o);
      if (lane >= o) w = scan_op<MAX>(y, w);
    }
    if (lane < nw) wt[lane] = w;
  }
  __syncthreads();
  int wpre = wid ? wt[wid - 1] : 0;
  total = wt[nw - 1];
  int incl = scan_op<MAX>(wpre, x);
  int excl = __shfl_up_sync(FULL_MASK, incl, 1);
  if (lane == 0) excl = wpre;
  __syncthreads();
  return excl;
}

namespace {

// exclusive scan of per-tile aggregates by ONE block (launch <<<1, T>>>);
// the grand reduction to `total` when it is not null. A launch of
// <<<(1, S), T>>> scans S rows of n aggregates, row y into total[y].
template <bool MAX>
__global__ void scan_tiles_kernel(const int32_t* agg, int32_t* pre, int n,
                                  int32_t* total) {
  agg += (size_t)blockIdx.y * n;
  pre += (size_t)blockIdx.y * n;
  if (total) total += blockIdx.y;
  int carry = 0;
  for (int base = 0; base < n; base += blockDim.x) {
    int i = base + threadIdx.x;
    int tot;
    int ex = block_excl_scan<MAX>(i < n ? agg[i] : 0, tot);
    if (i < n) pre[i] = scan_op<MAX>(carry, ex);
    carry = scan_op<MAX>(carry, tot);
  }
  if (total && threadIdx.x == 0) *total = carry;
}

// blocks for a cooperative launch of `kernel` at `threads` per block with
// `smem` bytes of dynamic shared memory: `needed`, capped at what can be
// co-resident on the current device (cached per kernel, device and
// smem; set a kernel's shared-memory attribute before asking)
inline int coop_blocks(const void* kernel, int threads, size_t smem,
                       int needed) {
  struct Seen {
    const void* kernel;
    int dev;
    size_t smem;
    int max;
  };
  constexpr int kSeen = 32;
  static Seen seen[kSeen];
  static int n_seen = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  int most = -1;
  for (int i = 0; i < n_seen && i < kSeen; ++i)
    if (seen[i].kernel == kernel && seen[i].dev == dev &&
        seen[i].smem == smem)
      most = seen[i].max;
  if (most < 0) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                  smem);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    most = per_sm * sms;
    seen[n_seen++ % kSeen] = Seen{kernel, dev, smem, most};
  }
  if (needed < 1) needed = 1;
  return most < needed ? (most > 1 ? most : 1) : needed;
}

// coop_blocks for `Kernel` with no dynamic shared memory
template <auto Kernel, int Threads>
int coop_grid(int needed) {
  return coop_blocks((const void*)Kernel, Threads, 0, needed);
}

}  // namespace

// bump allocator over one caller-provided scratch buffer
struct Carver {
  char* base;
  size_t off;
  template <typename T>
  T* take(size_t n) {
    T* p = reinterpret_cast<T*>(base ? base + off : nullptr);
    off = align_up(off + n * sizeof(T));
    return p;
  }
};

}  // namespace fdb

// inside a C entry point returning int: return the CUDA error code of
// `expr`, or of the launch just made, when it is not cudaSuccess
#define FDB_TRY(expr)                          \
  do {                                         \
    cudaError_t e_ = (expr);                   \
    if (e_ != cudaSuccess) return (int)e_;     \
  } while (0)
#define FDB_LAUNCHED() FDB_TRY(cudaGetLastError())

// launchers shared between translation units (K3 and the sharded step
// K8 launch K1 and K2; K5 launches K1 and K6)
cudaError_t fdb_searchsorted_launch(const int32_t* table, int n,
                                    const int32_t* queries, int q, int right,
                                    int32_t* out, cudaStream_t stream);
cudaError_t fdb_searchsorted_rows_launch(const uint32_t* table, int cap,
                                         int width, const uint32_t* queries,
                                         int q, const uint8_t* right_mask,
                                         int right, int32_t* out,
                                         cudaStream_t stream);
// K2 over S arrays: vals [S, n], lo/hi/out [S, q]
size_t fdb_range_max_scratch(int S, int n);
cudaError_t fdb_range_max_launch(const int32_t* vals, int S, int n,
                                 const int32_t* lo, const int32_t* hi, int q,
                                 int32_t* out, void* scratch,
                                 cudaStream_t stream);
