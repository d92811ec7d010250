// The record sort shared by K3/K8 (the batch's endpoints) and K5 (the
// batch's writes).
//
// A record is NV uint4s compared word by word as unsigned integers, so
// a caller that packs its key, its tie-breaks and a unique index into
// the words gets a total order. Pass 1 sorts tiles of THREADS * ITEMS
// records in shared memory: each thread sorts ITEMS records in
// registers (odd-even transposition), then runs of ITEMS, 2 * ITEMS,
// ... merge pairwise, each thread finding its outputs' merge path by a
// binary search. Then merge-path rounds double the sorted runs: a block
// writes CHUNK outputs of one pair of runs, found by one warp's split
// search in device memory and merged in shared memory. Every record
// moves once a level. Both passes are latency chains (a tile's merge
// levels run one after another in one block; a round is a split search,
// a chunk's load and a merge), so the shape trades tile size against
// rounds: 512-record tiles (256 threads x 2) and 512-output merge
// blocks. On the H100 at K5's 16,384 writes, tiles of 512 records and
// 5 rounds beat tiles of 1,024 (4 rounds) and 2,048 (3 rounds, at 256,
// 512 or 1,024 threads), which run on too few SMs with too long a
// chain (a diagnostic comparison, numbers not kept). The last pass
// hands each record and its sorted position to `place`.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace fdb {
namespace {

template <int NV>
struct Rec {
  uint4 v[NV];
};

__device__ __forceinline__ int cmp4(uint4 a, uint4 b) {
  if (a.x != b.x) return a.x < b.x ? -1 : 1;
  if (a.y != b.y) return a.y < b.y ? -1 : 1;
  if (a.z != b.z) return a.z < b.z ? -1 : 1;
  if (a.w != b.w) return a.w < b.w ? -1 : 1;
  return 0;
}

template <int NV>
__device__ __forceinline__ bool rec_less(const Rec<NV>& a, const Rec<NV>& b) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    int c = cmp4(a.v[i], b.v[i]);
    if (c) return c < 0;
  }
  return false;
}

__device__ __forceinline__ uint32_t word_of(uint4 v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// word k of a record
template <int NV>
__device__ __forceinline__ uint32_t rec_word(const Rec<NV>& r, int k) {
  uint32_t out = 0;
#pragma unroll
  for (int i = 0; i < NV; ++i)
    if (k / 4 == i) out = word_of(r.v[i], k % 4);
  return out;
}

// the padding record: after every record a caller builds (whose index
// word is never all ones)
template <int NV>
__device__ __forceinline__ Rec<NV> rec_max() {
  Rec<NV> r;
#pragma unroll
  for (int i = 0; i < NV; ++i) r.v[i] = make_uint4(FULL_MASK, FULL_MASK,
                                                   FULL_MASK, FULL_MASK);
  return r;
}

// uint4s per record of `words` words: 1, 2, 3, 4, 8, 16 or 32 (0 when
// wider than 128 words)
inline int rec_uint4s(int words) {
  static const int kNV[] = {1, 2, 3, 4, 8, 16, 32};
  int need = (words + 3) / 4;
  for (int nv : kNV)
    if (need <= nv) return nv;
  return 0;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

struct NoPlace {
  template <int NV>
  __device__ void operator()(const Rec<NV>&, int) const {}
};

template <int NV>
__device__ __forceinline__ void rec_cas(Rec<NV>& a, Rec<NV>& b) {
  if (rec_less(b, a)) {
    Rec<NV> t = a;
    a = b;
    b = t;
  }
}

// record i of a block's tile in shared memory: one uint4 of padding after
// each thread's run of ITEMS records, so the runs' stores hit every bank
template <int NV, int ITEMS>
__device__ __forceinline__ Rec<NV>& tile_at(uint4* sm, int i) {
  return *reinterpret_cast<Rec<NV>*>(sm + i * NV + i / ITEMS);
}

// pass 1: one tile of THREADS * ITEMS records (load(i) for i < n, the
// padding record after); `last` when the tile is the whole sort
template <int NV, int THREADS, int ITEMS, class Load, class Place>
__global__ void __launch_bounds__(THREADS)
    rec_block_sort_kernel(Load load, int n, Rec<NV>* out, int last,
                          Place place) {
  constexpr int tile = THREADS * ITEMS;
  extern __shared__ uint4 rec_sm[];
  const int base = blockIdx.x * tile, tid = threadIdx.x;
  for (int k = 0; k < ITEMS; ++k) {
    int i = k * THREADS + tid;
    tile_at<NV, ITEMS>(rec_sm, i) =
        base + i < n ? load(base + i) : rec_max<NV>();
  }
  __syncthreads();
  Rec<NV> r[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k)
    r[k] = tile_at<NV, ITEMS>(rec_sm, tid * ITEMS + k);
#pragma unroll
  for (int p = 0; p < ITEMS; ++p)
#pragma unroll
    for (int k = p & 1; k + 1 < ITEMS; k += 2) rec_cas(r[k], r[k + 1]);
  for (int w = ITEMS; w < tile; w <<= 1) {
    __syncthreads();
#pragma unroll
    for (int k = 0; k < ITEMS; ++k)
      tile_at<NV, ITEMS>(rec_sm, tid * ITEMS + k) = r[k];
    __syncthreads();
    const int d0 = tid * ITEMS, pair = d0 / (2 * w) * (2 * w), d = d0 - pair;
    int lo = max(0, d - w), hi = min(d, w);
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if (rec_less(tile_at<NV, ITEMS>(rec_sm, pair + mid),
                   tile_at<NV, ITEMS>(rec_sm, pair + w + d - 1 - mid)))
        lo = mid + 1;
      else
        hi = mid;
    }
    int ai = lo, bi = d - lo;
    Rec<NV> ha = tile_at<NV, ITEMS>(rec_sm, pair + min(ai, w - 1));
    Rec<NV> hb = tile_at<NV, ITEMS>(rec_sm, pair + w + min(bi, w - 1));
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      if (bi >= w || (ai < w && rec_less(ha, hb))) {
        r[k] = ha;
        if (++ai < w) ha = tile_at<NV, ITEMS>(rec_sm, pair + ai);
      } else {
        r[k] = hb;
        if (++bi < w) hb = tile_at<NV, ITEMS>(rec_sm, pair + w + bi);
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < ITEMS; ++k)
    tile_at<NV, ITEMS>(rec_sm, tid * ITEMS + k) = r[k];
  __syncthreads();
  for (int k = 0; k < ITEMS; ++k) {
    int i = k * THREADS + tid;
    if (base + i >= n) break;
    const Rec<NV>& rec = tile_at<NV, ITEMS>(rec_sm, i);
    out[base + i] = rec;
    if (last) place(rec, base + i);
  }
}

// the first m in [lo, hi) where `pred` (true up to some m, false from
// there on) is false, hi when none, found by one warp 32 probes at a
// time (every lane returns it)
template <class Pred>
__device__ int warp_partition_point(int lo, int hi, Pred pred, int lane) {
  while (hi - lo > 32) {
    int step = (hi - lo + 31) / 32;
    int m = lo + lane * step;
    int k = __popc(__ballot_sync(FULL_MASK, m < hi && pred(m)));
    if (k == 0) return lo;
    int mk = lo + k * step;
    lo += (k - 1) * step + 1;
    if (mk < hi) hi = mk;
  }
  int m = lo + lane;
  return lo + __popc(__ballot_sync(FULL_MASK, m < hi && pred(m)));
}

// merge path: the count of A's records among the first d of merge(A, B)
template <int NV>
__device__ int merge_split(const Rec<NV>* A, int la, const Rec<NV>* B,
                           int lb, int d, int lane) {
  return warp_partition_point(
      max(0, d - lb), min(d, la),
      [&](int m) { return rec_less(A[m], B[d - 1 - m]); }, lane);
}

// one merge round: sorted runs of `run` records pair up; a block writes
// CHUNK outputs of one pair (CHUNK <= the first tile: no block straddles
// two pairs), merged in shared memory
template <int NV, int THREADS, int CHUNK, class Place>
__global__ void __launch_bounds__(THREADS)
    rec_merge_kernel(const Rec<NV>* src, Rec<NV>* out, int n, int run,
                     int last, Place place) {
  constexpr int ITEMS = CHUNK / THREADS;
  extern __shared__ uint4 rec_sm[];
  Rec<NV>* s = reinterpret_cast<Rec<NV>*>(rec_sm);
  __shared__ int split[2];
  const int o0 = blockIdx.x * CHUNK, o1 = min(o0 + CHUNK, n);
  const int p0 = o0 / (2 * run) * (2 * run);
  const int la = min(run, n - p0), lb = max(0, min(run, n - p0 - run));
  const Rec<NV>* A = src + p0;
  const Rec<NV>* B = A + la;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 2) {
    int a = merge_split(A, la, B, lb, (warp ? o1 : o0) - p0, lane);
    if (lane == 0) split[warp] = a;
  }
  __syncthreads();
  const int a0 = split[0], b0 = o0 - p0 - a0;
  const int na = split[1] - a0, nb = o1 - o0 - na;
  for (int i = threadIdx.x; i < na + nb; i += blockDim.x)
    s[i] = i < na ? A[a0 + i] : B[b0 + i - na];
  __syncthreads();
  const Rec<NV>* sa = s;
  const Rec<NV>* sb = s + na;
  int d = threadIdx.x * ITEMS;
  if (d >= na + nb) return;
  int lo = max(0, d - nb), hi = min(d, na);
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (rec_less(sa[mid], sb[d - 1 - mid])) lo = mid + 1; else hi = mid;
  }
  int ai = lo, bi = d - lo;
  for (int k = 0; k < ITEMS && d + k < na + nb; ++k) {
    bool take_a = bi >= nb || (ai < na && rec_less(sa[ai], sb[bi]));
    Rec<NV> r = take_a ? sa[ai++] : sb[bi++];
    out[o0 + d + k] = r;
    if (last) place(r, o0 + d + k);
  }
}

// Sort load(0 .. n-1) (n >= 1) through the buffers a and b (n records
// each); *sorted is the one that holds the result. Tiles of 512 records
// and merge blocks of 512 outputs; 256 of each for records of 32 uint4s,
// which would overflow shared memory.
template <int NV, class Load, class Place>
cudaError_t rec_sort(Load load, Place place, int n, uint4* buf_a,
                     uint4* buf_b, const uint4** sorted, cudaStream_t st) {
  constexpr int THREADS = 256, MTHREADS = 128;
  constexpr int ITEMS = NV <= 16 ? 2 : 1, CHUNK = NV <= 16 ? 512 : 256;
  constexpr int tile = THREADS * ITEMS;
  Rec<NV>* a = reinterpret_cast<Rec<NV>*>(buf_a);
  Rec<NV>* b = reinterpret_cast<Rec<NV>*>(buf_b);
  static_assert(CHUNK <= tile && CHUNK % MTHREADS == 0 && MTHREADS >= 64,
                "a merge block covers one pair and has two split warps");
  size_t smem = ((size_t)tile * NV + THREADS) * sizeof(uint4);
  cudaError_t e = allow_smem(
      rec_block_sort_kernel<NV, THREADS, ITEMS, Load, Place>, smem);
  if (e != cudaSuccess) return e;
  rec_block_sort_kernel<NV, THREADS, ITEMS, Load, Place>
      <<<blocks_for(n, tile), THREADS, smem, st>>>(load, n, a, n <= tile,
                                                   place);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  smem = (size_t)CHUNK * sizeof(Rec<NV>);
  e = allow_smem(rec_merge_kernel<NV, MTHREADS, CHUNK, Place>, smem);
  if (e != cudaSuccess) return e;
  for (int run = tile; run < n; run <<= 1) {
    rec_merge_kernel<NV, MTHREADS, CHUNK, Place>
        <<<blocks_for(n, CHUNK), MTHREADS, smem, st>>>(a, b, n, run,
                                                       2 * run >= n, place);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    Rec<NV>* t = a;
    a = b;
    b = t;
  }
  *sorted = reinterpret_cast<const uint4*>(a);
  return cudaSuccess;
}

// f(std::integral_constant<int, NV>{}) for records of `words` words
// (ERR_BAD_ARGS past 128 words)
template <class F>
int with_rec_uint4s(int words, F&& f) {
  switch (rec_uint4s(words)) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
  }
  return ERR_BAD_ARGS;
}

}  // namespace
}  // namespace fdb
