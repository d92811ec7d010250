// K8e and K8f: the key-range sharded step with one shard a device
// (fdb_resolve_shard_ext[_packed], fdb_resolve_shard_finish[_packed]).
//
// Replace the same TPU program as K8 (foundationdb_tpu/parallel/
// sharded_resolver.py:36 _clip_and_resolve_packed and :77
// _clip_and_resolve, with the cross-shard combine of ops/conflict_kernel
// .py:182-185) where the reference runs it: one shard on each device of
// a mesh, combined by psum. K8 (resolve.cu) is split at that combine.
// K8e is its phase 1 for ONE shard, into the shard's [R] external read
// flags; the caller gathers every device's flags into a [D, R] buffer
// on each device, and K8f is the rest of the step on it. Every device
// reaches the same verdicts from the same feed and the D rows, with no
// exchange but the flags (one all-gather of R bytes a device a batch,
// where the reference needs a psum each fixpoint round), because the
// overlap that the fixpoint reads does not depend on the shard: a read
// and a write clipped to shard s are both valid and overlap there iff
// max(rb, wb, lo_s) < min(re, we, hi_s), which holds for some s iff the
// unclipped ranges are non-empty and overlap (resolve.cu, K8's note).
// K8f reads the segment starts K8e left in the scratch they share.
//
// K8e, ONE cooperative launch with one grid-wide barrier: the bounds
// search of every read clipped to the shard in registers (K7's clip,
// step.cuh read_bounds) on some blocks, while the others take K1's
// segment starts over rtxn (K1's probe sequence, searchsorted.cu) and
// K2's summary of the shard's HV (rmq.cuh, a block a super-block); then
// K2's query (a short range, as every point read, by its own thread; a
// long one by its warp over the summary, which the barrier has
// completed) and the flags.
//
// K8f, three launches, each cooperative:
//   1. the endpoint sort (sort.cuh rec_sort_coop: the tile pass and
//      every merge round in one launch, a grid-wide barrier between
//      rounds), the batch's N = 2R + 2Wr endpoints as K3's records
//      (key, end-before-begin, index): a total order, so every endpoint
//      has a distinct sorted position; the last pass writes each
//      endpoint's position and each position's endpoint;
//   2. the fixpoint without the R x Wr overlap matrix. In rank space a
//      valid read [r_lo, r_hi) and a valid write [w_lo, w_hi) (both
//      non-empty: an empty or inverted range counts invalid, as every
//      shard's clip counts it) overlap, w_lo < r_hi && r_lo < w_hi (the
//      reference's :292), iff (a) r_lo < w_lo < r_hi (the write begins
//      inside the read) or (b) w_lo < r_lo < w_hi (the write covers the
//      read's begin): the positions are distinct, so w_lo > r_lo gives
//      r_lo < w_hi from w_lo < w_hi, and w_lo < r_lo gives w_lo < r_hi
//      from r_lo < r_hi. A read hits in a round iff the least wtxn over
//      the ALIVE writes (valid, non-empty, transaction not conflicted)
//      of kind (a) or (b) is below its rtxn. Each round rebuilds two
//      integer trees over the NP >= N leaf positions from the alive
//      writes: a range-min tree, leaf w_lo = wtxn, built bottom up (a
//      block folds a chunk of 2,048 leaves, 8 a thread in registers,
//      then by warp shuffles, and writes the chunk's subtree), queried
//      over (r_lo, r_hi); and a stabbing-min tree, each alive write an
//      atomicMin of its wtxn on the canonical nodes of (w_lo, w_hi)
//      (the nodes nearest the root into the block's copy in shared
//      memory first, then one atomic a node a block, so that wide
//      writes do not serialise on them), queried along r_lo's path to
//      the root. After the barrier every block copies both trees' top
//      nodes into its shared memory (folding the range-min tree's
//      above the chunk roots), and a query issues its loads of the
//      levels under them together. Integer min does not depend on the
//      atomics' order, so the verdicts are deterministic and equal the
//      matrix's: the same set of writes, the same compare. The trees
//      take 7 NP int32 (1.75 MiB at N = 65,536) against the matrix's R
//      x Wr bits (32 MiB at 16,384 x 16,384) written and then read every
//      round. A round is two phases and two grid-wide barriers: (1) the
//      change test of the last round's verdicts, the trees of the
//      current ones (the chunks on the first blocks, the writes on the
//      rest), the next verdicts set to the base; (2) the queries, a hit
//      setting its transaction's next verdict. The base (ext OR too-old
//      over the D rows, the pad entry T at 1), the per-transaction OR
//      over the rs segments and the cap of T + 2 rounds are K3's
//      fixpoint's; attribution is the same query on the final verdicts,
//      OR'd with the D external rows (the reference's :341);
//   3. the shard's merge in one launch, its phases between grid-wide
//      barriers, every block striding over the tiles and folding the
//      tile aggregates before its tile itself (no one-block scans): the
//      survivors' boundaries out of the sorted endpoints (each write
//      clipped to the shard, kept where the clip is non-empty), each
//      boundary's place among the history rows (a row search), then
//      each tile's merged sequence by a search over those places, read
//      by the same threads for the covering version and the coverage,
//      keep + GC (the covering versions and the keep flags in one
//      pass), compaction and the +inf / VDEAD tail; the partition, the
//      first cover scan and the compaction are step.cuh's tile
//      functions, which K3 and K8 run one tile a block.
// Bound: bytes. K8e reads the shard's live history rows and the feed's
// reads once and writes R flags; K8f reads the live rows, the feed and
// the D x R flags once and writes the [cap] state, the verdicts and the
// count once (chip_smoke.py computes both from the run's live rows).
// Against that, the sort's rounds and the fixpoint's rounds are latency
// chains of grid-wide barriers, and the merge reads the merged rows in
// several passes.

#include <cooperative_groups.h>

#include <climits>

#include "common.cuh"
#include "rmq.cuh"
#include "sort.cuh"
#include "step.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int EXT_THREADS = 128;
constexpr int FX_THREADS = 256;
constexpr int FX_ITEMS = 8;
constexpr int FX_CHUNK = FX_THREADS * FX_ITEMS;  // leaves a block folds
// a query reads the trees' first FX_TOP (or 2 NC) nodes, the levels
// nearest the root, out of its block's shared memory, and the at most
// FX_LEVELS levels under them from L2
constexpr int FX_TOP = 2048;
constexpr int FX_LEVELS = 12;
constexpr int32_t NONE = INT_MAX;                // no alive write

// ---- scratch ----------------------------------------------------------------
// One a device, shared by the K8e and the K8f of a feed: K8e leaves the
// segment starts in rs.
struct ShardScratch {
  int32_t *rs, *lo, *hi, *bmax, *smax;
  uint8_t* rok;
  uint4 *rec_a, *rec_b;
  Pos pos;
  int32_t* at;
  uint8_t *base, *cfinal, *keepf;
  int32_t *c0, *c1, *seg, *leaf, *rm, *st0, *st1;
  int* flags;
  uint32_t* ins_k;
  int32_t *ins_tie, *pb, *src, *mv;
  int32_t *agg_surv, *agg_max, *agg_sum, *agg_keep;
};

// leaf positions of the fixpoint's trees: a power of two >= N, at least
// one chunk
int leaves_for(int n) {
  int np = FX_CHUNK;
  while (np < n) np <<= 1;
  return np;
}

int supers_for(int cap) {
  return (cap / fdb::RMQ_BLOCK + fdb::RMQ_SUPER - 1) / fdb::RMQ_SUPER;
}

size_t carve(ShardScratch& s, char* base, int cap, int T, int R, int Wr,
             int width) {
  fdb::Carver c{base, 0};
  const int n = 2 * R + 2 * Wr, np = leaves_for(n);
  const int n_s = 2 * Wr, mtot = cap + n_s;
  const int n_tiles = fdb::blocks_for(mtot, TILE);
  s.rs = c.take<int32_t>(T + 2);
  s.lo = c.take<int32_t>(R);
  s.hi = c.take<int32_t>(R);
  s.rok = c.take<uint8_t>(R);
  s.bmax = c.take<int32_t>(cap / fdb::RMQ_BLOCK);
  s.smax = c.take<int32_t>(supers_for(cap));
  s.rec_a = c.take<uint4>((size_t)n * rec_nv(width));
  s.rec_b = c.take<uint4>((size_t)n * rec_nv(width));
  s.pos.r_lo = c.take<int32_t>(R);
  s.pos.r_hi = c.take<int32_t>(R);
  s.pos.w_lo = c.take<int32_t>(Wr);
  s.pos.w_hi = c.take<int32_t>(Wr);
  s.at = c.take<int32_t>(n);
  s.base = c.take<uint8_t>(T + 1);
  s.cfinal = c.take<uint8_t>(T + 1);
  s.c0 = c.take<int32_t>(T + 1);
  s.c1 = c.take<int32_t>(T + 1);
  s.flags = c.take<int>(4);
  s.seg = c.take<int32_t>(R);
  s.leaf = c.take<int32_t>(np);
  s.rm = c.take<int32_t>(2 * (size_t)np);
  s.st0 = c.take<int32_t>(2 * (size_t)np);
  s.st1 = c.take<int32_t>(2 * (size_t)np);
  s.ins_k = c.take<uint32_t>((size_t)n_s * width);
  s.ins_tie = c.take<int32_t>(n_s);
  s.pb = c.take<int32_t>(n_s);
  s.src = c.take<int32_t>(mtot);
  s.mv = c.take<int32_t>(mtot);
  s.keepf = c.take<uint8_t>(mtot);
  s.agg_surv = c.take<int32_t>(fdb::blocks_for(n, SURV_TILE));
  s.agg_max = c.take<int32_t>(n_tiles);
  s.agg_sum = c.take<int32_t>(n_tiles);
  s.agg_keep = c.take<int32_t>(n_tiles);
  return c.off;
}

int carve_checked(ShardScratch& s, const In& in, void* scratch,
                  size_t scratch_bytes) {
  if (carve(s, nullptr, in.cap, in.T, in.R, in.Wr, in.width) > scratch_bytes)
    return fdb::ERR_SCRATCH;
  carve(s, static_cast<char*>(scratch), in.cap, in.T, in.R, in.Wr, in.width);
  return 0;
}

bool bad_shape(const In& in) {
  return in.cap < fdb::RMQ_BLOCK || (in.cap & (in.cap - 1)) || in.T < 1 ||
         in.R < 1 || (in.R & (in.R - 1)) || in.Wr < 1 || in.width < 1 ||
         !rec_nv(in.width);
}

// data another block wrote in this launch, read from L2
__device__ __forceinline__ int32_t ld(const int32_t* p) { return __ldcg(p); }

// ---- K8e --------------------------------------------------------------------
struct ExtArgs {
  In in;
  const uint32_t* low;
  const uint32_t* high;
  int32_t *rs, *lo, *hi, *bmax, *smax;
  uint8_t *rok, *ext_out;
  int log_r, nb, nsb, read_blocks;
};

// #(table[i] < x) over a table of 2^logn entries, by K1's probe sequence
// (searchsorted.cu, right = 0): the same answer on any table
__device__ int count_less(const int32_t* table, int logn, int x) {
  const int n = 1 << logn;
  int pos = 0;
  for (int lv = 0; lv < logn; ++lv) {
    const int step = n >> (lv + 1);
    pos += table[pos + step - 1] < x ? step : 0;
  }
  return pos + (table[pos] < x ? 1 : 0);
}

__global__ void __launch_bounds__(EXT_THREADS) shard_ext_kernel(ExtArgs a) {
  cg::grid_group grid = cg::this_grid();
  const In& in = a.in;
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthr = gridDim.x * blockDim.x;
  // the bounds search on the first read_blocks blocks, the segment
  // starts and the summary on the rest, so that no thread runs two of
  // these latency chains one after the other (all of them on every
  // block where the grid holds no more)
  const int rb = min((int)gridDim.x, a.read_blocks);
  const bool split = (int)gridDim.x > rb;
  if (!split || (int)blockIdx.x < rb) {
    for (int i = gtid; i < in.R; i += rb * EXT_THREADS)
      read_bounds<true>(in, in.hk, a.low, a.high, 0, i, a.lo[i], a.hi[i],
                        a.rok[i]);
  }
  if (!split || (int)blockIdx.x >= rb) {
    const int b0 = split ? blockIdx.x - rb : blockIdx.x;
    const int nbk = split ? gridDim.x - rb : gridDim.x;
    for (int t = b0 * EXT_THREADS + threadIdx.x; t < in.T + 2;
         t += nbk * EXT_THREADS)
      a.rs[t] = count_less(in.rtxn, a.log_r, t);
    for (int sb = b0; sb < a.nsb; sb += nbk) {
      fdb::rmq_summarize<EXT_THREADS / 32>(in.hv, a.nb, sb, a.bmax, a.smax);
      __syncthreads();
    }
  }
  grid.sync();
  // K2's query (range_max.cu rmq_query_kernel) and the flags, a warp's
  // 32 reads at a time so its lanes take the long ranges together
  const int lane = threadIdx.x & 31, gwarp = gtid >> 5, nwarps = nthr >> 5;
  for (int b0 = gwarp * 32; b0 < in.R; b0 += nwarps * 32) {
    const int i = b0 + lane;
    const bool live = i < in.R;
    const int lo = live ? a.lo[i] : 0, hi = live ? a.hi[i] : 0;
    const bool any = hi > lo;
    const int x = min(max(lo, 0), in.cap - 1);
    const int y = min(max(hi - 1, 0), in.cap - 1);
    const bool is_long = any && y - x >= fdb::RMQ_SHORT;
    int32_t m = fdb::VDEAD;
    if (any && !is_long)
      for (int j = x; j <= y; ++j) m = max(m, in.hv[j]);
    for (unsigned longs = __ballot_sync(fdb::FULL_MASK, is_long); longs;
         longs &= longs - 1) {
      const int src = __ffs(longs) - 1;
      const int la = __shfl_sync(fdb::FULL_MASK, x, src);
      const int lb = __shfl_sync(fdb::FULL_MASK, y, src);
      const int32_t r =
          fdb::warp_range_max(in.hv, a.bmax, a.smax, la, lb, lane);
      if (lane == src) m = r;
    }
    if (live) {
      const int rt = in.rtxn[i];
      const int32_t s = (rt >= 0 && rt < in.T) ? in.snap[rt]
                                               : fdb::SNAP_CLAMP;
      a.ext_out[i] = a.rok[i] && m > s;
    }
  }
}

// ---- K8f 1: the endpoint sort's last pass -----------------------------------
// each endpoint's sorted position, and each position's endpoint
template <int NV>
struct ShardPlace {
  In in;
  Pos P;
  int32_t* at;
  __device__ void operator()(const fdb::Rec<NV>& rec, int pos) const {
    const int g = (int)(fdb::rec_word(rec, in.width) & ~BEGIN_BIT);
    const int R = in.R, Wr = in.Wr;
    at[pos] = g;
    if (g < R) P.r_lo[g] = pos;
    else if (g < R + Wr) P.w_lo[g - R] = pos;
    else if (g < R + 2 * Wr) P.w_hi[g - R - Wr] = pos;
    else P.r_hi[g - R - 2 * Wr] = pos;
  }
};

// ---- K8f 2: the fixpoint ----------------------------------------------------
struct Fx {
  In in;
  Pos P;
  const int32_t* at;       // [N] the endpoint at each sorted position
  const int32_t* rs;       // [T + 2] the reads' segment starts
  const uint8_t* ext_all;  // [D, R] every shard's external read flags
  int D, attribute, N, NP, NC, top_n;
  uint8_t* base;           // [T + 1] ext | too-old, the pad entry 1
  int32_t *c0, *c1;        // [T + 1] verdicts, this round's and the next
  int* flags;              // [3] "changed", one a round, triple-buffered
  int32_t* seg;            // [R] a valid read's transaction, or -1
  int32_t* leaf;           // [NP] wtxn of the valid write beginning there
  int32_t* rm;             // [2 NP] the range-min tree (nodes >= NC)
  int32_t *st0, *st1;      // [2 NP] the stabbing-min trees
  uint8_t *cfinal, *conflict_out, *read_hit_out;
};

__device__ __forceinline__ bool read_ok(const Fx& f, int r) {
  return fdb::flag_at(f.in.rvalid, r, f.in.flag_bytes) &&
         f.P.r_lo[r] < f.P.r_hi[r];
}

__device__ __forceinline__ bool alive(const Fx& f, const int32_t* c,
                                      int32_t txn) {
  return ld(c + min(max(txn, 0), f.in.T)) == 0;
}

// the range-min tree of the verdicts `c`, chunk by chunk: a block folds
// FX_CHUNK leaves (local node k, leaf i at FX_CHUNK + i) and writes the
// chunk's subtree, local node k at level lk = 2^floor(log2 k) to global
// node lk * (NC + chunk) + k - lk. A thread folds its FX_ITEMS
// consecutive leaves in registers, a warp its threads' nodes by
// shuffles, and the first warp the block's warps' nodes out of `sm`.
__device__ __forceinline__ void put_node(const Fx& f, int ch, int k,
                                         int32_t v) {
  const int lk = 1 << (31 - __clz(k));
  f.rm[(size_t)lk * (f.NC + ch) + (k - lk)] = v;
}

__device__ void build_range_min(const Fx& f, const int32_t* c, int32_t* sm) {
  static_assert(FX_ITEMS == 8 && FX_THREADS == 256, "the fold's levels");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int ch = blockIdx.x; ch < f.NC; ch += gridDim.x) {
    const int i0 = tid * FX_ITEMS;
    const int4* src = reinterpret_cast<const int4*>(f.leaf + ch * FX_CHUNK +
                                                    i0);
    const int4 x = src[0], y = src[1];
    int32_t v[FX_ITEMS] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
#pragma unroll
    for (int j = 0; j < FX_ITEMS; ++j)
      if (v[j] != NONE && !alive(f, c, v[j])) v[j] = NONE;
#pragma unroll
    for (int j = 0; j < FX_ITEMS; ++j) put_node(f, ch, FX_CHUNK + i0 + j, v[j]);
    // levels of 4, 2 and 1 nodes a thread
#pragma unroll
    for (int n = FX_ITEMS / 2, lvl = FX_CHUNK / 2; n >= 1; n >>= 1, lvl >>= 1)
#pragma unroll
      for (int j = 0; j < n; ++j) {
        v[j] = min(v[2 * j], v[2 * j + 1]);
        put_node(f, ch, lvl + tid * n + j, v[j]);
      }
    // one node a thread at level FX_THREADS; then 5 levels in the warp
    int32_t m = v[0];
#pragma unroll
    for (int d = 1, lvl = FX_THREADS / 2; d < 32; d <<= 1, lvl >>= 1) {
      m = min(m, __shfl_down_sync(fdb::FULL_MASK, m, d));
      if ((lane & (2 * d - 1)) == 0) put_node(f, ch, lvl + tid / (2 * d), m);
    }
    if (lane == 0) sm[warp] = m;
    __syncthreads();
    if (warp == 0) {
      m = lane < FX_THREADS / 32 ? sm[lane] : NONE;
#pragma unroll
      for (int d = 1, lvl = FX_THREADS / 64; d < FX_THREADS / 32;
           d <<= 1, lvl >>= 1) {
        m = min(m, __shfl_down_sync(fdb::FULL_MASK, m, d));
        if ((lane & (2 * d - 1)) == 0 && lane < FX_THREADS / 32)
          put_node(f, ch, lvl + lane / (2 * d), m);
      }
    }
    __syncthreads();
  }
}

// every block's copies of the trees' nodes [1, top_n): the range-min
// tree's from NC on loaded and [1, NC) folded from the chunk roots, the
// stabbing tree's loaded (after a grid-wide barrier: other blocks wrote
// them)
__device__ void build_tops(const Fx& f, const int32_t* st, int32_t* rm_top,
                           int32_t* st_top) {
#pragma unroll 8
  for (int k = threadIdx.x; k < f.top_n; k += FX_THREADS) {
    rm_top[k] = k >= f.NC ? ld(f.rm + k) : NONE;
    st_top[k] = k >= 1 ? ld(st + k) : NONE;
  }
  __syncthreads();
  for (int L = f.NC / 2; L >= 1; L >>= 1) {
    for (int k = threadIdx.x; k < L; k += blockDim.x)
      rm_top[L + k] = min(rm_top[2 * (L + k)], rm_top[2 * (L + k) + 1]);
    __syncthreads();
  }
}

// every alive write's wtxn onto the canonical nodes of the open range
// (w_lo, w_hi) of the stabbing tree `st`, atomicMin: a node under top_n
// in the tree, a top one in the block's copy `top` (shared memory)
// first, each of those then folded into the tree with one atomic a node
// a block, so that a batch of wide writes does not serialise on the
// few top nodes. The blocks from `first` on take the writes (those
// before it fold the range-min tree's chunks meanwhile).
__device__ void stab_writes(const Fx& f, const int32_t* c, int32_t* st,
                            int32_t* top, int first) {
  const In& in = f.in;
  if ((int)blockIdx.x < first) return;
  for (int k = threadIdx.x; k < f.top_n; k += FX_THREADS) top[k] = NONE;
  __syncthreads();
  for (int w = (blockIdx.x - first) * FX_THREADS + threadIdx.x; w < in.Wr;
       w += (gridDim.x - first) * FX_THREADS) {
    if (!fdb::flag_at(in.wvalid, w, in.flag_bytes)) continue;
    const int lo = f.P.w_lo[w], hi = f.P.w_hi[w];
    const int32_t t = in.wtxn[w];
    if (lo >= hi || !alive(f, c, t)) continue;
    for (int a = lo + 1 + f.NP, b = hi + f.NP; a < b; a >>= 1, b >>= 1) {
      if (a & 1) {
        atomicMin(a < f.top_n ? top + a : st + a, t);
        ++a;
      }
      if (b & 1) {
        --b;
        atomicMin(b < f.top_n ? top + b : st + b, t);
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < f.top_n; k += FX_THREADS)
    if (top[k] != NONE) atomicMin(st + k, top[k]);
}

// the least wtxn of an alive write that overlaps read r: (a) one that
// begins in (r_lo, r_hi), a range-min over those leaves, and (b) one
// that covers r_lo, the min along its path to the root. The walks do
// not depend on the values: the levels at and above top_n come from
// the block's copies, and the loads of the FX_LEVELS levels under them
// are all issued before any is used.
__device__ int32_t read_min(const Fx& f, const int32_t* rm_top,
                            const int32_t* st_top, const int32_t* st,
                            int r) {
  const int lo = f.P.r_lo[r], hi = f.P.r_hi[r];
  int a = lo + 1 + f.NP, b = hi + f.NP, k = lo + f.NP;
  int32_t v[3 * FX_LEVELS];
#pragma unroll
  for (int j = 0; j < FX_LEVELS; ++j) {
    const bool below = (f.NP >> j) >= f.top_n;
    int na = -1, nb = -1;
    if (below && a < b) {
      if (a & 1) na = a++;
      if (b & 1) nb = --b;
    }
    v[3 * j] = na >= 0 ? ld(f.rm + na) : NONE;
    v[3 * j + 1] = nb >= 0 ? ld(f.rm + nb) : NONE;
    v[3 * j + 2] = below ? ld(st + (k >> j)) : NONE;
    if (below) {
      a >>= 1;
      b >>= 1;
    }
  }
  int32_t m = NONE;
#pragma unroll
  for (int j = 0; j < 3 * FX_LEVELS; ++j) m = min(m, v[j]);
  for (; a < b; a >>= 1, b >>= 1) {
    if (a & 1) m = min(m, rm_top[a++]);
    if (b & 1) m = min(m, rm_top[--b]);
  }
  while (k >= f.top_n) k >>= 1;
  for (; k >= 1; k >>= 1) m = min(m, st_top[k]);
  return m;
}

__global__ void __launch_bounds__(FX_THREADS) shard_fix_kernel(Fx f) {
  // [32] a chunk's warp nodes, then the trees' tops, [top_n] each
  extern __shared__ int32_t fx_sm[];
  int32_t* rm_top = fx_sm + 32;
  int32_t* st_top = rm_top + f.top_n;
  cg::grid_group grid = cg::this_grid();
  const In& in = f.in;
  const int T = in.T, R = in.R;
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthr = gridDim.x * blockDim.x;
  // the base verdicts, and each valid read's transaction: the segments
  // [rs[t], rs[t + 1]) tile [rs[0], rs[T]) (rs is non-decreasing), and a
  // read outside them is none's
  for (int t = gtid; t <= T; t += nthr) {
    uint8_t v = 1;
    if (t < T) {
      bool any = false;
      for (int r = f.rs[t]; r < f.rs[t + 1]; ++r) {
        for (int k = 0; k < f.D; ++k)
          any |= f.ext_all[(size_t)k * R + r] != 0;
        f.seg[r] = read_ok(f, r) ? t : -1;
      }
      v = any || fdb::flag_at(in.too_old, t, in.flag_bytes);
    }
    f.base[t] = v;
    f.c0[t] = v;
  }
  for (int r = gtid; r < R; r += nthr)
    if (r < f.rs[0] || r >= f.rs[T]) f.seg[r] = -1;
  for (int p = gtid; p < f.NP; p += nthr) {
    const int w = (p < f.N ? f.at[p] : -1) - R;
    f.leaf[p] = w >= 0 && w < in.Wr &&
                        fdb::flag_at(in.wvalid, w, in.flag_bytes) &&
                        f.P.w_lo[w] < f.P.w_hi[w]
                    ? in.wtxn[w]
                    : NONE;
  }
  for (int q = gtid; q < 2 * f.NP; q += nthr) {
    f.st0[q] = NONE;
    f.st1[q] = NONE;
  }
  if (gtid < 3) f.flags[gtid] = 0;
  grid.sync();
  int32_t *cur = f.c0, *nxt = f.c1, *sc = f.st0, *sn = f.st1;
  for (int i = 0;; ++i) {
    // (1) did round i - 1 change the verdicts; the trees of cur; nxt =
    // base; the other stabbing tree cleared for round i + 1
    if (gtid == 0) f.flags[(i + 1) % 3] = 0;
    for (int t = gtid; t <= T; t += nthr) {
      if (i > 0 && t < T && ld(nxt + t) != ld(cur + t)) f.flags[i % 3] = 1;
      nxt[t] = f.base[t];
    }
    build_range_min(f, cur, fx_sm);
    stab_writes(f, cur, sc, st_top, (int)gridDim.x > f.NC ? f.NC : 0);
    for (int q = gtid; q < 2 * f.NP; q += nthr) sn[q] = NONE;
    grid.sync();
    // at most T+2 applications of the map, as the reference's loop
    if (i > 0 && (!ld(f.flags + i % 3) || i >= T + 2)) break;
    build_tops(f, sc, rm_top, st_top);
    // (2) a read that an alive write of an earlier transaction overlaps
    // conflicts its transaction, unless the base already does
    for (int r = gtid; r < R; r += nthr) {
      const int t = f.seg[r];
      if (t < 0) continue;
      const int32_t m = read_min(f, rm_top, st_top, sc, r);
      if (!f.base[t] && m < in.rtxn[r]) nxt[t] = 1;
    }
    grid.sync();
    int32_t* tmp = cur;
    cur = nxt;
    nxt = tmp;
    tmp = sc;
    sc = sn;
    sn = tmp;
  }
  build_tops(f, sc, rm_top, st_top);
  for (int t = gtid; t <= T; t += nthr) {
    const uint8_t v = ld(cur + t) != 0;
    f.cfinal[t] = v;
    if (t < T) f.conflict_out[t] = v;
  }
  if (!f.attribute) return;
  for (int r = gtid; r < R; r += nthr) {
    bool h = read_ok(f, r) &&
             read_min(f, rm_top, st_top, sc, r) < in.rtxn[r];
    for (int k = 0; k < f.D; ++k) h |= f.ext_all[(size_t)k * R + r] != 0;
    f.read_hit_out[r] = h;
  }
}

// ---- K8f 3: the merge -------------------------------------------------------
struct Mg {
  In in;
  Part pt;
  Merged m;
  uint32_t* ins_k;
  int32_t *ins_tie, *pb, *src, *mv, *agg_surv, *agg_max, *agg_sum, *agg_keep;
  uint8_t* keepf;
  int n_pt, n_tiles;
  uint32_t* hk_out;
  int32_t *hv_out, *count_out;
};

// the sum (or the max, from 0) of a[0..n) by the whole block
template <bool MAX>
__device__ int block_fold(const int32_t* a, int n) {
  int v = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    v = MAX ? max(v, a[i]) : v + a[i];
  int tot;
  fdb::block_excl_scan<MAX>(v, tot);
  return tot;
}

// src for tile `bx` of the merged sequence (TILE positions from P0):
// boundary j sits at pb[j] = j + ub[j], strictly increasing in j, and a
// position that no boundary takes holds history row p - #(pb[j] < p).
// Two warps find the boundaries inside the tile, [j0, j1), 32 probes a
// step; their places go to shared memory `sm` [TILE], where each thread
// searches for its SCAN_ITEMS consecutive positions (those that
// cover_tile_reduce gives it).
__device__ void merged_src(const int32_t* pb, int n_s, int cap, int mtot,
                           int bx, int32_t* sm, int32_t* src) {
  __shared__ int bounds[2];
  const int P0 = bx * TILE, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < 2) {
    const int edge = P0 + warp * TILE;
    const int j = fdb::warp_partition_point(
        0, n_s, [&](int q) { return pb[q] < edge; }, lane);
    if (lane == 0) bounds[warp] = j;
  }
  __syncthreads();
  const int j0 = bounds[0], cnt = bounds[1] - j0;
  for (int q = threadIdx.x; q < cnt; q += SCAN_THREADS) sm[q] = pb[j0 + q];
  __syncthreads();
  const int p0 = P0 + threadIdx.x * SCAN_ITEMS;
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const int p = p0 + k;
    if (p >= mtot) break;
    int lo = 0, hi = cnt;   // #(sm[q] < p)
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (sm[mid] < p) lo = mid + 1; else hi = mid;
    }
    src[p] = lo < cnt && sm[lo] == p ? cap + j0 + lo : p - j0 - lo;
  }
  __syncthreads();
}

__device__ bool row_inf(const fdb::Row& r, int width) {
  bool inf = true;
#pragma unroll
  for (int j = 0; j < fdb::ROW_CW; ++j)
    inf &= j >= width || r.w[j] == fdb::INF_WORD;
  for (int w = fdb::ROW_CW; w < width && inf; ++w)
    inf = r.p[w] == fdb::INF_WORD;
  return inf;
}

// cover_tile_apply and keep_tile in one pass over tile `bx`: a thread's
// SCAN_ITEMS consecutive rows take their covering versions (into mv) and
// their keep flags (into keepf), step.cuh keep_rule; the row
// before its first is the state of the exclusive scans, so no row's
// version is read back, and the keys of rows base - 1 .. base +
// SCAN_ITEMS are loaded once each (common.cuh load_row), each compared
// with the next. Returns the tile's kept rows (every thread).
__device__ int cover_keep_tile(const Merged& m, int bx, int pre_max,
                               int pre_sum, int32_t commit, int32_t oldest2,
                               int32_t* mv, uint8_t* keepf) {
  const int base = bx * TILE + threadIdx.x * SCAN_ITEMS;
  int cand[SCAN_ITEMS], d[SCAN_ITEMS];
  int tmax = 0, tsum = 0;
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    int p = base + k;
    cand[k] = 0;
    d[k] = 0;
    if (p < m.mtot) {
      int tie = m.tie(p);
      if (tie < 4) cand[k] = p; else d[k] = tie - 5;
    }
    tmax = max(tmax, cand[k]);
    tsum += d[k];
  }
  int totm, tots;
  int runm = max(pre_max, fdb::block_excl_scan<true>(tmax, totm));
  int runs = pre_sum + fdb::block_excl_scan<false>(tsum, tots);
  int32_t v[SCAN_ITEMS + 1];
  v[0] = covering(m, runm, runs, commit);   // row base - 1
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    runm = max(runm, cand[k]);
    runs += d[k];
    v[k + 1] = covering(m, runm, runs, commit);
  }
  // same[i]: row base + i - 1 has row base + i's key, inf[i]: row base
  // + i is the +inf row (rows past the sequence's ends stand in as its
  // first and last)
  bool same[SCAN_ITEMS + 1], inf[SCAN_ITEMS + 1];
  fdb::Row prev =
      fdb::load_row(m.key(min(max(base - 1, 0), m.mtot - 1)), m.width);
#pragma unroll
  for (int i = 0; i <= SCAN_ITEMS; ++i) {
    const fdb::Row cur =
        fdb::load_row(m.key(min(base + i, m.mtot - 1)), m.width);
    same[i] = fdb::cmp_rows(prev, cur, m.width) == 0;
    inf[i] = row_inf(cur, m.width);
    prev = cur;
  }
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    const int p = base + k;
    if (p >= m.mtot) continue;
    mv[p] = v[k + 1];
    const bool kept = keep_rule(p == m.mtot - 1 || !same[k + 1],
                                p > 0 && !same[k], v[k + 1], v[k], inf[k],
                                oldest2);
    keepf[p] = kept;
    cnt += kept;
  }
  int tot;
  fdb::block_excl_scan<false>(cnt, tot);
  return tot;
}

__global__ void __launch_bounds__(SCAN_THREADS) shard_merge_kernel(Mg g) {
  __shared__ int32_t sm[TILE];
  cg::grid_group grid = cg::this_grid();
  const In& in = g.in;
  const int n_s = 2 * in.Wr, cap = in.cap, width = in.width;
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthr = gridDim.x * blockDim.x;
  // the survivors' boundaries, clipped to the shard: per tile of the
  // sorted endpoints, then placed in sorted order, +inf rows after
  for (int t = blockIdx.x; t < g.n_pt; t += gridDim.x) {
    const int tot = part_count_tile<true>(in, g.pt, t, 0);
    if (threadIdx.x == 0) g.agg_surv[t] = tot;
  }
  grid.sync();
  const int total = block_fold<false>(g.agg_surv, g.n_pt);
  for (int t = blockIdx.x; t < g.n_pt; t += gridDim.x)
    part_place_tile<true>(in, g.pt, t, 0, block_fold<false>(g.agg_surv, t),
                          g.ins_k, g.ins_tie);
  for (int j = total + gtid; j < n_s; j += nthr) {
    for (int w = 0; w < width; ++w)
      g.ins_k[(size_t)j * width + w] = fdb::INF_WORD;
    g.ins_tie[j] = 1;
  }
  grid.sync();
  // merged with the history rows: each boundary's place (resolve.cu
  // merge_ins_kernel's count of history rows <= it, plus its index), then
  // each tile's sequence, read by the same threads for the covering
  // version and the coverage
  for (int j = gtid; j < n_s; j += nthr)
    g.pb[j] = j + fdb::row_bound(in.hk, cap, g.ins_k + (size_t)j * width,
                                 width, true);
  grid.sync();
  const int mtot = cap + n_s;
  for (int t = blockIdx.x; t < g.n_tiles; t += gridDim.x) {
    merged_src(g.pb, n_s, cap, mtot, t, sm, g.src);
    int totm, tots;
    cover_tile_reduce(g.m, t, totm, tots);
    if (threadIdx.x == 0) {
      g.agg_max[t] = totm;
      g.agg_sum[t] = tots;
    }
  }
  grid.sync();
  // the covering versions and GC, then compaction into the output and
  // its +inf / VDEAD tail
  const int32_t commit = *in.commit, oldest2 = max(*in.oldest, 0);
  for (int t = blockIdx.x; t < g.n_tiles; t += gridDim.x) {
    const int pre_max = block_fold<true>(g.agg_max, t);
    const int tot = cover_keep_tile(g.m, t, pre_max,
                                    block_fold<false>(g.agg_sum, t), commit,
                                    oldest2, g.mv, g.keepf);
    if (threadIdx.x == 0) g.agg_keep[t] = tot;
  }
  grid.sync();
  const int count = block_fold<false>(g.agg_keep, g.n_tiles);
  if (gtid == 0) *g.count_out = count;
  for (int t = blockIdx.x; t < g.n_tiles; t += gridDim.x)
    compact_tile(g.m, g.mv, g.keepf, t, block_fold<false>(g.agg_keep, t),
                 g.hk_out, g.hv_out);
  const long long n0 = min(max(count, 0), cap);
  for (long long i = n0 * width + gtid; i < (long long)cap * width;
       i += nthr)
    g.hk_out[i] = fdb::INF_WORD;
  for (long long q = n0 + gtid; q < cap; q += nthr) g.hv_out[q] = fdb::VDEAD;
}

// ---- the entries' bodies ----------------------------------------------------
template <class K>
cudaError_t launch_coop(K kernel, int threads, size_t smem, int needed,
                        void** args, cudaStream_t st) {
  cudaError_t e = fdb::allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const void* fn = (const void*)kernel;
  const int grid = fdb::coop_blocks(fn, threads, smem, needed);
  e = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(threads), args, smem,
                                  st);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// K8e: the shard's (hk [cap], bounds low/high one row each) external
// read flags into ext_out [R]. K1's, K2's and K7's work runs inside
// shard_ext_kernel and none of their kernels launches, so the entries
// leave their `launches` counts ([0] K1, [1] K2, [2] K7) as given
int shard_ext(const In& in, const uint32_t* low, const uint32_t* high,
              uint8_t* ext_out, void* scratch, size_t scratch_bytes,
              cudaStream_t st) {
  if (bad_shape(in) || !low || !high || !ext_out) return fdb::ERR_BAD_ARGS;
  ShardScratch s;
  int e = carve_checked(s, in, scratch, scratch_bytes);
  if (e) return e;
  int log_r = 0;
  while ((1 << log_r) < in.R) ++log_r;
  const int read_blocks = fdb::blocks_for(in.R, EXT_THREADS);
  ExtArgs a{in, low, high, s.rs, s.lo, s.hi, s.bmax, s.smax, s.rok, ext_out,
            log_r, in.cap / fdb::RMQ_BLOCK, supers_for(in.cap), read_blocks};
  const int needed =
      read_blocks + max(a.nsb, fdb::blocks_for(in.T + 2, EXT_THREADS));
  void* args[] = {&a};
  FDB_TRY(launch_coop(shard_ext_kernel, EXT_THREADS, 0, needed, args, st));
  return 0;
}

// K8f: from the external flags of all D shards gathered into ext_all
// [D, R] and the segment starts the K8e of the same feed left in the
// scratch, the verdicts and attribution (every shard's) and the shard's
// own [cap] state
int shard_finish(const In& in, const uint32_t* low, const uint32_t* high,
                 const uint8_t* ext_all, int D, int attribute,
                 uint32_t* hk_out, int32_t* hv_out, int32_t* count_out,
                 uint8_t* conflict_out, uint8_t* read_hit_out,
                 void* scratch, size_t scratch_bytes, cudaStream_t st) {
  if (bad_shape(in) || D < 1 || !low || !high || !ext_all || !hk_out ||
      !hv_out || !count_out || !conflict_out || (attribute && !read_hit_out))
    return fdb::ERR_BAD_ARGS;
  ShardScratch s;
  int e = carve_checked(s, in, scratch, scratch_bytes);
  if (e) return e;
  const int n = 2 * in.R + 2 * in.Wr, np = leaves_for(n);
  const int nc = np / FX_CHUNK, n_s = 2 * in.Wr, mtot = in.cap + n_s;
  const uint4* sorted = nullptr;
  e = fdb::with_rec_uint4s(in.width + 1, [&](auto nv) -> int {
    constexpr int NV = decltype(nv)::value;
    FDB_TRY((fdb::rec_sort_coop<NV>(EpLoad<NV>{in},
                                    ShardPlace<NV>{in, s.pos, s.at}, n,
                                    s.rec_a, s.rec_b, &sorted, st)));
    return 0;
  });
  if (e) return e;
  const int top_n = max(FX_TOP, 2 * nc);
  Fx f{in, s.pos, s.at, s.rs, ext_all, D, attribute, n, np, nc, top_n,
       s.base, s.c0, s.c1, s.flags, s.seg, s.leaf, s.rm, s.st0, s.st1,
       s.cfinal, conflict_out, read_hit_out};
  void* fargs[] = {&f};
  // a thread a read, a transaction, and a write beside the chunks' blocks
  const int needed = max(max(fdb::blocks_for(in.R, FX_THREADS),
                             fdb::blocks_for(in.T + 1, FX_THREADS)),
                         nc + fdb::blocks_for(in.Wr, FX_THREADS));
  FDB_TRY(launch_coop(shard_fix_kernel, FX_THREADS,
                      (32 + 2 * (size_t)top_n) * sizeof(int32_t),
                      needed, fargs, st));
  Part pt{reinterpret_cast<const uint32_t*>(sorted), 4 * rec_nv(in.width), n,
          s.cfinal, low, high};
  Merged m{in.hk, in.hv, s.ins_k, s.ins_tie, s.src, in.cap, in.width, mtot};
  Mg g{in, pt, m, s.ins_k, s.ins_tie, s.pb, s.src, s.mv, s.agg_surv,
       s.agg_max, s.agg_sum, s.agg_keep, s.keepf,
       fdb::blocks_for(n, SURV_TILE), fdb::blocks_for(mtot, TILE), hk_out,
       hv_out, count_out};
  void* margs[] = {&g};
  FDB_TRY(launch_coop(shard_merge_kernel, SCAN_THREADS, 0,
                      max(g.n_pt, g.n_tiles), margs, st));
  return 0;
}

}  // namespace

FDB_API size_t fdb_resolve_shard_scratch_bytes(int cap, int T, int R, int Wr,
                                               int width) {
  ShardScratch s;
  return carve(s, nullptr, cap, T, R, Wr, width);
}

// K8e and K8f (one shard a device): hk [cap, width], hv [cap], low/high
// one [width] row each; ext_out [R] and ext_all [D, R] uint8. The
// scratch is sized by fdb_resolve_shard_scratch_bytes and must be the
// same buffer for a feed's K8e and K8f.
FDB_API int fdb_resolve_shard_ext(
    const uint32_t* hk, const int32_t* hv, const int32_t* snap,
    const void* too_old, const uint32_t* rb, const uint32_t* re,
    const int32_t* rtxn, const void* rvalid, const uint32_t* wb,
    const uint32_t* we, const int32_t* wtxn, const void* wvalid,
    const int32_t* commit, const int32_t* oldest, const uint32_t* low,
    const uint32_t* high, int flag_bytes, int cap, int T, int R, int Wr,
    int width, uint8_t* ext_out, void* scratch, size_t scratch_bytes,
    void* stream, long long* launches) {
  if (flag_bytes != 1 && flag_bytes != 4) return fdb::ERR_BAD_ARGS;
  In in{hk, hv, snap, too_old, rb, re, rtxn, rvalid, wb, we, wtxn, wvalid,
        commit, oldest, flag_bytes, cap, T, R, Wr, width};
  return shard_ext(in, low, high, ext_out, scratch, scratch_bytes,
                   static_cast<cudaStream_t>(stream));
}

FDB_API int fdb_resolve_shard_ext_packed(
    const uint32_t* hk, const int32_t* hv, const uint32_t* buf,
    const uint32_t* low, const uint32_t* high, int cap, int T, int R, int Wr,
    int width, uint8_t* ext_out, void* scratch, size_t scratch_bytes,
    void* stream, long long* launches) {
  return shard_ext(unpack_feed(hk, hv, buf, cap, T, R, Wr, width), low, high,
                   ext_out, scratch, scratch_bytes,
                   static_cast<cudaStream_t>(stream));
}

FDB_API int fdb_resolve_shard_finish(
    const uint32_t* hk, const int32_t* hv, const int32_t* snap,
    const void* too_old, const uint32_t* rb, const uint32_t* re,
    const int32_t* rtxn, const void* rvalid, const uint32_t* wb,
    const uint32_t* we, const int32_t* wtxn, const void* wvalid,
    const int32_t* commit, const int32_t* oldest, const uint32_t* low,
    const uint32_t* high, const uint8_t* ext_all, int flag_bytes, int D,
    int cap, int T, int R, int Wr, int width, int attribute,
    uint32_t* hk_out, int32_t* hv_out, int32_t* count_out,
    uint8_t* conflict_out, uint8_t* read_hit_out, void* scratch,
    size_t scratch_bytes, void* stream) {
  if (flag_bytes != 1 && flag_bytes != 4) return fdb::ERR_BAD_ARGS;
  In in{hk, hv, snap, too_old, rb, re, rtxn, rvalid, wb, we, wtxn, wvalid,
        commit, oldest, flag_bytes, cap, T, R, Wr, width};
  return shard_finish(in, low, high, ext_all, D, attribute, hk_out, hv_out,
                      count_out, conflict_out, read_hit_out, scratch,
                      scratch_bytes, static_cast<cudaStream_t>(stream));
}

FDB_API int fdb_resolve_shard_finish_packed(
    const uint32_t* hk, const int32_t* hv, const uint32_t* buf,
    const uint32_t* low, const uint32_t* high, const uint8_t* ext_all, int D,
    int cap, int T, int R, int Wr, int width, int attribute,
    uint32_t* hk_out, int32_t* hv_out, int32_t* count_out,
    uint8_t* conflict_out, uint8_t* read_hit_out, void* scratch,
    size_t scratch_bytes, void* stream) {
  return shard_finish(unpack_feed(hk, hv, buf, cap, T, R, Wr, width), low,
                      high, ext_all, D, attribute, hk_out, hv_out, count_out,
                      conflict_out, read_hit_out, scratch, scratch_bytes,
                      static_cast<cudaStream_t>(stream));
}
