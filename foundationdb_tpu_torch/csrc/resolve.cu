// K3: one conflict-resolution step over the interval history.
//
// Replaces foundationdb_tpu/ops/conflict_kernel.py:138 make_resolve_core
// (step :187-425), entered packed (:586 make_resolve_packed_fn, :551
// make_interval_unpack) or unpacked (:431 make_resolve_fn). It computes
// the same function, (HK', HV', count, conflict[T], read_hit[R]):
//   1. external check: two searches per read into HK (the history is
//      sorted; ext_bounds_kernel: common.cuh row_bounds, the read's two
//      searches interleaved so each round's two probed rows load
//      together, each probed row's first ROW_CW words loaded at once,
//      the row load K6 shares), then K2 range max over HV and K1 for
//      the per-transaction read segments;
//   2. one endpoint sort per step: the batch's N = 2R + 2Wr endpoints
//      (rb, wb, we, an invalid one as the +inf row, as the reference
//      does at :255-257, and re) are sorted as records of the key row
//      and a tag, (key, end-before-begin, index), by sort.cuh: tiles of
//      512 records (pairs sorted in each thread's registers, then
//      merge-path merges in shared memory), then merge-path rounds across
//      tiles (warp-wide splits, shared-memory merges); the last pass
//      writes each endpoint's sorted position. Ends sort before begins on equal
//      keys, so pos(wb) < pos(re) <=> wb < re and pos(rb) < pos(we) <=>
//      rb < we for every key, empty and inverted ranges included: the
//      sorted position is the reference's rank (:271-289) for the two
//      compares the overlap makes, with no scan;
//   3. rank-space overlap: the read x write matrix, 32 writes per uint32
//      lane as the reference packs it, from int32 positions: each lane's
//      32 writes become a table (their w_lo, w_hi and wtxn sorted, with
//      prefix and suffix masks), so a read's word is three 6-probe
//      searches and two ANDs instead of 96 compares (a warp walks one
//      lane's table for 32 reads at a time); a read whose transaction
//      precedes every write of the lane writes 0 without searching. The
//      antitone fixpoint runs inside ONE cooperative launch with
//      grid-wide barriers between its phases, and attribution is one
//      more masked pass;
//   4. merge: a stable compaction of the sorted endpoints keeps the
//      surviving writes' wb and we, already in key order (the order
//      among equal keys is free: the output is canonical); the rest of
//      the 2*Wr boundary slots become +inf rows after them, which only
//      the never-kept +inf run sees. Each boundary's count of history
//      rows <= it (one row search) places it, and an int32 search of
//      those counts places each history row; two tiled scans give the
//      covering version and the coverage count;
//   5. GC + compaction: keep flags exactly as the reference computes
//      them, then a prefix sum and a scatter pack the kept rows (a tile
//      taken in stripes, so a warp moves consecutive rows); the tail is
//      filled with +inf / VDEAD.
// The output state is canonical, so it is bit-identical to the
// reference's. Bound: bytes. The live history rows must be read once
// and the whole padded history written once (24 bytes per row at W = 4:
// at cap 2^20 with ~650K live rows, ~16 MB read and 24 MiB written) plus
// the 1.7 MB feed: ~13 us at 3.35 TB/s (chip_smoke.py computes it from
// the run's live rows). The dense overlap matrix (R x Wr bits, 32 MiB at
// the slice's shapes, written once and read once per fixpoint round)
// and the scans over the merged rows are the known excess over that
// bound. Records hold width + 1 words rounded up to 1, 2, 3, 4, 8, 16 or
// 32 uint4s, so the sort takes keys of up to 127 words.
//
// K8: the key-range sharded step (fdb_resolve_sharded[_packed]).
//
// Replaces foundationdb_tpu/parallel/sharded_resolver.py:36
// _clip_and_resolve_packed and :77 _clip_and_resolve (launched through
// :334 and :252 under shard_map), with the cross-shard combine of
// ops/conflict_kernel.py:182-185. The S shards of a [S, cap, W+1]
// history run in lockstep on one card, through K3's own phase kernels,
// each per-shard phase ONE launch with the shard in blockIdx.y: the
// external bounds of every shard, each read clipped to the shard in
// registers first (K7 fused into the bounds search, ext_bounds_kernel
// <true>: no clipped row is written), the flags of every shard (K2
// over every shard's HV in one call), OR-combined per transaction (the
// psum's counterpart); K3's endpoint
// sort of the unclipped ranges, ONE rank-space overlap matrix and ONE
// cooperative fixpoint; then one stable partition of the sorted
// endpoints gives every shard its survivors' boundaries, each write
// clipped to the shard (begin max(wb, lo), end min(we, hi)) and kept
// where the clip is non-empty, as the reference's clip does; then merge,
// GC and compaction into each shard's output with its own count.
// The partition keeps the (key, tie) order of a sort of the clipped
// boundaries: clipping only raises begins to lo and lowers ends to hi,
// a kept write has wb < hi and we > lo, so the clipped keys stay
// non-decreasing along the sorted order, and a begin never ties an end
// that sorted after it. Only the order among identical (key, tie) rows
// can differ, which the merge, cover, GC and compaction never read.
// One matrix is exact: the reference's fixpoint rounds and attribution
// read, per read, only the OR over shards of (ovp_s[r] & alive), which
// is (OR_s ovp_s[r]) & alive; and a read and a write clipped to shard s
// are both valid and overlap there iff max(rb, wb, lo_s) < min(re, we,
// hi_s), which holds for some s iff max(rb, wb) < min(re, we) (the
// shard holding max(rb, wb) sees the overlap), that is iff the unclipped
// ranges are non-empty (rb < re, wb < we) and overlap. So K8's one
// matrix is K3's over the unclipped ranges with an empty range counted
// invalid: the OR of the S clipped matrices, bit for bit, on any feed.
// The sorted positions decide emptiness too (pos(b) < pos(e) <=> b < e),
// so the rank-space kernels take it as a template flag (kNonEmpty),
// which K3 leaves off: the reference's single-shard step keeps an
// inverted range valid. Bound: bytes, as K3's, over the S shards' rows:
// each shard's live rows read once, the whole [S, cap] state written
// once and the feed read once.
//
// K8e and K8f, the same step with one shard a device, are in
// shard_step.cu; what they share with K3 and K8 is in step.cuh.

#include <cooperative_groups.h>

#include <climits>

#include "common.cuh"
#include "sort.cuh"
#include "step.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int FIX_THREADS = 256;
// the bounds search's blocks: at R = 16,384 reads, 128 blocks, about
// one an SM (blocks of 256 left half the SMs idle, and the search is
// bound by each SM's scattered row loads)
constexpr int BOUNDS_THREADS = 128;

// ---- 1. external check ----------------------------------------------------
// Read i against shard k = blockIdx.y's history (step.cuh read_bounds):
// the S threads of a read load the same feed rows, out of L1/L2; the
// interval and the sharded step share this kernel.
template <bool kClip>
__global__ void ext_bounds_kernel(In in, const uint32_t* lows,
                                  const uint32_t* highs, int32_t* lo,
                                  int32_t* hi, uint8_t* rok) {
  const int k = blockIdx.y, i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= in.R) return;
  const size_t o = (size_t)k * in.R + i;
  read_bounds<kClip>(in, in.hk + (size_t)k * in.cap * in.width, lows, highs,
                     k, i, lo[o], hi[o], rok[o]);
}

__global__ void ext_flags_kernel(In in, const uint8_t* rok,
                                 const int32_t* vmax, uint8_t* ext_r) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= in.R) return;
  const int q = blockIdx.y * in.R + i, rt = in.rtxn[i];
  int32_t s = (rt >= 0 && rt < in.T) ? in.snap[rt] : fdb::SNAP_CLAMP;
  ext_r[q] = rok[q] && vmax[q] > s;
}

// base_c = ext | too_old, with the pad entry T fixed at 1; K8's ext is
// the OR over its S shards' external read flags (ext_r[k * R + r])
template <bool kSharded>
__global__ void base_kernel(In in, const int32_t* rs, const uint8_t* ext_r,
                            uint8_t* base, uint8_t* ca, uint8_t* cb, int S) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t > in.T) return;
  uint8_t v = 1;
  if (t < in.T) {
    bool any = false;
    if (kSharded) {
      for (int k = 0; k < S; ++k)
        for (int r = rs[t]; r < rs[t + 1]; ++r)
          any |= ext_r[(size_t)k * in.R + r] != 0;
    } else {
      for (int r = rs[t]; r < rs[t + 1]; ++r) any |= ext_r[r] != 0;
    }
    v = any || fdb::flag_at(in.too_old, t, in.flag_bytes);
  }
  base[t] = v;
  ca[t] = v;
  cb[t] = v;
}

// ---- 2. the endpoint sort ---------------------------------------------------
// The records are step.cuh's ep_record; the last pass: the record's
// endpoint learns its sorted position
template <int NV>
struct EpPlace {
  In in;
  Pos P;
  __device__ void operator()(const fdb::Rec<NV>& rec, int pos) const {
    const int g = (int)(fdb::rec_word(rec, in.width) & ~BEGIN_BIT);
    const int R = in.R, Wr = in.Wr;
    if (g < R) P.r_lo[g] = pos;
    else if (g < R + Wr) P.w_lo[g - R] = pos;
    else if (g < R + 2 * Wr) P.w_hi[g - R - Wr] = pos;
    else P.r_hi[g - R - 2 * Wr] = pos;
  }
};

// ---- 2a. rank-space overlap -------------------------------------------------
// ovp[r * n_lanes + l] bit b <=> read r overlaps write w = 32*l + b of
// an earlier transaction, both valid: pos(wb) < pos(re) and pos(rb) <
// pos(we), that is wb < re and rb < we (the reference's :292-294). With
// kNonEmpty (K8), a range with pos(b) > pos(e), that is b >= e, counts
// invalid too, as every shard's clip counts it.
//
// A lane's 32 writes become a table first: their w_lo, w_hi and wtxn
// each sorted (an invalid write as w_lo = INT_MAX, w_hi = INT_MIN,
// wtxn = INT_MAX), with the masks MA[k] (the k smallest w_lo), MB[k]
// (all but the k smallest w_hi) and MC[k] (the k smallest wtxn). A
// read's word is then MA[#(w_lo < r_hi)] & MB[#(w_hi <= r_lo)] &
// MC[#(wtxn < rtxn)]: three 6-probe searches instead of 96 compares.
constexpr int LT_SL = 0, LT_SH = 32, LT_ST = 64;        // sorted keys
constexpr int LT_MA = 96, LT_MB = 129, LT_MC = 162;     // 33 masks each
constexpr int LT_TMIN = 195, LT_TMAX = 196;  // valid wtxn's min and max
constexpr int LT_STRIDE = 199;  // words a table (odd: no bank conflicts)
constexpr int OVT_LANES = 8;    // lanes (tables, warps) per overlap block
constexpr int OVT_CHUNKS = 16;  // 32-read chunks per overlap block

// ascending sort of one (key, idx) per lane across the warp (bitonic)
__device__ __forceinline__ void warp_sort(int& key, int& idx, int lane) {
  for (int k = 2; k <= 32; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      int pk = __shfl_xor_sync(FULL, key, j);
      int pi = __shfl_xor_sync(FULL, idx, j);
      bool pless = pk < key || (pk == key && pi < idx);
      bool keep_min = ((lane & j) == 0) == ((lane & k) == 0);
      if (keep_min ? pless : !pless) {
        key = pk;
        idx = pi;
      }
    }
  }
}

// inclusive OR over lanes <= lane (prefix) or >= lane (suffix)
__device__ __forceinline__ uint32_t warp_or(uint32_t m, int lane,
                                            bool prefix) {
  for (int o = 1; o < 32; o <<= 1) {
    uint32_t y = prefix ? __shfl_up_sync(FULL, m, o)
                        : __shfl_down_sync(FULL, m, o);
    if (prefix ? lane >= o : lane + o < 32) m |= y;
  }
  return m;
}

// one warp per lane: its table (LT_STRIDE words) into tab
template <bool kNonEmpty>
__global__ void lane_tables_kernel(In in, Pos P, int n_lanes, int32_t* tab) {
  const int l = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int b = threadIdx.x & 31;
  if (l >= n_lanes) return;  // whole warps
  const int w = l * 32 + b;
  const bool ok = w < in.Wr && fdb::flag_at(in.wvalid, w, in.flag_bytes) &&
                  (!kNonEmpty || P.w_lo[w] < P.w_hi[w]);
  int32_t* t = tab + (size_t)l * LT_STRIDE;
  int key = ok ? P.w_lo[w] : INT_MAX, idx = b;
  warp_sort(key, idx, b);
  t[LT_SL + b] = key;
  t[LT_MA + 1 + b] = (int32_t)warp_or(1u << idx, b, true);
  key = ok ? P.w_hi[w] : INT_MIN;
  idx = b;
  warp_sort(key, idx, b);
  t[LT_SH + b] = key;
  t[LT_MB + b] = (int32_t)warp_or(1u << idx, b, false);
  const int wt = ok ? in.wtxn[w] : INT_MAX;
  key = wt;
  idx = b;
  warp_sort(key, idx, b);
  t[LT_ST + b] = key;
  t[LT_MC + 1 + b] = (int32_t)warp_or(1u << idx, b, true);
  int tmin = ok ? wt : INT_MAX, tmax = ok ? wt : INT_MIN;
  for (int o = 16; o > 0; o >>= 1) {
    tmin = min(tmin, __shfl_xor_sync(FULL, tmin, o));
    tmax = max(tmax, __shfl_xor_sync(FULL, tmax, o));
  }
  if (b == 0) {
    t[LT_MA] = 0;
    t[LT_MB + 32] = 0;
    t[LT_MC] = 0;
    t[LT_TMIN] = tmin;
    t[LT_TMAX] = tmax;
  }
}

// #(s[i] < x), or #(s[i] <= x) with `le`, over 32 sorted keys: K1's probe
// sequence at n = 32
template <bool LE>
__device__ __forceinline__ int count_below(const int32_t* s, int x) {
  int k = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1) {
    int v = s[k + step - 1];
    k += (LE ? v <= x : v < x) ? step : 0;
  }
  int v = s[k];
  return k + ((LE ? v <= x : v < x) ? 1 : 0);
}

// OVT_LANES tables per block, one a warp; a warp's threads take 32
// reads at a time, so every search walks one table (no bank conflicts).
// The words of 32 reads x the block's lanes go out through shared
// memory, a 32-byte run per read row.
template <bool kNonEmpty>
__global__ void __launch_bounds__(OVT_LANES * 32)
    overlap_rank_kernel(In in, Pos P, const int32_t* tab, int n_lanes,
                        uint32_t* ovp) {
  __shared__ int32_t ot[OVT_LANES * LT_STRIDE];
  __shared__ uint32_t words[32][OVT_LANES + 1];
  const int l0 = blockIdx.x * OVT_LANES, nl = min(OVT_LANES, n_lanes - l0);
  for (int i = threadIdx.x; i < nl * LT_STRIDE; i += blockDim.x)
    ot[i] = tab[(size_t)l0 * LT_STRIDE + i];
  __syncthreads();
  const int wl = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int32_t* tb = ot + wl * LT_STRIDE;
  const bool has = wl < nl;
  const int tmin = has ? tb[LT_TMIN] : INT_MAX;
  const int tmax = has ? tb[LT_TMAX] : INT_MIN;
  for (int c = 0; c < OVT_CHUNKS; ++c) {
    const int r0 = (blockIdx.y * OVT_CHUNKS + c) * 32;
    if (r0 >= in.R) break;
    const int r = r0 + t;
    uint32_t bits = 0;
    if (has && r < in.R && fdb::flag_at(in.rvalid, r, in.flag_bytes) &&
        (!kNonEmpty || P.r_lo[r] < P.r_hi[r])) {
      const int rt = in.rtxn[r];
      if (rt > tmin) {
        bits = (uint32_t)tb[LT_MA + count_below<false>(tb + LT_SL,
                                                        P.r_hi[r])] &
               (uint32_t)tb[LT_MB + count_below<true>(tb + LT_SH,
                                                       P.r_lo[r])];
        if (rt <= tmax)
          bits &= (uint32_t)tb[LT_MC + count_below<false>(tb + LT_ST, rt)];
      }
    }
    words[t][wl] = bits;
    __syncthreads();
    for (int i = threadIdx.x; i < 32 * OVT_LANES; i += blockDim.x) {
      int row = i / OVT_LANES, col = i % OVT_LANES;
      if (col < nl && r0 + row < in.R)
        ovp[(size_t)(r0 + row) * n_lanes + l0 + col] = words[row][col];
    }
    __syncthreads();
  }
}

// ---- 2b. the fixpoint, one cooperative launch ------------------------------
// K8's ext_r holds its S shards' external read flags, shard k's at k * R;
// its attribution ORs them
struct Fix {
  const uint32_t* ovp;
  int R, n_lanes, Wr, T, attribute;
  const int32_t* wtxn;
  const int32_t* rs;
  const uint8_t* base;
  uint8_t* ca;
  uint8_t* cb;
  uint8_t* cfinal;
  int* flags;
  uint32_t* alive_p;
  uint8_t* hit_r;
  const uint8_t* ext_r;
  uint8_t* conflict_out;
  uint8_t* read_hit_out;
  int S;
};

__device__ void pack_alive(const Fix& f, const uint8_t* c, int gwarp,
                           int nwarps, int lane) {
  for (int l = gwarp; l < f.n_lanes; l += nwarps) {
    int w = l * 32 + lane;
    bool alive = false;
    if (w < f.Wr) {
      int t = min(max(f.wtxn[w], 0), f.T);
      alive = c[t] == 0;
    }
    unsigned bits = __ballot_sync(FULL, alive);
    if (lane == 0) f.alive_p[l] = bits;
  }
}

__device__ bool read_hits(const Fix& f, int r, int lane) {
  uint32_t acc = 0;
  const uint32_t* row = f.ovp + (size_t)r * f.n_lanes;
  for (int l = lane; l < f.n_lanes; l += 32) acc |= row[l] & f.alive_p[l];
  return __any_sync(FULL, acc != 0);
}

template <bool kSharded>
__global__ void __launch_bounds__(FIX_THREADS) fixpoint_kernel(Fix f) {
  cg::grid_group grid = cg::this_grid();
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthr = gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31, gwarp = gtid >> 5, nwarps = nthr >> 5;
  uint8_t* cur = f.ca;
  uint8_t* nxt = f.cb;
  int i = 0;
  while (true) {
    if (gtid == 0) f.flags[(i + 1) % 3] = 0;
    pack_alive(f, cur, gwarp, nwarps, lane);
    grid.sync();
    for (int r = gwarp; r < f.R; r += nwarps) {
      bool h = read_hits(f, r, lane);
      if (lane == 0) f.hit_r[r] = h;
    }
    grid.sync();
    for (int t = gtid; t < f.T; t += nthr) {
      bool any = false;
      for (int r = f.rs[t]; r < f.rs[t + 1]; ++r) any |= f.hit_r[r] != 0;
      uint8_t v = f.base[t] | (any ? 1 : 0);
      nxt[t] = v;
      if (v != cur[t]) f.flags[i % 3] = 1;
    }
    grid.sync();
    ++i;
    int changed = *reinterpret_cast<volatile int*>(&f.flags[(i - 1) % 3]);
    uint8_t* tmp = cur;
    cur = nxt;
    nxt = tmp;
    // at most T+2 applications of the map, as the reference's loop
    if (!changed || i >= f.T + 2) break;
  }
  for (int t = gtid; t <= f.T; t += nthr) {
    f.cfinal[t] = cur[t];
    if (t < f.T) f.conflict_out[t] = cur[t];
  }
  if (!f.attribute) return;
  pack_alive(f, cur, gwarp, nwarps, lane);
  grid.sync();
  for (int r = gwarp; r < f.R; r += nwarps) {
    bool h = read_hits(f, r, lane);
    if (kSharded) {
      for (int k = 0; k < f.S; ++k) h |= f.ext_r[k * f.R + r] != 0;
      if (lane == 0) f.read_hit_out[r] = h;
    } else {
      if (lane == 0) f.read_hit_out[r] = h || f.ext_r[r];
    }
  }
}

// ---- 3. merge ---------------------------------------------------------------
// The survivors' boundaries, per shard, out of the one endpoint sort: a
// stable partition in two passes (step.cuh part_count_tile, then
// part_place_tile), tile blockIdx.x and shard blockIdx.y.
template <bool kClip>
__global__ void part_count_kernel(In in, Part pt, int32_t* agg) {
  const int k = blockIdx.y;
  const int tot = part_count_tile<kClip>(in, pt, blockIdx.x, k);
  if (threadIdx.x == 0) agg[k * gridDim.x + blockIdx.x] = tot;
}

// pass B: shard k's survivor rows in sorted order into its 2 * Wr slots
// of ins_k, then +inf rows with tie 1, which only the never-kept +inf
// run sees
template <bool kClip>
__global__ void part_place_kernel(In in, Part pt, const int32_t* agg,
                                  uint32_t* __restrict__ ins_k,
                                  int32_t* __restrict__ ins_tie) {
  const int k = blockIdx.y, n_tiles = gridDim.x, n_s = 2 * in.Wr;
  const int width = in.width;
  agg += k * n_tiles;
  ins_k += (size_t)k * n_s * width;
  ins_tie += (size_t)k * n_s;
  int before = 0, all = 0;
  for (int i = threadIdx.x; i < n_tiles; i += blockDim.x) {
    all += agg[i];
    if (i < (int)blockIdx.x) before += agg[i];
  }
  int pre, total;
  fdb::block_excl_scan<false>(before, pre);
  fdb::block_excl_scan<false>(all, total);
  part_place_tile<kClip>(in, pt, blockIdx.x, k, pre, ins_k, ins_tie);
  for (int j = total + blockIdx.x * blockDim.x + threadIdx.x; j < n_s;
       j += gridDim.x * blockDim.x) {
    for (int w = 0; w < width; ++w)
      ins_k[(size_t)j * width + w] = fdb::INF_WORD;
    ins_tie[j] = 1;
  }
}

// From here on every kernel runs shard blockIdx.y of a launch over the
// shards (K3: one), on its slices of the [S, ...] buffers.
//
// sorted boundary j (ins_k's rows are sorted): preceded by every
// history row with key <= its key (history rows have tie 1 <= every
// boundary tie, and come first on ties); ub[j] is that count
__global__ void merge_ins_kernel(Merged m0, int32_t* ub, int32_t* src) {
  const int shard = blockIdx.y, n_s = m0.mtot - m0.cap;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_s) return;
  const Merged m = m0.shard(shard);
  int u = fdb::row_bound(m.hk, m.cap, m.ins_k + (size_t)j * m.width, m.width,
                         true);
  ub[(size_t)shard * n_s + j] = u;
  src[(size_t)shard * m.mtot + j + u] = m.cap + j;
}

// history row i: preceded by every boundary with (key, tie) < (hk[i], 1),
// that is with key < hk[i]: as the history is sorted, every boundary j
// with ub[j] <= i. ub is non-decreasing in j, so an int32 search counts
// them
__global__ void merge_hist_kernel(int cap, int n_s, const int32_t* ub,
                                  int32_t* src) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= cap) return;
  ub += (size_t)blockIdx.y * n_s;
  src += (size_t)blockIdx.y * (cap + n_s);
  int lo = 0, hi = n_s;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (ub[mid] <= i) lo = mid + 1; else hi = mid;
  }
  src[i + lo] = i;
}

// the covering version's two scans (step.cuh cover_tile_reduce, then
// cover_tile_apply), tile blockIdx.x
__global__ void cover_reduce_kernel(Merged m0, int32_t* agg_max,
                                    int32_t* agg_sum) {
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  int totm, tots;
  cover_tile_reduce(m0.shard(blockIdx.y), blockIdx.x, totm, tots);
  if (threadIdx.x == 0) {
    agg_max[tile] = totm;
    agg_sum[tile] = tots;
  }
}

__global__ void cover_apply_kernel(Merged m0, const int32_t* pre_max,
                                   const int32_t* pre_sum,
                                   const int32_t* commit_p, int32_t* mv) {
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  cover_tile_apply(m0.shard(blockIdx.y), blockIdx.x, pre_max[tile],
                   pre_sum[tile], *commit_p,
                   mv + (size_t)blockIdx.y * m0.mtot);
}

// ---- 4. GC + compaction -----------------------------------------------------
__device__ bool keep_row(const Merged& m, const int32_t* mv, int p,
                         int32_t oldest2) {
  const uint32_t* kp = m.key(p);
  bool run_end = p == m.mtot - 1 ||
                 fdb::row_cmp(kp, m.key(p + 1), m.width) != 0;
  if (!run_end) return false;
  bool new_key_before =
      p > 0 && fdb::row_cmp(m.key(p - 1), kp, m.width) != 0;
  return keep_rule(true, new_key_before, mv[p],
                   new_key_before ? mv[p - 1] : 0,
                   fdb::row_is_inf(kp, m.width), oldest2);
}

// the keep flags and their count per tile; a tile's rows are taken
// striped (row k * SCAN_THREADS + t of the tile by thread t), so a warp
// reads consecutive rows
__global__ void keep_reduce_kernel(Merged m0, const int32_t* mv,
                                   const int32_t* oldest_p,
                                   uint8_t* __restrict__ keepf,
                                   int32_t* agg) {
  const Merged m = m0.shard(blockIdx.y);
  mv += (size_t)blockIdx.y * m.mtot;
  keepf += (size_t)blockIdx.y * m.mtot;
  const int base = blockIdx.x * TILE + threadIdx.x;
  int32_t oldest2 = max(*oldest_p, 0);
  bool kp[SCAN_ITEMS];
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    int p = base + k * SCAN_THREADS;
    kp[k] = p < m.mtot && keep_row(m, mv, p, oldest2);
    cnt += kp[k];
  }
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    int p = base + k * SCAN_THREADS;
    if (p < m.mtot) keepf[p] = kp[k];
  }
  int tot;
  fdb::block_excl_scan<false>(cnt, tot);
  if (threadIdx.x == 0) agg[blockIdx.y * gridDim.x + blockIdx.x] = tot;
}

__global__ void compact_kernel(Merged m0, const int32_t* mv,
                               const uint8_t* keepf, const int32_t* pre,
                               uint32_t* __restrict__ hk_out,
                               int32_t* __restrict__ hv_out) {
  const size_t off = (size_t)blockIdx.y * m0.mtot;
  compact_tile(m0.shard(blockIdx.y), mv + off, keepf + off, blockIdx.x,
               pre[blockIdx.y * gridDim.x + blockIdx.x],
               hk_out + (size_t)blockIdx.y * m0.cap * m0.width,
               hv_out + (size_t)blockIdx.y * m0.cap);
}

// rows [count, cap) of the output become +inf / VDEAD, word by word
__global__ void fill_tail_kernel(uint32_t* hk_out, int32_t* hv_out, int cap,
                                 int width, const int32_t* count) {
  hk_out += (size_t)blockIdx.y * cap * width;
  hv_out += (size_t)blockIdx.y * cap;
  const long long n0 = min(max(count[blockIdx.y], 0), cap);
  const long long step = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long i = n0 * width + t; i < (long long)cap * width; i += step)
    hk_out[i] = fdb::INF_WORD;
  for (long long q = n0 + t; q < cap; q += step) hv_out[q] = fdb::VDEAD;
}

// ---- scratch layout ---------------------------------------------------------
// per shard: the external bounds and flags and every buffer of the merge
// (no clipped row: K8 clips in registers). K3 is the S = 1 layout.
struct Scratch {
  int32_t *lo, *hi, *vmax, *rs;
  char* rmq;
  uint8_t *rok, *ext_r, *base, *ca, *cb, *cfinal, *hit_r, *keepf;
  int* flags;
  uint32_t *alive_p, *ovp, *ins_k;
  int32_t *ins_tie, *ub, *src, *mv;
  int32_t *agg_max, *agg_sum, *pre_max, *pre_sum, *agg_keep, *pre_keep;
  uint4 *rec_a, *rec_b;
  Pos pos;
  int32_t *agg_surv, *lane_tab;
};

size_t carve(Scratch& s, char* base, int cap, int T, int R, int Wr,
             int width, int S) {
  fdb::Carver c{base, 0};
  const int n_lanes = (Wr + 31) / 32, n_s = 2 * Wr, mtot = cap + n_s;
  const int n_tiles = (mtot + TILE - 1) / TILE;
  const size_t n_ep = 2 * (size_t)R + 2 * (size_t)Wr;
  s.lo = c.take<int32_t>((size_t)S * R);
  s.hi = c.take<int32_t>((size_t)S * R);
  s.vmax = c.take<int32_t>((size_t)S * R);
  s.rmq = c.take<char>(fdb_range_max_scratch(S, cap));
  s.rs = c.take<int32_t>(T + 2);
  s.rok = c.take<uint8_t>((size_t)S * R);
  s.ext_r = c.take<uint8_t>((size_t)S * R);
  s.base = c.take<uint8_t>(T + 1);
  s.ca = c.take<uint8_t>(T + 1);
  s.cb = c.take<uint8_t>(T + 1);
  s.cfinal = c.take<uint8_t>(T + 1);
  s.flags = c.take<int>(4);
  s.alive_p = c.take<uint32_t>(n_lanes);
  s.hit_r = c.take<uint8_t>(R);
  s.ovp = c.take<uint32_t>((size_t)R * n_lanes);
  s.ins_k = c.take<uint32_t>((size_t)S * n_s * width);
  s.ins_tie = c.take<int32_t>((size_t)S * n_s);
  s.ub = c.take<int32_t>((size_t)S * n_s);
  s.src = c.take<int32_t>((size_t)S * mtot);
  s.mv = c.take<int32_t>((size_t)S * mtot);
  s.keepf = c.take<uint8_t>((size_t)S * mtot);
  s.agg_max = c.take<int32_t>((size_t)S * n_tiles);
  s.agg_sum = c.take<int32_t>((size_t)S * n_tiles);
  s.pre_max = c.take<int32_t>((size_t)S * n_tiles);
  s.pre_sum = c.take<int32_t>((size_t)S * n_tiles);
  s.agg_keep = c.take<int32_t>((size_t)S * n_tiles);
  s.pre_keep = c.take<int32_t>((size_t)S * n_tiles);
  s.rec_a = c.take<uint4>(n_ep * rec_nv(width));
  s.rec_b = c.take<uint4>(n_ep * rec_nv(width));
  s.pos.r_lo = c.take<int32_t>(R);
  s.pos.r_hi = c.take<int32_t>(R);
  s.pos.w_lo = c.take<int32_t>(n_lanes * 32);
  s.pos.w_hi = c.take<int32_t>(n_lanes * 32);
  s.agg_surv = c.take<int32_t>((size_t)S * fdb::blocks_for(n_ep, SURV_TILE));
  s.lane_tab = c.take<int32_t>((size_t)n_lanes * LT_STRIDE);
  return c.off;
}

// the endpoint sort: the sorted records land in *sorted, every
// endpoint's position in s.pos
int endpoint_sort(const In& in, const Scratch& s, const uint4** sorted,
                  cudaStream_t st) {
  return fdb::with_rec_uint4s(in.width + 1, [&](auto nv) -> int {
    constexpr int NV = decltype(nv)::value;
    FDB_TRY((fdb::rec_sort<NV>(EpLoad<NV>{in}, EpPlace<NV>{in, s.pos},
                               2 * in.R + 2 * in.Wr, s.rec_a, s.rec_b,
                               sorted, st)));
    return 0;
  });
}

// 3. the survivors' boundaries of every shard out of the sorted
// endpoints (K8 clips them to the shards' bounds `lows`/`highs`; K3
// passes none)
int partition(const In& in, const Scratch& s, const uint4* sorted,
              const uint32_t* lows, const uint32_t* highs, int S,
              cudaStream_t st) {
  const int n = 2 * in.R + 2 * in.Wr;
  Part pt{reinterpret_cast<const uint32_t*>(sorted), 4 * rec_nv(in.width), n,
          s.cfinal, lows, highs};
  dim3 grid(fdb::blocks_for(n, SURV_TILE), S);
  (lows ? part_count_kernel<true> : part_count_kernel<false>)
      <<<grid, SCAN_THREADS, 0, st>>>(in, pt, s.agg_surv);
  FDB_LAUNCHED();
  (lows ? part_place_kernel<true> : part_place_kernel<false>)
      <<<grid, SCAN_THREADS, 0, st>>>(in, pt, s.agg_surv, s.ins_k,
                                      s.ins_tie);
  FDB_LAUNCHED();
  return 0;
}

// 3. + 4. for every shard at once: interleave its 2*Wr sorted boundaries
// with its history, cover, then GC and compaction into its slice of
// (hk_out, hv_out) and count_out[k]
int merge_gc(const In& in, const Scratch& s, int S, uint32_t* hk_out,
             int32_t* hv_out, int32_t* count_out, cudaStream_t st) {
  const int cap = in.cap, width = in.width, n_s = 2 * in.Wr;
  const int mtot = cap + n_s, n_tiles = (mtot + TILE - 1) / TILE;
  Merged m{in.hk, in.hv, s.ins_k, s.ins_tie, s.src, cap, width, mtot};
  const dim3 tiles(n_tiles, S), one(1, S);
  merge_ins_kernel<<<dim3(fdb::blocks_for(n_s, 256), S), 256, 0, st>>>(
      m, s.ub, s.src);
  FDB_LAUNCHED();
  merge_hist_kernel<<<dim3(fdb::blocks_for(cap, 256), S), 256, 0, st>>>(
      cap, n_s, s.ub, s.src);
  FDB_LAUNCHED();
  cover_reduce_kernel<<<tiles, SCAN_THREADS, 0, st>>>(m, s.agg_max,
                                                      s.agg_sum);
  FDB_LAUNCHED();
  fdb::scan_tiles_kernel<true><<<one, 1024, 0, st>>>(s.agg_max, s.pre_max,
                                                     n_tiles, nullptr);
  FDB_LAUNCHED();
  fdb::scan_tiles_kernel<false><<<one, 1024, 0, st>>>(s.agg_sum, s.pre_sum,
                                                      n_tiles, nullptr);
  FDB_LAUNCHED();
  cover_apply_kernel<<<tiles, SCAN_THREADS, 0, st>>>(
      m, s.pre_max, s.pre_sum, in.commit, s.mv);
  FDB_LAUNCHED();
  keep_reduce_kernel<<<tiles, SCAN_THREADS, 0, st>>>(m, s.mv, in.oldest,
                                                     s.keepf, s.agg_keep);
  FDB_LAUNCHED();
  fdb::scan_tiles_kernel<false><<<one, 1024, 0, st>>>(
      s.agg_keep, s.pre_keep, n_tiles, count_out);
  FDB_LAUNCHED();
  compact_kernel<<<tiles, SCAN_THREADS, 0, st>>>(m, s.mv, s.keepf,
                                                 s.pre_keep, hk_out, hv_out);
  FDB_LAUNCHED();
  fill_tail_kernel<<<dim3(fdb::blocks_for((long long)cap * width, 256 * 8),
                          S),
                     256, 0, st>>>(hk_out, hv_out, cap, width, count_out);
  FDB_LAUNCHED();
  return 0;
}

// the checks every entry makes on its shapes
bool bad_shape(const In& in, int S) {
  return in.cap < fdb::RMQ_BLOCK || (in.cap & (in.cap - 1)) || in.T < 1 ||
         in.R < 1 || (in.R & (in.R - 1)) || in.Wr < 1 || in.width < 1 ||
         S < 1 || !rec_nv(in.width);
}

// 1. external check: K1 segment starts into s.rs; every shard's bounds
// (K8: each read clipped to the shard first, K7 fused), K2 range max
// over every shard's HV in one call, every shard's flags into ext_r
// ([S, R]). launches: [0] K1, [1] K2, [2] K7 (clipped only).
int ext_phase(const In& in, const uint32_t* lows, const uint32_t* highs,
              int S, const Scratch& s, cudaStream_t st, long long* launches) {
  const int R = in.R;
  const bool clip = lows != nullptr;
  FDB_TRY(fdb_searchsorted_launch(in.rtxn, R, nullptr, in.T + 2, 0, s.rs,
                                  st));
  launches[0] += 1;
  (clip ? ext_bounds_kernel<true> : ext_bounds_kernel<false>)
      <<<dim3(fdb::blocks_for(R, BOUNDS_THREADS), S), BOUNDS_THREADS, 0,
         st>>>(in, lows, highs, s.lo, s.hi, s.rok);
  FDB_LAUNCHED();
  if (clip) launches[2] += 1;
  FDB_TRY(fdb_range_max_launch(in.hv, S, in.cap, s.lo, s.hi, R, s.vmax,
                               s.rmq, st));
  launches[1] += 1;
  ext_flags_kernel<<<dim3(fdb::blocks_for(R, 256), S), 256, 0, st>>>(
      in, s.rok, s.vmax, s.ext_r);
  FDB_LAUNCHED();
  return 0;
}

// 2. - 4. from the S shards' external flags (s.ext_r [S, R], s.rs as
// ext_phase left them): the base verdicts, the endpoint sort of the
// (unclipped) ranges, the overlap matrix from its positions (a clipped
// step's one matrix is the OR of the shards' clipped ones, see the note
// above), the fixpoint (+ attribution), then the survivors of every
// shard out of the one sort, merge, GC and compaction, each phase one
// launch over the shards. K3 passes lows == nullptr and S = 1.
int finish_phase(const In& in, const Scratch& s, const uint32_t* lows,
                 const uint32_t* highs, int S, int attribute,
                 uint32_t* hk_out, int32_t* hv_out,
                 int32_t* count_out, uint8_t* conflict_out,
                 uint8_t* read_hit_out, cudaStream_t st) {
  const int T = in.T, R = in.R, Wr = in.Wr;
  const bool clip = lows != nullptr;
  const int n_lanes = (Wr + 31) / 32;
  (clip ? base_kernel<true> : base_kernel<false>)
      <<<fdb::blocks_for(T + 1, 256), 256, 0, st>>>(in, s.rs, s.ext_r,
                                                     s.base, s.ca, s.cb, S);
  FDB_LAUNCHED();
  const uint4* sorted = nullptr;
  int e = endpoint_sort(in, s, &sorted, st);
  if (e) return e;
  (clip ? lane_tables_kernel<true> : lane_tables_kernel<false>)
      <<<fdb::blocks_for((long long)n_lanes * 32, 256), 256, 0, st>>>(
          in, s.pos, n_lanes, s.lane_tab);
  FDB_LAUNCHED();
  dim3 ov_grid((n_lanes + OVT_LANES - 1) / OVT_LANES,
               (R + 32 * OVT_CHUNKS - 1) / (32 * OVT_CHUNKS));
  (clip ? overlap_rank_kernel<true> : overlap_rank_kernel<false>)
      <<<ov_grid, OVT_LANES * 32, 0, st>>>(in, s.pos, s.lane_tab, n_lanes,
                                           s.ovp);
  FDB_LAUNCHED();
  FDB_TRY(cudaMemsetAsync(s.flags, 0, 4 * sizeof(int), st));
  Fix f{s.ovp, R, n_lanes, Wr, T, attribute, in.wtxn, s.rs, s.base,
        s.ca, s.cb, s.cfinal, s.flags, s.alive_p, s.hit_r, s.ext_r,
        conflict_out, read_hit_out, S};
  int needed = max(fdb::blocks_for((long long)R * 32, FIX_THREADS),
                   fdb::blocks_for(T + 1, FIX_THREADS));
  void* args[] = {&f};
  int grid = clip
                 ? fdb::coop_grid<fixpoint_kernel<true>, FIX_THREADS>(needed)
                 : fdb::coop_grid<fixpoint_kernel<false>, FIX_THREADS>(needed);
  void* fix = clip ? (void*)fixpoint_kernel<true>
                   : (void*)fixpoint_kernel<false>;
  FDB_TRY(cudaLaunchCooperativeKernel(fix, dim3(grid), dim3(FIX_THREADS),
                                      args, 0, st));
  FDB_LAUNCHED();
  e = partition(in, s, sorted, lows, highs, S, st);
  if (!e) e = merge_gc(in, s, S, hk_out, hv_out, count_out, st);
  return e;
}

int carve_checked(Scratch& s, const In& in, int S, void* scratch,
                  size_t scratch_bytes) {
  if (carve(s, nullptr, in.cap, in.T, in.R, in.Wr, in.width, S) >
      scratch_bytes)
    return fdb::ERR_SCRATCH;
  carve(s, static_cast<char*>(scratch), in.cap, in.T, in.R, in.Wr, in.width,
        S);
  return 0;
}

// K3 (lows == nullptr, S = 1) and K8 (S shards of [cap] rows each, the
// ranges clipped to [lows[k], highs[k]) for shard k). launches: [0] K1,
// [1] K2, [2] K7 (K8 only: the bounds search its clip is fused into).
int resolve_impl(const In& in, const uint32_t* lows, const uint32_t* highs,
                 int S, int attribute, uint32_t* hk_out, int32_t* hv_out,
                 int32_t* count_out, uint8_t* conflict_out,
                 uint8_t* read_hit_out, void* scratch, size_t scratch_bytes,
                 cudaStream_t st, long long* launches) {
  if (bad_shape(in, S) || (lows && !highs) || !hk_out || !hv_out ||
      !count_out || !conflict_out || (attribute && !read_hit_out))
    return fdb::ERR_BAD_ARGS;
  long long unused[3] = {0, 0, 0};
  if (!launches) launches = unused;
  Scratch s;
  int e = carve_checked(s, in, S, scratch, scratch_bytes);
  if (!e) e = ext_phase(in, lows, highs, S, s, st, launches);
  if (!e)
    e = finish_phase(in, s, lows, highs, S, attribute, hk_out, hv_out,
                     count_out, conflict_out, read_hit_out, st);
  return e;
}

}  // namespace

FDB_API size_t fdb_resolve_scratch_bytes(int cap, int T, int R, int Wr,
                                         int width) {
  Scratch s;
  return carve(s, nullptr, cap, T, R, Wr, width, 1);
}

FDB_API size_t fdb_resolve_sharded_scratch_bytes(int S, int cap, int T, int R,
                                                 int Wr, int width) {
  Scratch s;
  return carve(s, nullptr, cap, T, R, Wr, width, S);
}

FDB_API int fdb_resolve(const uint32_t* hk, const int32_t* hv,
                        const int32_t* snap, const void* too_old,
                        const uint32_t* rb, const uint32_t* re,
                        const int32_t* rtxn, const void* rvalid,
                        const uint32_t* wb, const uint32_t* we,
                        const int32_t* wtxn, const void* wvalid,
                        const int32_t* commit, const int32_t* oldest,
                        int flag_bytes, int cap, int T, int R, int Wr,
                        int width, int attribute, uint32_t* hk_out,
                        int32_t* hv_out, int32_t* count_out,
                        uint8_t* conflict_out, uint8_t* read_hit_out,
                        void* scratch, size_t scratch_bytes, void* stream,
                        long long* launches) {
  if (flag_bytes != 1 && flag_bytes != 4) return fdb::ERR_BAD_ARGS;
  In in{hk, hv, snap, too_old, rb, re, rtxn, rvalid, wb, we, wtxn, wvalid,
        commit, oldest, flag_bytes, cap, T, R, Wr, width};
  return resolve_impl(in, nullptr, nullptr, 1, attribute, hk_out, hv_out,
                      count_out, conflict_out, read_hit_out, scratch,
                      scratch_bytes, static_cast<cudaStream_t>(stream),
                      launches);
}

FDB_API int fdb_resolve_packed(const uint32_t* hk, const int32_t* hv,
                               const uint32_t* buf, int cap, int T, int R,
                               int Wr, int width, int attribute,
                               uint32_t* hk_out, int32_t* hv_out,
                               int32_t* count_out, uint8_t* conflict_out,
                               uint8_t* read_hit_out, void* scratch,
                               size_t scratch_bytes, void* stream,
                               long long* launches) {
  return resolve_impl(unpack_feed(hk, hv, buf, cap, T, R, Wr, width),
                      nullptr, nullptr, 1, attribute, hk_out, hv_out,
                      count_out, conflict_out, read_hit_out, scratch,
                      scratch_bytes, static_cast<cudaStream_t>(stream),
                      launches);
}

// K8: hk [S, cap, width], hv [S, cap], lows/highs [S, width]; count_out
// [S]; the verdicts and attribution are the combined ones
FDB_API int fdb_resolve_sharded(
    const uint32_t* hk, const int32_t* hv, const int32_t* snap,
    const void* too_old, const uint32_t* rb, const uint32_t* re,
    const int32_t* rtxn, const void* rvalid, const uint32_t* wb,
    const uint32_t* we, const int32_t* wtxn, const void* wvalid,
    const int32_t* commit, const int32_t* oldest, const uint32_t* lows,
    const uint32_t* highs, int flag_bytes, int S, int cap, int T, int R,
    int Wr, int width, int attribute, uint32_t* hk_out, int32_t* hv_out,
    int32_t* count_out, uint8_t* conflict_out, uint8_t* read_hit_out,
    void* scratch, size_t scratch_bytes, void* stream, long long* launches) {
  if ((flag_bytes != 1 && flag_bytes != 4) || !lows) return fdb::ERR_BAD_ARGS;
  In in{hk, hv, snap, too_old, rb, re, rtxn, rvalid, wb, we, wtxn, wvalid,
        commit, oldest, flag_bytes, cap, T, R, Wr, width};
  return resolve_impl(in, lows, highs, S, attribute, hk_out, hv_out,
                      count_out, conflict_out, read_hit_out, scratch,
                      scratch_bytes, static_cast<cudaStream_t>(stream),
                      launches);
}

FDB_API int fdb_resolve_sharded_packed(
    const uint32_t* hk, const int32_t* hv, const uint32_t* buf,
    const uint32_t* lows, const uint32_t* highs, int S, int cap, int T,
    int R, int Wr, int width, int attribute, uint32_t* hk_out,
    int32_t* hv_out, int32_t* count_out, uint8_t* conflict_out,
    uint8_t* read_hit_out, void* scratch, size_t scratch_bytes, void* stream,
    long long* launches) {
  if (!lows) return fdb::ERR_BAD_ARGS;
  return resolve_impl(unpack_feed(hk, hv, buf, cap, T, R, Wr, width), lows,
                      highs, S, attribute, hk_out, hv_out, count_out,
                      conflict_out, read_hit_out, scratch, scratch_bytes,
                      static_cast<cudaStream_t>(stream), launches);
}
