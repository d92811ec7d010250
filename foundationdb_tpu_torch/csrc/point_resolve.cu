// K5: one point-op conflict-resolution step.
//
// Replaces foundationdb_tpu/ops/point_kernel.py:85
// make_point_resolve_core (step :116-231, with :75 _seg_or_scan),
// entered unpacked (:237 make_point_resolve_fn) or packed (:326
// make_point_resolve_packed_fn, a 3-word header). It computes the same
// function, (SK', SV', count, conflict[T], read_hit[R]), over the
// point state
//
//   SK[cap, W+1]  key rows sorted by (key words, version), duplicate
//                 keys allowed (newest last), +inf padded
//   SV[cap]       int32 version offsets
//
// but not by the TPU's route. The TPU sorts everything because its
// scatters and binary searches are slow; here both are cheap, so
//   1. external check: K6 finds each read's key in SK (the reference's
//      exact probe sequence), then one exact row compare and a version
//      test; K1 gives the per-transaction read segments;
//   2. intra-batch order: only the writes are sorted, by (key, txn,
//      slot), as records in sort.cuh (tiles of 512 records in shared
//      memory, then merge-path rounds: 5 at 16,384 writes); a pass over
//      the sorted records gives each write its key's run start (an
//      adjacent-key compare and a block max scan; a block whose first
//      key continues a run finds its start by one warp's 32-way search).
//      A read hits iff an alive write
//      of its key has a smaller txn id, which in that order is a prefix
//      [run start, limit) of the key's run, found once by binary
//      search. This is the reference's "alive write strictly before me
//      in my (key, txn<<1|is_write) run" without sorting the reads;
//   3. fixpoint: ONE cooperative launch runs every round. Per round the
//      first alive write of each run is an integer atomicMin (order-
//      free, so deterministic), a read hits iff that position is below
//      its limit, and the per-transaction OR over the read segment
//      gives the next iterate; a rotating three-slot changed flag ends
//      the loop when two iterates agree, after at most T+2 rounds;
//   4. attribution: read_hit = ext | (snapshot below init_off) | hit at
//      the settled fixpoint (skipped when `attribute` is 0);
//   5. merge + GC: the live state rows (version >= max(oldest, 0), not
//      +inf) are already sorted and the surviving writes come out of
//      step 2 sorted by key with one version (the commit), so each row's
//      output position is its rank in its own list plus a binary-search
//      count in the other (ties compare the whole row, version
//      included). The tail is filled with (+inf, VMASK), the row every
//      masked input becomes in the reference's one big sort; `count` is
//      live + surviving rows before the slice to cap.
// Precondition, which every state a resolver holds satisfies: SK/SV are
// sorted by (key words, version). Everything is integer, so the output
// is bit-identical to the reference's.
//
// Bound: bytes. The live state rows must be read once and the whole
// padded state written once (24 bytes per row at W = 4; 12 MiB at cap
// 2^19), plus the ~1.0 MB feed and the flags: chip_smoke.py computes it
// from the run's live rows. The write sort (a tile pass and
// log2(Wr / 512) merge rounds, each a latency chain) and the per-row
// binary searches are the known excess over that bound. Records hold
// width + 2 words rounded up to 1, 2, 3, 4, 8, 16 or 32 uint4s, so the
// step takes keys of up to 126 words.

#include <cooperative_groups.h>

#include <climits>

#include "common.cuh"
#include "sort.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int SCAN_THREADS = 256;
constexpr int SCAN_ITEMS = 8;
constexpr int TILE = SCAN_THREADS * SCAN_ITEMS;
constexpr int FIX_THREADS = 256;
constexpr int32_t VMASK = fdb::SNAP_CLAMP + 1;  // ops/point_kernel.py VMASK
constexpr int32_t TIE_INVALID = INT_MAX;        // invalid write: after all
constexpr int32_t NONE = 0x7F7F7F7F;            // no alive write in a run

struct In {
  const uint32_t* sk;
  const int32_t* sv;
  const int32_t* snap;
  const void* too_old;
  const uint32_t* rk;
  const int32_t* rtxn;
  const void* rvalid;
  const uint32_t* wk;
  const int32_t* wtxn;
  const void* wvalid;
  const int32_t* commit;
  const int32_t* oldest;
  const int32_t* init_off;
  int flag_bytes;
  int cap, T, R, Wr, width;
};

__device__ __forceinline__ int txn_slot(int t, int T) {
  return min(max(t, 0), T);
}

// ---- 1. external check ----------------------------------------------------
// `found` is K6's right-side count of each read key in SK
__global__ void point_ext_kernel(
    In in, const int32_t* found, uint8_t* ext_r, uint8_t* init_r) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= in.R) return;
  bool valid = fdb::flag_at(in.rvalid, r, in.flag_bytes);
  int rt = in.rtxn[r];
  int32_t s = (rt >= 0 && rt < in.T) ? in.snap[rt] : fdb::SNAP_CLAMP;
  int pos = max(found[r] - 1, 0);
  bool match = fdb::row_cmp(in.sk + (size_t)pos * in.width,
                            in.rk + (size_t)r * in.width, in.width) == 0;
  ext_r[r] = valid && match && in.sv[pos] > s;
  init_r[r] = valid && s < *in.init_off;
}

// base_c = ext | too_old (ext includes "has a read below init_off"),
// with the pad entry T fixed at 1
__global__ void point_base_kernel(
    In in, const int32_t* rs, const uint8_t* ext_r, uint8_t* base, uint8_t* ca,
    uint8_t* cb) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t > in.T) return;
  uint8_t v = 1;
  if (t < in.T) {
    bool any_ext = false, any_read = false;
    for (int r = rs[t]; r < rs[t + 1]; ++r) {
      any_ext |= ext_r[r] != 0;
      any_read |= fdb::flag_at(in.rvalid, r, in.flag_bytes);
    }
    v = any_ext || (any_read && in.snap[t] < *in.init_off) ||
        fdb::flag_at(in.too_old, t, in.flag_bytes);
  }
  base[t] = v;
  ca[t] = v;
  cb[t] = v;
}

// ---- 2. the writes in (key, txn, slot) order -------------------------------
// A record is NV uint4s: the key row (the +inf row for an invalid write),
// the tie (the txn id, TIE_INVALID for an invalid write) with its sign
// bit flipped, so that the unsigned word orders it as a signed int, the
// slot, then zero words. sort.cuh's word order is then (key, txn, slot),
// a total order, and its padding record (all ones) sorts last.
constexpr uint32_t SIGN = 0x80000000u;
constexpr int RUN_THREADS = 256;  // sorted positions per block, runs pass

int rec_nv(int width) { return fdb::rec_uint4s(width + 2); }

template <int NV>
struct WLoad {
  In in;
  __device__ fdb::Rec<NV> operator()(int j) const {
    const int width = in.width;
    const bool valid = fdb::flag_at(in.wvalid, j, in.flag_bytes);
    const uint32_t* row = in.wk + (size_t)j * width;
    const uint32_t tie = (uint32_t)(valid ? in.wtxn[j] : TIE_INVALID) ^ SIGN;
    fdb::Rec<NV> rec;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      uint32_t x[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = 4 * i + q;
        x[q] = k < width        ? (valid ? row[k] : fdb::INF_WORD)
               : k == width     ? tie
               : k == width + 1 ? (uint32_t)j
                                : 0u;
      }
      rec.v[i] = make_uint4(x[0], x[1], x[2], x[3]);
    }
    return rec;
  }
};

// the sorted writes: sorted position p's key row at rec + p * stride
struct Sorted {
  const uint32_t* rec;
  int stride;
  __device__ const uint32_t* key(int p) const {
    return rec + (size_t)p * stride;
  }
};

// first sorted position in [0, n) whose key is >= `key` (key words only)
__device__ int key_lower(const Sorted& ws, int n, const uint32_t* key,
                         int width) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (fdb::row_cmp(ws.key(mid), key, width) < 0) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// every sorted write's tie (stie: its txn id, or TIE_INVALID) and its
// key's run (wrun: the first sorted position of its key). A block takes
// RUN_THREADS consecutive positions: a position starts a run where its
// key differs from the one before it, and a max scan carries the last
// start forward from the block's first position's own run start (itself
// when it starts a run, else one warp's search of the positions before)
__global__ void __launch_bounds__(RUN_THREADS)
    point_runs_kernel(Sorted ws, int Wr, int width, int32_t* stie,
                      int32_t* wrun) {
  __shared__ int carry;
  const int base = blockIdx.x * RUN_THREADS, p = base + threadIdx.x;
  if (threadIdx.x < 32) {
    const uint32_t* key = ws.key(base);
    const bool head =
        base == 0 || fdb::row_cmp(ws.key(base - 1), key, width) != 0;
    const int c =
        head ? base
             : fdb::warp_partition_point(
                   0, base,
                   [&](int m) {
                     return fdb::row_cmp(ws.key(m), key, width) < 0;
                   },
                   threadIdx.x);
    if (threadIdx.x == 0) carry = c;
  }
  int cand = 0;
  if (p < Wr) {
    stie[p] = (int32_t)(ws.key(p)[width] ^ SIGN);
    if (p > 0 && fdb::row_cmp(ws.key(p - 1), ws.key(p), width) != 0)
      cand = p;
  }
  int tot;
  const int run = max(fdb::block_excl_scan<true>(cand, tot), cand);
  if (p < Wr) wrun[p] = max(run, carry);
}

// each valid read: the run of its key among the writes (-1 if none) and
// the end of the run's part with a smaller txn id
__global__ void point_rrun_kernel(In in, Sorted ws, const int32_t* stie,
                                  int32_t* rrun, int32_t* rlim) {
  int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= in.R) return;
  const int width = in.width;
  const uint32_t* key = in.rk + (size_t)r * width;
  int run = -1, lim = 0;
  if (fdb::flag_at(in.rvalid, r, in.flag_bytes)) {
    int lb = key_lower(ws, in.Wr, key, width);
    if (lb < in.Wr && fdb::row_cmp(ws.key(lb), key, width) == 0) {
      int rt = in.rtxn[r];
      int lo = lb, hi = in.Wr;
      while (lo < hi) {
        int mid = (lo + hi) >> 1;
        int c = fdb::row_cmp(ws.key(mid), key, width);
        if (c < 0 || (c == 0 && stie[mid] < rt)) lo = mid + 1; else hi = mid;
      }
      run = lb;
      lim = lo;
    }
  }
  rrun[r] = run;
  rlim[r] = lim;
}

// ---- 3. the fixpoint, one cooperative launch ------------------------------
struct Fix {
  int T, R, Wr, attribute;
  const int32_t* stie;
  const int32_t* wrun;
  const int32_t* rrun;
  const int32_t* rlim;
  const int32_t* rs;
  const uint8_t* base;
  const uint8_t* ext_r;
  const uint8_t* init_r;
  int32_t* first_alive;
  uint8_t* ca;
  uint8_t* cb;
  uint8_t* cfinal;
  uint8_t* hit_r;
  int* flags;
  uint8_t* conflict_out;
  uint8_t* read_hit_out;
};

__device__ void mark_alive(const Fix& f, const uint8_t* c, int gtid,
                           int nthr) {
  for (int p = gtid; p < f.Wr; p += nthr) {
    int tie = f.stie[p];
    if (tie != TIE_INVALID && c[txn_slot(tie, f.T)] == 0)
      atomicMin(&f.first_alive[f.wrun[p]], p);
  }
}

__device__ __forceinline__ bool read_hits(const Fix& f, int r) {
  int run = f.rrun[r];
  return run >= 0 && f.first_alive[run] < f.rlim[r];
}

__global__ void __launch_bounds__(FIX_THREADS) point_fixpoint_kernel(Fix f) {
  cg::grid_group grid = cg::this_grid();
  const int gtid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthr = gridDim.x * blockDim.x;
  uint8_t* cur = f.ca;
  uint8_t* nxt = f.cb;
  int i = 0;
  while (true) {
    if (gtid == 0) f.flags[(i + 1) % 3] = 0;
    mark_alive(f, cur, gtid, nthr);
    grid.sync();
    for (int r = gtid; r < f.R; r += nthr) f.hit_r[r] = read_hits(f, r);
    grid.sync();
    for (int p = gtid; p < f.Wr; p += nthr) f.first_alive[p] = NONE;
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
  mark_alive(f, cur, gtid, nthr);
  grid.sync();
  for (int r = gtid; r < f.R; r += nthr)
    f.read_hit_out[r] = f.ext_r[r] | f.init_r[r] | (read_hits(f, r) ? 1 : 0);
}

// ---- 4. merge + GC ---------------------------------------------------------
struct LiveFlag {  // state row i survives GC
  const uint32_t* sk;
  const int32_t* sv;
  const int32_t* oldest;
  int width;
  __device__ int operator()(int i) const {
    return sv[i] >= max(*oldest, 0) &&
           sk[(size_t)i * width + width - 1] != fdb::INF_WORD;
  }
};

struct SurvFlag {  // sorted write p survives and sorts at or below VMASK
  Sorted ws;
  const int32_t* stie;
  const uint8_t* cfinal;
  const int32_t* commit;
  int T, width;
  __device__ bool survives(int p) const {
    int tie = stie[p];
    return tie != TIE_INVALID && cfinal[txn_slot(tie, T)] == 0;
  }
  // a surviving (+inf, commit > VMASK) row sorts after every masked row,
  // so it lands past cap: counted, never stored
  __device__ bool past_masks(int p) const {
    return *commit > VMASK && fdb::row_is_inf(ws.key(p), width);
  }
  __device__ int operator()(int p) const {
    return survives(p) && !past_masks(p);
  }
};

template <class F>
__global__ void point_tile_reduce_kernel(F f, int n, int32_t* agg) {
  int base = blockIdx.x * TILE + threadIdx.x * SCAN_ITEMS;
  int cnt = 0;
  for (int k = 0; k < SCAN_ITEMS && base + k < n; ++k) cnt += f(base + k);
  int tot;
  fdb::block_excl_scan<false>(cnt, tot);
  if (threadIdx.x == 0) agg[blockIdx.x] = tot;
}

// per element: the exclusive count (`excl`), and for flagged elements
// their index in the compacted list (`list`, optional)
template <class F>
__global__ void point_tile_apply_kernel(F f, int n, const int32_t* pre,
                                        int32_t* excl, int32_t* list) {
  int base = blockIdx.x * TILE + threadIdx.x * SCAN_ITEMS;
  int fl[SCAN_ITEMS];
  int cnt = 0;
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    fl[k] = base + k < n ? f(base + k) : 0;
    cnt += fl[k];
  }
  int tot;
  int pos = pre[blockIdx.x] + fdb::block_excl_scan<false>(cnt, tot);
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    int p = base + k;
    if (p >= n) break;
    excl[p] = pos;
    if (list && fl[k]) list[pos] = p;
    pos += fl[k];
  }
}

__global__ void point_past_masks_kernel(SurvFlag f, int Wr, int* n_past) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < Wr && f.survives(p) && f.past_masks(p)) atomicAdd(n_past, 1);
}

// (key a, va) < (key b, vb), the full-row order of the merge
__device__ __forceinline__ bool row_less(const uint32_t* a, int32_t va,
                                         const uint32_t* b, int32_t vb,
                                         int width) {
  int c = fdb::row_cmp(a, b, width);
  return c < 0 || (c == 0 && va < vb);
}

// live state row i: after every live row before it and every
// surviving write strictly below it
__global__ void point_scatter_live_kernel(
    In in, LiveFlag live, const int32_t* live_pre, const int32_t* slist,
    Sorted ws, const int32_t* n_s_p, uint32_t* sk_out, int32_t* sv_out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= in.cap || !live(i)) return;
  const int width = in.width;
  const uint32_t* key = in.sk + (size_t)i * width;
  const int32_t v = in.sv[i], commit = *in.commit;
  int lo = 0, hi = *n_s_p;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    const uint32_t* w = ws.key(slist[mid]);
    if (row_less(w, commit, key, v, width)) lo = mid + 1; else hi = mid;
  }
  int pos = live_pre[i] + lo;
  if (pos >= in.cap) return;
  for (int k = 0; k < width; ++k) sk_out[(size_t)pos * width + k] = key[k];
  sv_out[pos] = v;
}

// surviving write k (in key order): after every surviving write before
// it and every live state row at or below it (state rows win ties)
__global__ void point_scatter_surv_kernel(
    In in, const int32_t* live_pre, const int32_t* slist, Sorted ws,
    const int32_t* n_s_p, uint32_t* sk_out, int32_t* sv_out) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= *n_s_p) return;
  const int width = in.width;
  const uint32_t* key = ws.key(slist[k]);
  const int32_t commit = *in.commit;
  int lo = 0, hi = in.cap;  // state rows <= (key, commit): a prefix
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (!row_less(key, commit, in.sk + (size_t)mid * width, in.sv[mid],
                  width))
      lo = mid + 1;
    else
      hi = mid;
  }
  int pos = k + live_pre[lo];
  if (pos >= in.cap) return;
  for (int w = 0; w < width; ++w) sk_out[(size_t)pos * width + w] = key[w];
  sv_out[pos] = commit;
}

__global__ void point_fill_tail_kernel(
    uint32_t* sk_out, int32_t* sv_out, int cap, int width,
    const int32_t* n_live, const int32_t* n_s, const int* n_past,
    int32_t* count_out) {
  int q = blockIdx.x * blockDim.x + threadIdx.x;
  int stored = *n_live + *n_s;
  if (q == 0) *count_out = stored + *n_past;
  if (q >= cap || q < stored) return;
  for (int w = 0; w < width; ++w) sk_out[(size_t)q * width + w] = fdb::INF_WORD;
  sv_out[q] = VMASK;
}

// ---- scratch layout -------------------------------------------------------
struct Scratch {
  int32_t *rs, *found, *stie, *wrun, *first_alive;
  int32_t *rrun, *rlim, *live_pre, *spre, *slist;
  int32_t *agg_live, *pre_live, *agg_surv, *pre_surv;
  uint8_t *ext_r, *init_r, *base, *ca, *cb, *cfinal, *hit_r;
  uint4 *rec_a, *rec_b;
  int *flags, *n_past;
};

size_t carve(Scratch& s, char* base, int cap, int T, int R, int Wr,
             int width) {
  fdb::Carver c{base, 0};
  int tiles_cap = (cap + TILE - 1) / TILE, tiles_w = (Wr + TILE - 1) / TILE;
  s.rs = c.take<int32_t>(T + 2);
  s.found = c.take<int32_t>(R);
  s.ext_r = c.take<uint8_t>(R);
  s.init_r = c.take<uint8_t>(R);
  s.base = c.take<uint8_t>(T + 1);
  s.ca = c.take<uint8_t>(T + 1);
  s.cb = c.take<uint8_t>(T + 1);
  s.cfinal = c.take<uint8_t>(T + 1);
  s.hit_r = c.take<uint8_t>(R);
  s.flags = c.take<int>(4);
  s.n_past = c.take<int>(1);
  s.rec_a = c.take<uint4>((size_t)Wr * rec_nv(width));
  s.rec_b = c.take<uint4>((size_t)Wr * rec_nv(width));
  s.stie = c.take<int32_t>(Wr);
  s.wrun = c.take<int32_t>(Wr);
  s.first_alive = c.take<int32_t>(Wr);
  s.rrun = c.take<int32_t>(R);
  s.rlim = c.take<int32_t>(R);
  s.live_pre = c.take<int32_t>((size_t)cap + 1);
  s.spre = c.take<int32_t>((size_t)Wr + 1);
  s.slist = c.take<int32_t>(Wr);
  s.agg_live = c.take<int32_t>(tiles_cap);
  s.pre_live = c.take<int32_t>(tiles_cap);
  s.agg_surv = c.take<int32_t>(tiles_w);
  s.pre_surv = c.take<int32_t>(tiles_w);
  return c.off;
}

// the write sort: the sorted records land in *sorted
int write_sort(const In& in, const Scratch& s, const uint4** sorted,
               cudaStream_t st) {
  return fdb::with_rec_uint4s(in.width + 2, [&](auto nv) -> int {
    constexpr int NV = decltype(nv)::value;
    FDB_TRY((fdb::rec_sort<NV>(WLoad<NV>{in}, fdb::NoPlace{}, in.Wr,
                               s.rec_a, s.rec_b, sorted, st)));
    return 0;
  });
}

int point_impl(const In& in, int attribute, uint32_t* sk_out, int32_t* sv_out,
               int32_t* count_out, uint8_t* conflict_out,
               uint8_t* read_hit_out, void* scratch, size_t scratch_bytes,
               cudaStream_t st, long long* launches) {
  const int cap = in.cap, T = in.T, R = in.R, Wr = in.Wr, width = in.width;
  if (cap < 1 || (cap & (cap - 1)) || T < 1 || R < 1 || (R & (R - 1)) ||
      Wr < 1 || width < 1 || !rec_nv(width) || !sk_out || !sv_out ||
      !count_out || !conflict_out || (attribute && !read_hit_out) ||
      sk_out == in.sk || sv_out == in.sv)
    return fdb::ERR_BAD_ARGS;
  long long unused[2] = {0, 0};
  if (!launches) launches = unused;
  Scratch s;
  if (carve(s, nullptr, cap, T, R, Wr, width) > scratch_bytes)
    return fdb::ERR_SCRATCH;
  carve(s, static_cast<char*>(scratch), cap, T, R, Wr, width);
  const int tiles_cap = (cap + TILE - 1) / TILE;
  const int tiles_w = (Wr + TILE - 1) / TILE;

  // 1. external check: K1 segment starts, K6 lookup, flags
  FDB_TRY(fdb_searchsorted_launch(in.rtxn, R, nullptr, T + 2, 0, s.rs, st));
  launches[0] += 1;
  FDB_TRY(fdb_searchsorted_rows_launch(in.sk, cap, width, in.rk, R, nullptr,
                                       1, s.found, st));
  launches[1] += 1;
  point_ext_kernel<<<fdb::blocks_for(R, 256), 256, 0, st>>>(
      in, s.found, s.ext_r, s.init_r);
  FDB_LAUNCHED();
  point_base_kernel<<<fdb::blocks_for(T + 1, 256), 256, 0, st>>>(
      in, s.rs, s.ext_r, s.base, s.ca, s.cb);
  FDB_LAUNCHED();

  // 2. the writes sorted by (key, txn, slot); runs and read limits
  const uint4* sorted = nullptr;
  int e = write_sort(in, s, &sorted, st);
  if (e) return e;
  const Sorted ws{reinterpret_cast<const uint32_t*>(sorted),
                  4 * rec_nv(width)};
  point_runs_kernel<<<fdb::blocks_for(Wr, RUN_THREADS), RUN_THREADS, 0,
                      st>>>(ws, Wr, width, s.stie, s.wrun);
  FDB_LAUNCHED();
  point_rrun_kernel<<<fdb::blocks_for(R, 256), 256, 0, st>>>(
      in, ws, s.stie, s.rrun, s.rlim);
  FDB_LAUNCHED();

  // 3. fixpoint (+ attribution)
  FDB_TRY(cudaMemsetAsync(s.flags, 0, 4 * sizeof(int), st));
  FDB_TRY(cudaMemsetAsync(s.first_alive, 0x7F, (size_t)Wr * sizeof(int32_t),
                          st));
  Fix f{T, R, Wr, attribute, s.stie, s.wrun, s.rrun, s.rlim, s.rs,
        s.base, s.ext_r, s.init_r, s.first_alive, s.ca, s.cb, s.cfinal,
        s.hit_r, s.flags, conflict_out, read_hit_out};
  int needed = max(max(fdb::blocks_for(R, FIX_THREADS),
                       fdb::blocks_for(T + 1, FIX_THREADS)),
                   fdb::blocks_for(Wr, FIX_THREADS));
  void* args[] = {&f};
  int grid = fdb::coop_grid<point_fixpoint_kernel, FIX_THREADS>(needed);
  FDB_TRY(cudaLaunchCooperativeKernel((void*)point_fixpoint_kernel,
                                      dim3(grid), dim3(FIX_THREADS), args, 0,
                                      st));
  FDB_LAUNCHED();

  // 4. merge + GC: ranks of the live rows and the surviving writes
  LiveFlag live{in.sk, in.sv, in.oldest, width};
  point_tile_reduce_kernel<<<tiles_cap, SCAN_THREADS, 0, st>>>(
      live, cap, s.agg_live);
  FDB_LAUNCHED();
  fdb::scan_tiles_kernel<false><<<1, 1024, 0, st>>>(
      s.agg_live, s.pre_live, tiles_cap, s.live_pre + cap);
  FDB_LAUNCHED();
  point_tile_apply_kernel<<<tiles_cap, SCAN_THREADS, 0, st>>>(
      live, cap, s.pre_live, s.live_pre, nullptr);
  FDB_LAUNCHED();
  SurvFlag surv{ws, s.stie, s.cfinal, in.commit, T, width};
  point_tile_reduce_kernel<<<tiles_w, SCAN_THREADS, 0, st>>>(surv, Wr,
                                                             s.agg_surv);
  FDB_LAUNCHED();
  fdb::scan_tiles_kernel<false><<<1, 1024, 0, st>>>(
      s.agg_surv, s.pre_surv, tiles_w, s.spre + Wr);
  FDB_LAUNCHED();
  point_tile_apply_kernel<<<tiles_w, SCAN_THREADS, 0, st>>>(
      surv, Wr, s.pre_surv, s.spre, s.slist);
  FDB_LAUNCHED();
  FDB_TRY(cudaMemsetAsync(s.n_past, 0, sizeof(int), st));
  point_past_masks_kernel<<<fdb::blocks_for(Wr, 256), 256, 0, st>>>(
      surv, Wr, s.n_past);
  FDB_LAUNCHED();
  point_scatter_live_kernel<<<fdb::blocks_for(cap, 256), 256, 0, st>>>(
      in, live, s.live_pre, s.slist, ws, s.spre + Wr, sk_out, sv_out);
  FDB_LAUNCHED();
  point_scatter_surv_kernel<<<fdb::blocks_for(Wr, 256), 256, 0, st>>>(
      in, s.live_pre, s.slist, ws, s.spre + Wr, sk_out, sv_out);
  FDB_LAUNCHED();
  point_fill_tail_kernel<<<fdb::blocks_for(cap, 256), 256, 0, st>>>(
      sk_out, sv_out, cap, width, s.live_pre + cap, s.spre + Wr, s.n_past,
      count_out);
  FDB_LAUNCHED();
  return 0;
}

}  // namespace

FDB_API size_t fdb_point_resolve_scratch_bytes(int cap, int T, int R, int Wr,
                                               int width) {
  Scratch s;
  return carve(s, nullptr, cap, T, R, Wr, width);
}

FDB_API int fdb_point_resolve(const uint32_t* sk, const int32_t* sv,
                              const int32_t* snap, const void* too_old,
                              const uint32_t* rk, const int32_t* rtxn,
                              const void* rvalid, const uint32_t* wk,
                              const int32_t* wtxn, const void* wvalid,
                              const int32_t* commit, const int32_t* oldest,
                              const int32_t* init_off, int flag_bytes,
                              int cap, int T, int R, int Wr, int width,
                              int attribute, uint32_t* sk_out,
                              int32_t* sv_out, int32_t* count_out,
                              uint8_t* conflict_out, uint8_t* read_hit_out,
                              void* scratch, size_t scratch_bytes,
                              void* stream, long long* launches) {
  if (flag_bytes != 1 && flag_bytes != 4) return fdb::ERR_BAD_ARGS;
  In in{sk, sv, snap, too_old, rk, rtxn, rvalid, wk, wtxn, wvalid,
        commit, oldest, init_off, flag_bytes, cap, T, R, Wr, width};
  return point_impl(in, attribute, sk_out, sv_out, count_out, conflict_out,
                    read_hit_out, scratch, scratch_bytes,
                    static_cast<cudaStream_t>(stream), launches);
}

// the packed feed (ops/point_kernel.py point_batch_views): a 3-word
// header [commit, oldest, init_off], then the 8 arrays, read in place
FDB_API int fdb_point_resolve_packed(const uint32_t* sk, const int32_t* sv,
                                     const uint32_t* buf, int cap, int T,
                                     int R, int Wr, int width, int attribute,
                                     uint32_t* sk_out, int32_t* sv_out,
                                     int32_t* count_out,
                                     uint8_t* conflict_out,
                                     uint8_t* read_hit_out, void* scratch,
                                     size_t scratch_bytes, void* stream,
                                     long long* launches) {
  size_t o = 3;
  auto take = [&](size_t n) {
    const uint32_t* p = buf + o;
    o += n;
    return p;
  };
  const int32_t* hdr = reinterpret_cast<const int32_t*>(buf);
  const int32_t* snap = reinterpret_cast<const int32_t*>(take(T));
  const uint32_t* too_old = take(T);
  const uint32_t* rk = take((size_t)R * width);
  const int32_t* rtxn = reinterpret_cast<const int32_t*>(take(R));
  const uint32_t* rvalid = take(R);
  const uint32_t* wk = take((size_t)Wr * width);
  const int32_t* wtxn = reinterpret_cast<const int32_t*>(take(Wr));
  const uint32_t* wvalid = take(Wr);
  In in{sk, sv, snap, too_old, rk, rtxn, rvalid, wk, wtxn, wvalid,
        hdr, hdr + 1, hdr + 2, 4, cap, T, R, Wr, width};
  return point_impl(in, attribute, sk_out, sv_out, count_out, conflict_out,
                    read_hit_out, scratch, scratch_bytes,
                    static_cast<cudaStream_t>(stream), launches);
}
