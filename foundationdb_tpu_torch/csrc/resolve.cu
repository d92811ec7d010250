// K3: one conflict-resolution step over the interval history.
//
// Replaces foundationdb_tpu/ops/conflict_kernel.py:138 make_resolve_core
// (step :187-425), entered packed (:586 make_resolve_packed_fn, :551
// make_interval_unpack) or unpacked (:431 make_resolve_fn). It computes
// the same function, (HK', HV', count, conflict[T], read_hit[R]), but
// not by the TPU's route: the TPU ranks keys by sorting because its
// scatters and binary searches are slow; here binary searches into the
// sorted history and conflict-free scatters are cheap, so
//   1. external check: one binary search per read bound into HK (the
//      history is sorted), then K2 range max over HV and K1 for the
//      per-transaction read segments;
//   2. intra-batch check: the read x write overlap matrix is built by
//      direct lexicographic compares (32 writes per uint32 lane, as the
//      reference packs it), and the antitone fixpoint runs inside ONE
//      cooperative launch with grid-wide barriers between its phases:
//      no host round trip per round;
//   3. attribution: one more masked pass over the matrix at the
//      fixpoint (skipped when `attribute` is 0);
//   4. merge: only the 2*Wr boundaries of surviving writes are sorted
//      (merge rounds, ties broken by original index, which equals the
//      reference's stable order); a merge-path scatter interleaves them
//      with the already sorted history, and two tiled scans give the
//      covering version and the coverage count;
//   5. GC + compaction: keep flags exactly as the reference computes
//      them, then a prefix sum and a scatter pack the kept rows; the
//      tail is filled with +inf / VDEAD.
// The output state is canonical, so it is bit-identical to the
// reference's. Bound: bytes. The live history rows must be read once
// and the whole padded history written once (24 bytes per row at W = 4:
// at cap 2^20 with ~650K live rows, ~16 MB read and 24 MiB written) plus
// the 1.7 MB feed: ~13 us at 3.35 TB/s (chip_smoke.py computes it from
// the run's live rows). The dense overlap matrix (R x Wr bits, 32 MiB at
// the slice's shapes) and its compares are the known excess over that
// bound, left for a later rank-space formulation.

#include <cooperative_groups.h>

#include <climits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int SCAN_THREADS = 256;
constexpr int SCAN_ITEMS = 8;
constexpr int TILE = SCAN_THREADS * SCAN_ITEMS;
constexpr int OV_LANES = 8;    // uint32 lanes (x 32 writes) per block
constexpr int OV_READS = 128;  // reads per block
constexpr int FIX_THREADS = 256;

struct In {
  const uint32_t* hk;
  const int32_t* hv;
  const int32_t* snap;
  const void* too_old;
  const uint32_t* rb;
  const uint32_t* re;
  const int32_t* rtxn;
  const void* rvalid;
  const uint32_t* wb;
  const uint32_t* we;
  const int32_t* wtxn;
  const void* wvalid;
  const int32_t* commit;
  const int32_t* oldest;
  int flag_bytes;
  int cap, T, R, Wr, width;
};

// the merged sequence: position p holds history row src[p] (< cap) or
// sorted-boundary row src[p] - cap
struct Merged {
  const uint32_t* hk;
  const int32_t* hv;
  const uint32_t* ins_k;
  const int32_t* ins_tie;
  const int32_t* src;
  int cap, width, mtot;
  __device__ const uint32_t* key(int p) const {
    int s = src[p];
    return s < cap ? hk + (size_t)s * width
                   : ins_k + (size_t)(s - cap) * width;
  }
  __device__ int tie(int p) const {
    int s = src[p];
    return s < cap ? 1 : ins_tie[s - cap];
  }
  __device__ int32_t vcol(int p) const {
    int s = src[p];
    return s < cap ? hv[s] : fdb::VDEAD;
  }
};

template <bool MAX>
__device__ __forceinline__ int op(int a, int b) {
  return MAX ? max(a, b) : a + b;
}

// exclusive block scan (identity 0: every scanned value is >= 0 for the
// max scans, and sums start at 0); `total` gets the block's reduction
template <bool MAX>
__device__ int block_excl_scan(int v, int& total) {
  __shared__ int wt[32];
  int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int nw = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x = op<MAX>(y, x);
  }
  if (lane == 31) wt[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int w = lane < nw ? wt[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(FULL, w, o);
      if (lane >= o) w = op<MAX>(y, w);
    }
    if (lane < nw) wt[lane] = w;
  }
  __syncthreads();
  int wpre = wid ? wt[wid - 1] : 0;
  total = wt[nw - 1];
  int incl = op<MAX>(wpre, x);
  int excl = __shfl_up_sync(FULL, incl, 1);
  if (lane == 0) excl = wpre;
  __syncthreads();
  return excl;
}

// ---- 1. external check ----------------------------------------------------
__global__ void ext_bounds_kernel(In in, int32_t* lo, int32_t* hi) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= in.R) return;
  size_t o = (size_t)i * in.width;
  lo[i] = fdb::row_bound(in.hk, in.cap, in.rb + o, in.width, true) - 1;
  hi[i] = fdb::row_bound(in.hk, in.cap, in.re + o, in.width, false);
}

__global__ void ext_flags_kernel(In in, const int32_t* vmax, uint8_t* ext_r) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= in.R) return;
  int rt = in.rtxn[i];
  int32_t s = (rt >= 0 && rt < in.T) ? in.snap[rt] : fdb::SNAP_CLAMP;
  ext_r[i] = fdb::flag_at(in.rvalid, i, in.flag_bytes) && vmax[i] > s;
}

// base_c = ext | too_old, with the pad entry T fixed at 1
__global__ void base_kernel(In in, const int32_t* rs, const uint8_t* ext_r,
                            uint8_t* base, uint8_t* ca, uint8_t* cb) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t > in.T) return;
  uint8_t v = 1;
  if (t < in.T) {
    bool any = false;
    for (int r = rs[t]; r < rs[t + 1]; ++r) any |= ext_r[r] != 0;
    v = any || fdb::flag_at(in.too_old, t, in.flag_bytes);
  }
  base[t] = v;
  ca[t] = v;
  cb[t] = v;
}

// ---- 2. overlap matrix ------------------------------------------------------
// ovp[r * n_lanes + l] bit b <=> read r overlaps write 32*l + b of an
// earlier transaction, both valid: wb < re and rb < we
__global__ void overlap_kernel(In in, int n_lanes, uint32_t* ovp) {
  extern __shared__ uint32_t sm[];
  const int width = in.width, nw = OV_LANES * 32;
  uint32_t* s_wb = sm;
  uint32_t* s_we = sm + nw * width;
  int32_t* s_wt = reinterpret_cast<int32_t*>(s_we + nw * width);
  int w0 = blockIdx.x * nw;
  int nwr = min(nw, in.Wr - w0);
  // write w (lane w / 32, bit w % 32) lives in slot (w % 32) * OV_LANES +
  // w / 32: the OV_LANES threads of a warp that read bit b of their
  // lanes then touch consecutive slots, so no two hit one bank
  for (int k = threadIdx.x; k < nw * width; k += blockDim.x) {
    int w = k / width;
    int at = ((w % 32) * OV_LANES + w / 32) * width + (k - w * width);
    bool ok = w < nwr;
    s_wb[at] = ok ? in.wb[(size_t)w0 * width + k] : 0u;
    s_we[at] = ok ? in.we[(size_t)w0 * width + k] : 0u;
  }
  for (int k = threadIdx.x; k < nw; k += blockDim.x)
    s_wt[(k % 32) * OV_LANES + k / 32] =
        (k < nwr && fdb::flag_at(in.wvalid, w0 + k, in.flag_bytes))
            ? in.wtxn[w0 + k] : INT_MAX;  // invalid: never earlier
  __syncthreads();
  int lx = threadIdx.x % OV_LANES, ry = threadIdx.x / OV_LANES;
  int lane = blockIdx.x * OV_LANES + lx;
  int rstep = blockDim.x / OV_LANES;
  if (lane >= n_lanes) return;
  for (int r = blockIdx.y * OV_READS + ry;
       r < min(in.R, (int)(blockIdx.y + 1) * OV_READS); r += rstep) {
    uint32_t bits = 0;
    if (fdb::flag_at(in.rvalid, r, in.flag_bytes)) {
      int rt = in.rtxn[r];
      const uint32_t* rbr = in.rb + (size_t)r * width;
      const uint32_t* rer = in.re + (size_t)r * width;
      for (int b = 0; b < 32; ++b) {
        int sl = b * OV_LANES + lx;
        if (s_wt[sl] < rt &&
            fdb::row_cmp(s_wb + sl * width, rer, width) < 0 &&
            fdb::row_cmp(rbr, s_we + sl * width, width) < 0)
          bits |= 1u << b;
      }
    }
    ovp[(size_t)r * n_lanes + lane] = bits;
  }
}

// ---- 2b. the fixpoint, one cooperative launch ------------------------------
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
    if (lane == 0) f.read_hit_out[r] = h || f.ext_r[r];
  }
}

// ---- 3. merge ----------------------------------------------------------------
// boundary rows of surviving writes: wb with tie 6, we with tie 4; the
// others become +inf with tie 1 (ops/conflict_kernel.py:348-363)
__global__ void ins_build_kernel(In in, const uint8_t* cfinal,
                                 uint32_t* ins_k, int32_t* ins_tie,
                                 int32_t* idx) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= 2 * in.Wr) return;
  bool is_b = j < in.Wr;
  int w = is_b ? j : j - in.Wr;
  int t = min(max(in.wtxn[w], 0), in.T);
  bool surv = fdb::flag_at(in.wvalid, w, in.flag_bytes) && cfinal[t] == 0;
  const uint32_t* row = (is_b ? in.wb : in.we) + (size_t)w * in.width;
  for (int k = 0; k < in.width; ++k)
    ins_k[(size_t)j * in.width + k] = surv ? row[k] : fdb::INF_WORD;
  ins_tie[j] = surv ? (is_b ? 6 : 4) : 1;
  idx[j] = j;
}

__device__ __forceinline__ int ins_cmp(const uint32_t* ins_k,
                                       const int32_t* ins_tie, int width,
                                       int a, int b) {
  int c = fdb::row_cmp(ins_k + (size_t)a * width, ins_k + (size_t)b * width,
                       width);
  if (c) return c;
  if (ins_tie[a] != ins_tie[b]) return ins_tie[a] < ins_tie[b] ? -1 : 1;
  return a < b ? -1 : (a > b ? 1 : 0);
}

// one merge round of a merge sort over a total order (key, tie, index):
// runs of `run` sorted elements pair up; an element lands at its offset
// in its run plus the count of smaller elements in the partner run
__global__ void sort_round_kernel(const uint32_t* ins_k,
                                  const int32_t* ins_tie, int width,
                                  const int32_t* in, int32_t* out, int n,
                                  int run) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  int me = in[p];
  int rid = p / run, start = rid * run;
  int pstart = (rid ^ 1) * run;
  if (pstart >= n) {
    out[p] = me;
    return;
  }
  int plen = min(run, n - pstart);
  int lo = 0, hi = plen;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (ins_cmp(ins_k, ins_tie, width, in[pstart + mid], me) < 0)
      lo = mid + 1;
    else
      hi = mid;
  }
  out[min(start, pstart) + (p - start) + lo] = me;
}

// history row i: preceded by every boundary with (key, tie) < (hk[i], 1)
__global__ void merge_hist_kernel(In in, const uint32_t* ins_k,
                                  const int32_t* ins_tie, const int32_t* sidx,
                                  int n_s, int32_t* src) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= in.cap) return;
  const uint32_t* key = in.hk + (size_t)i * in.width;
  int lo = 0, hi = n_s;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    int e = sidx[mid];
    int c = fdb::row_cmp(ins_k + (size_t)e * in.width, key, in.width);
    if (c < 0 || (c == 0 && ins_tie[e] < 1)) lo = mid + 1; else hi = mid;
  }
  src[i + lo] = i;
}

// sorted boundary j: preceded by every history row with key <= its key
// (history rows have tie 1 <= every boundary tie, and come first on ties)
__global__ void merge_ins_kernel(In in, const uint32_t* ins_k,
                                 const int32_t* sidx, int n_s, int32_t* src) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_s) return;
  int e = sidx[j];
  int ub = fdb::row_bound(in.hk, in.cap, ins_k + (size_t)e * in.width,
                          in.width, true);
  src[j + ub] = in.cap + e;
}

// pass A of the first scan: per tile, the last history-or-masked row
// (max index) and the coverage delta sum
__global__ void cover_reduce_kernel(Merged m, int32_t* agg_max,
                                    int32_t* agg_sum) {
  int base = blockIdx.x * TILE + threadIdx.x * SCAN_ITEMS;
  int tmax = 0, tsum = 0;
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    int p = base + k;
    if (p >= m.mtot) break;
    int tie = m.tie(p);
    if (tie < 4) tmax = max(tmax, p); else tsum += tie - 5;
  }
  int totm, tots;
  block_excl_scan<true>(tmax, totm);
  block_excl_scan<false>(tsum, tots);
  if (threadIdx.x == 0) {
    agg_max[blockIdx.x] = totm;
    agg_sum[blockIdx.x] = tots;
  }
}

// exclusive scan of per-tile aggregates by one block; `total` optional
template <bool MAX>
__global__ void scan_tiles_kernel(const int32_t* agg, int32_t* pre, int n,
                                  int32_t* total) {
  int carry = 0;
  for (int base = 0; base < n; base += blockDim.x) {
    int i = base + threadIdx.x;
    int tot;
    int ex = block_excl_scan<MAX>(i < n ? agg[i] : 0, tot);
    if (i < n) pre[i] = op<MAX>(carry, ex);
    carry = op<MAX>(carry, tot);
  }
  if (total && threadIdx.x == 0) *total = carry;
}

// pass B: covering version (carry-last over history rows) and coverage
// (inclusive delta sum) per merged row; covered rows take the commit
__global__ void cover_apply_kernel(Merged m, const int32_t* pre_max,
                                   const int32_t* pre_sum,
                                   const int32_t* commit_p, int32_t* mv) {
  int base = blockIdx.x * TILE + threadIdx.x * SCAN_ITEMS;
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
  int runm = max(pre_max[blockIdx.x], block_excl_scan<true>(tmax, totm));
  int runs = pre_sum[blockIdx.x] + block_excl_scan<false>(tsum, tots);
  const int32_t commit = *commit_p;
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    int p = base + k;
    runm = max(runm, cand[k]);
    runs += d[k];
    if (p < m.mtot) {
      int32_t v = m.vcol(runm);
      mv[p] = runs > 0 ? max(v, commit) : v;
    }
  }
}

// ---- 4. GC + compaction ------------------------------------------------------
__device__ bool keep_row(const Merged& m, const int32_t* mv, int p,
                         int32_t oldest2) {
  const uint32_t* kp = m.key(p);
  bool run_end = p == m.mtot - 1 ||
                 fdb::row_cmp(kp, m.key(p + 1), m.width) != 0;
  if (!run_end) return false;
  if (p > 0 && fdb::row_cmp(m.key(p - 1), kp, m.width) != 0) {
    int32_t v = mv[p], pv = mv[p - 1];
    if (v == pv || (v < oldest2 && pv < oldest2)) return false;
  }
  return !fdb::row_is_inf(kp, m.width);
}

__global__ void keep_reduce_kernel(Merged m, const int32_t* mv,
                                   const int32_t* oldest_p, uint8_t* keepf,
                                   int32_t* agg) {
  int base = blockIdx.x * TILE + threadIdx.x * SCAN_ITEMS;
  int32_t oldest2 = max(*oldest_p, 0);
  int cnt = 0;
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    int p = base + k;
    if (p >= m.mtot) break;
    bool kp = keep_row(m, mv, p, oldest2);
    keepf[p] = kp;
    cnt += kp;
  }
  int tot;
  block_excl_scan<false>(cnt, tot);
  if (threadIdx.x == 0) agg[blockIdx.x] = tot;
}

__global__ void compact_kernel(Merged m, const int32_t* mv,
                               const uint8_t* keepf, const int32_t* pre,
                               uint32_t* hk_out, int32_t* hv_out) {
  int base = blockIdx.x * TILE + threadIdx.x * SCAN_ITEMS;
  int cnt = 0;
  for (int k = 0; k < SCAN_ITEMS; ++k)
    if (base + k < m.mtot) cnt += keepf[base + k];
  int tot;
  int pos = pre[blockIdx.x] + block_excl_scan<false>(cnt, tot);
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    int p = base + k;
    if (p >= m.mtot || !keepf[p]) continue;
    if (pos < m.cap) {
      const uint32_t* kp = m.key(p);
      for (int w = 0; w < m.width; ++w)
        hk_out[(size_t)pos * m.width + w] = kp[w];
      hv_out[pos] = mv[p];
    }
    ++pos;
  }
}

__global__ void fill_tail_kernel(uint32_t* hk_out, int32_t* hv_out, int cap,
                                 int width, const int32_t* count) {
  int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= cap || q < *count) return;
  for (int w = 0; w < width; ++w) hk_out[(size_t)q * width + w] = fdb::INF_WORD;
  hv_out[q] = fdb::VDEAD;
}

// ---- scratch layout ------------------------------------------------------------
struct Scratch {
  int32_t *lo, *hi, *vmax, *rs;
  char* rmq;
  uint8_t *ext_r, *base, *ca, *cb, *cfinal, *hit_r, *keepf;
  int* flags;
  uint32_t *alive_p, *ovp, *ins_k;
  int32_t *ins_tie, *sidx_a, *sidx_b, *src, *mv;
  int32_t *agg_max, *agg_sum, *pre_max, *pre_sum, *agg_keep, *pre_keep;
};

size_t carve(Scratch& s, char* base, int cap, int T, int R, int Wr,
             int width) {
  fdb::Carver c{base, 0};
  int n_lanes = (Wr + 31) / 32, n_s = 2 * Wr, mtot = cap + n_s;
  int n_tiles = (mtot + TILE - 1) / TILE;
  s.lo = c.take<int32_t>(R);
  s.hi = c.take<int32_t>(R);
  s.vmax = c.take<int32_t>(R);
  s.rmq = c.take<char>(fdb_range_max_scratch(cap));
  s.rs = c.take<int32_t>(T + 2);
  s.ext_r = c.take<uint8_t>(R);
  s.base = c.take<uint8_t>(T + 1);
  s.ca = c.take<uint8_t>(T + 1);
  s.cb = c.take<uint8_t>(T + 1);
  s.cfinal = c.take<uint8_t>(T + 1);
  s.flags = c.take<int>(4);
  s.alive_p = c.take<uint32_t>(n_lanes);
  s.hit_r = c.take<uint8_t>(R);
  s.ovp = c.take<uint32_t>((size_t)R * n_lanes);
  s.ins_k = c.take<uint32_t>((size_t)n_s * width);
  s.ins_tie = c.take<int32_t>(n_s);
  s.sidx_a = c.take<int32_t>(n_s);
  s.sidx_b = c.take<int32_t>(n_s);
  s.src = c.take<int32_t>(mtot);
  s.mv = c.take<int32_t>(mtot);
  s.keepf = c.take<uint8_t>(mtot);
  s.agg_max = c.take<int32_t>(n_tiles);
  s.agg_sum = c.take<int32_t>(n_tiles);
  s.pre_max = c.take<int32_t>(n_tiles);
  s.pre_sum = c.take<int32_t>(n_tiles);
  s.agg_keep = c.take<int32_t>(n_tiles);
  s.pre_keep = c.take<int32_t>(n_tiles);
  return c.off;
}

int fixpoint_grid(int needed_blocks) {
  static int cached_dev = -1, cached_max = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev != cached_dev) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fixpoint_kernel,
                                                  FIX_THREADS, 0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cached_max = per_sm * sms;
    cached_dev = dev;
  }
  return max(1, min(cached_max, needed_blocks));
}

#define FDB_TRY(expr)                          \
  do {                                         \
    cudaError_t e_ = (expr);                   \
    if (e_ != cudaSuccess) return (int)e_;     \
  } while (0)
#define FDB_LAUNCHED() FDB_TRY(cudaGetLastError())

int resolve_impl(const In& in, int attribute, uint32_t* hk_out,
                 int32_t* hv_out, int32_t* count_out, uint8_t* conflict_out,
                 uint8_t* read_hit_out, void* scratch, size_t scratch_bytes,
                 cudaStream_t st, long long* launches) {
  const int cap = in.cap, T = in.T, R = in.R, Wr = in.Wr, width = in.width;
  if (cap < fdb::RMQ_BLOCK || (cap & (cap - 1)) || T < 1 || R < 1 ||
      (R & (R - 1)) || Wr < 1 || width < 1 || !hk_out || !hv_out ||
      !count_out || !conflict_out || (attribute && !read_hit_out))
    return fdb::ERR_BAD_ARGS;
  long long unused[2] = {0, 0};
  if (!launches) launches = unused;
  Scratch s;
  if (carve(s, nullptr, cap, T, R, Wr, width) > scratch_bytes)
    return fdb::ERR_SCRATCH;
  carve(s, static_cast<char*>(scratch), cap, T, R, Wr, width);
  const int n_lanes = (Wr + 31) / 32, n_s = 2 * Wr, mtot = cap + n_s;
  const int n_tiles = (mtot + TILE - 1) / TILE;

  // 1. external check: bounds, K2 range max, K1 segment starts
  ext_bounds_kernel<<<fdb::blocks_for(R, 256), 256, 0, st>>>(in, s.lo, s.hi);
  FDB_LAUNCHED();
  FDB_TRY(fdb_range_max_launch(in.hv, cap, s.lo, s.hi, R, s.vmax, s.rmq, st));
  launches[1] += 1;
  FDB_TRY(fdb_searchsorted_launch(in.rtxn, R, nullptr, T + 2, 0, s.rs, st));
  launches[0] += 1;
  ext_flags_kernel<<<fdb::blocks_for(R, 256), 256, 0, st>>>(in, s.vmax,
                                                              s.ext_r);
  FDB_LAUNCHED();
  base_kernel<<<fdb::blocks_for(T + 1, 256), 256, 0, st>>>(
      in, s.rs, s.ext_r, s.base, s.ca, s.cb);
  FDB_LAUNCHED();

  // 2. overlap matrix + fixpoint (+ attribution)
  size_t ov_smem = (size_t)OV_LANES * 32 * (2 * width + 1) * sizeof(uint32_t);
  if (ov_smem > 48 * 1024)
    FDB_TRY(cudaFuncSetAttribute(overlap_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)ov_smem));
  dim3 ov_grid((n_lanes + OV_LANES - 1) / OV_LANES,
               (R + OV_READS - 1) / OV_READS);
  overlap_kernel<<<ov_grid, 256, ov_smem, st>>>(in, n_lanes, s.ovp);
  FDB_LAUNCHED();
  FDB_TRY(cudaMemsetAsync(s.flags, 0, 4 * sizeof(int), st));
  Fix f{s.ovp, R, n_lanes, Wr, T, attribute, in.wtxn, s.rs, s.base,
        s.ca, s.cb, s.cfinal, s.flags, s.alive_p, s.hit_r, s.ext_r,
        conflict_out, read_hit_out};
  int needed = max(fdb::blocks_for((long long)R * 32, FIX_THREADS),
                   fdb::blocks_for(T + 1, FIX_THREADS));
  void* args[] = {&f};
  FDB_TRY(cudaLaunchCooperativeKernel((void*)fixpoint_kernel,
                                      dim3(fixpoint_grid(needed)),
                                      dim3(FIX_THREADS), args, 0, st));
  FDB_LAUNCHED();

  // 3. merge: sort the surviving boundaries, interleave with history
  ins_build_kernel<<<fdb::blocks_for(n_s, 256), 256, 0, st>>>(
      in, s.cfinal, s.ins_k, s.ins_tie, s.sidx_a);
  FDB_LAUNCHED();
  int32_t* cur = s.sidx_a;
  int32_t* nxt = s.sidx_b;
  for (int run = 1; run < n_s; run <<= 1) {
    sort_round_kernel<<<fdb::blocks_for(n_s, 256), 256, 0, st>>>(
        s.ins_k, s.ins_tie, width, cur, nxt, n_s, run);
    FDB_LAUNCHED();
    int32_t* t = cur;
    cur = nxt;
    nxt = t;
  }
  merge_hist_kernel<<<fdb::blocks_for(cap, 256), 256, 0, st>>>(
      in, s.ins_k, s.ins_tie, cur, n_s, s.src);
  FDB_LAUNCHED();
  merge_ins_kernel<<<fdb::blocks_for(n_s, 256), 256, 0, st>>>(
      in, s.ins_k, cur, n_s, s.src);
  FDB_LAUNCHED();
  Merged m{in.hk, in.hv, s.ins_k, s.ins_tie, s.src, cap, width, mtot};
  cover_reduce_kernel<<<n_tiles, SCAN_THREADS, 0, st>>>(m, s.agg_max,
                                                        s.agg_sum);
  FDB_LAUNCHED();
  scan_tiles_kernel<true><<<1, 1024, 0, st>>>(s.agg_max, s.pre_max, n_tiles,
                                              nullptr);
  FDB_LAUNCHED();
  scan_tiles_kernel<false><<<1, 1024, 0, st>>>(s.agg_sum, s.pre_sum, n_tiles,
                                               nullptr);
  FDB_LAUNCHED();
  cover_apply_kernel<<<n_tiles, SCAN_THREADS, 0, st>>>(
      m, s.pre_max, s.pre_sum, in.commit, s.mv);
  FDB_LAUNCHED();

  // 4. GC + compaction
  keep_reduce_kernel<<<n_tiles, SCAN_THREADS, 0, st>>>(m, s.mv, in.oldest,
                                                       s.keepf, s.agg_keep);
  FDB_LAUNCHED();
  scan_tiles_kernel<false><<<1, 1024, 0, st>>>(s.agg_keep, s.pre_keep,
                                               n_tiles, count_out);
  FDB_LAUNCHED();
  compact_kernel<<<n_tiles, SCAN_THREADS, 0, st>>>(m, s.mv, s.keepf,
                                                   s.pre_keep, hk_out, hv_out);
  FDB_LAUNCHED();
  fill_tail_kernel<<<fdb::blocks_for(cap, 256), 256, 0, st>>>(
      hk_out, hv_out, cap, width, count_out);
  FDB_LAUNCHED();
  return 0;
}

}  // namespace

FDB_API size_t fdb_resolve_scratch_bytes(int cap, int T, int R, int Wr,
                                         int width) {
  Scratch s;
  return carve(s, nullptr, cap, T, R, Wr, width);
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
  return resolve_impl(in, attribute, hk_out, hv_out, count_out, conflict_out,
                      read_hit_out, scratch, scratch_bytes,
                      static_cast<cudaStream_t>(stream), launches);
}

// the packed feed (ops/conflict_kernel.py:465-478): the 12 inputs are
// offsets into the one buffer, read in place
FDB_API int fdb_resolve_packed(const uint32_t* hk, const int32_t* hv,
                               const uint32_t* buf, int cap, int T, int R,
                               int Wr, int width, int attribute,
                               uint32_t* hk_out, int32_t* hv_out,
                               int32_t* count_out, uint8_t* conflict_out,
                               uint8_t* read_hit_out, void* scratch,
                               size_t scratch_bytes, void* stream,
                               long long* launches) {
  size_t o = 2;
  auto take = [&](size_t n) {
    const uint32_t* p = buf + o;
    o += n;
    return p;
  };
  const int32_t* commit = reinterpret_cast<const int32_t*>(buf);
  const int32_t* oldest = commit + 1;
  const int32_t* snap = reinterpret_cast<const int32_t*>(take(T));
  const uint32_t* too_old = take(T);
  const uint32_t* rb = take((size_t)R * width);
  const uint32_t* re = take((size_t)R * width);
  const int32_t* rtxn = reinterpret_cast<const int32_t*>(take(R));
  const uint32_t* rvalid = take(R);
  const uint32_t* wb = take((size_t)Wr * width);
  const uint32_t* we = take((size_t)Wr * width);
  const int32_t* wtxn = reinterpret_cast<const int32_t*>(take(Wr));
  const uint32_t* wvalid = take(Wr);
  In in{hk, hv, snap, too_old, rb, re, rtxn, rvalid, wb, we, wtxn, wvalid,
        commit, oldest, 4, cap, T, R, Wr, width};
  return resolve_impl(in, attribute, hk_out, hv_out, count_out, conflict_out,
                      read_hit_out, scratch, scratch_bytes,
                      static_cast<cudaStream_t>(stream), launches);
}
