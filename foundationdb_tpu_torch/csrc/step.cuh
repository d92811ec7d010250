// What the interval steps share: K3 and K8 (resolve.cu) and K8e and K8f
// (shard_step.cu). The feed's 12 inputs (In, unpack_feed), the external
// check's bounds search for one read and shard, the endpoint record
// (key, end-before-begin, index), the merged sequence (Merged), and the
// survivor partition, the covering version's scans and the compaction
// as functions of one tile, which K3's and K8's kernels run one tile a
// block and K8f's merge, one cooperative launch, runs with every block
// striding over the tiles.
#pragma once

#include "common.cuh"
#include "sort.cuh"

namespace {

constexpr int SCAN_THREADS = 256;
constexpr int SCAN_ITEMS = 8;
constexpr int TILE = SCAN_THREADS * SCAN_ITEMS;
constexpr int SURV_ITEMS = 2;      // sorted endpoints per thread, partition
constexpr int SURV_TILE = SCAN_THREADS * SURV_ITEMS;
constexpr uint32_t BEGIN_BIT = 0x80000000u;

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

// the packed feed (ops/conflict_kernel.py:465-478): the 12 inputs are
// offsets into the one buffer, read in place
In unpack_feed(const uint32_t* hk, const int32_t* hv, const uint32_t* buf,
               int cap, int T, int R, int Wr, int width) {
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
  return In{hk, hv, snap, too_old, rb, re, rtxn, rvalid, wb, we, wtxn,
            wvalid, commit, oldest, 4, cap, T, R, Wr, width};
}

// uint4s per endpoint record (width + 1 words, rounded up), 0 when the
// keys are too wide for the endpoint sort
int rec_nv(int width) { return fdb::rec_uint4s(width + 1); }

// ---- the external check's bounds -------------------------------------------
// Read i against shard k's history hk [cap] (lows/highs [S, width]): lo
// = #(rows <= rb) - 1 and hi = #(rows < re), the range K2 takes the max
// over, and ok, the read's validity. With kClip (K8, K8e) the read is
// first clipped to the shard (K7's clip_range, in registers), and ok is
// the clipped flag; K3 (S = 1) searches the feed's rows as they are.
// Both searches run in lockstep (common.cuh row_bounds), a probed row's
// first ROW_CW words loaded together.
template <bool kClip>
__device__ void read_bounds(const In& in, const uint32_t* hk,
                            const uint32_t* lows, const uint32_t* highs,
                            int k, int i, int32_t& lo, int32_t& hi,
                            uint8_t& rok) {
  const int width = in.width;
  fdb::Row q[2] = {fdb::load_row(in.rb + (size_t)i * width, width),
                   fdb::load_row(in.re + (size_t)i * width, width)};
  bool ok = fdb::flag_at(in.rvalid, i, in.flag_bytes);
  if (kClip)
    ok &= fdb::clip_range(q[0], q[1],
                          fdb::load_row(lows + (size_t)k * width, width),
                          fdb::load_row(highs + (size_t)k * width, width),
                          width);
  const bool upper[2] = {true, false};
  int n[2];
  fdb::row_bounds<2>(hk, in.cap, q, upper, width, n);
  lo = n[0] - 1;
  hi = n[1];
  rok = ok;
}

// ---- the endpoint record ----------------------------------------------------
// A record is NV uint4s: the key row (width words), the tag (BEGIN_BIT
// for rb and wb, or'ed with the endpoint's index g: rb [0, R), wb
// [R, R+Wr), we [R+Wr, R+2Wr), re [R+2Wr, N)), then zero words. Records
// compare word by word, so the order is (key, end before begin, g): a
// total order. An invalid read's rb and an invalid write's wb and we
// are the +inf row, as the reference does (ops/conflict_kernel.py
// :255-257). sort.cuh's padding record (all ones) sorts after every
// real one.
template <int NV>
__device__ fdb::Rec<NV> ep_record(const In& in, int g) {
  fdb::Rec<NV> rec;
  const int R = in.R, Wr = in.Wr, width = in.width;
  const uint32_t* row;
  bool inf = false;
  uint32_t tag = (uint32_t)g;
  if (g < R) {
    row = in.rb + (size_t)g * width;
    inf = !fdb::flag_at(in.rvalid, g, in.flag_bytes);
    tag |= BEGIN_BIT;
  } else if (g < R + Wr) {
    row = in.wb + (size_t)(g - R) * width;
    inf = !fdb::flag_at(in.wvalid, g - R, in.flag_bytes);
    tag |= BEGIN_BIT;
  } else if (g < R + 2 * Wr) {
    row = in.we + (size_t)(g - R - Wr) * width;
    inf = !fdb::flag_at(in.wvalid, g - R - Wr, in.flag_bytes);
  } else {
    row = in.re + (size_t)(g - R - 2 * Wr) * width;
  }
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    uint32_t x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int k = 4 * i + j;
      x[j] = k < width ? (inf ? fdb::INF_WORD : row[k])
                       : (k == width ? tag : 0u);
    }
    rec.v[i] = make_uint4(x[0], x[1], x[2], x[3]);
  }
  return rec;
}

template <int NV>
struct EpLoad {
  In in;
  __device__ fdb::Rec<NV> operator()(int g) const {
    return ep_record<NV>(in, g);
  }
};

// each endpoint's sorted position, by group
struct Pos {
  int32_t *r_lo, *r_hi, *w_lo, *w_hi;
};

// ---- the survivors' boundaries ----------------------------------------------
// out of the one endpoint sort, per shard: a stable partition (counts
// per tile of sorted endpoints, then placement).
struct Part {
  const uint32_t* rec;  // the sorted endpoints: records of `stride` words
  int stride, n;
  const uint8_t* cfinal;
  const uint32_t* lows;  // K8, K8f: the shards' [lo, hi) bounds
  const uint32_t* highs;
};

// the row sorted endpoint p puts into shard k's list, or null: a
// surviving write's (a valid write whose transaction did not conflict)
// begin or end; K8 (kClip) clips the write to [lows[k], highs[k]) and
// keeps it only where the clip is non-empty, as the reference's clip
// does (common.cuh clip_range, K7's clip); `is_b` says whether it is
// the write's begin
template <bool kClip>
__device__ const uint32_t* part_row(const In& in, const Part& pt, int p,
                                    int k, bool& is_b) {
  const int width = in.width;
  int w = (int)(pt.rec[(size_t)p * pt.stride + width] & ~BEGIN_BIT) - in.R;
  if (w < 0 || w >= 2 * in.Wr) return nullptr;
  is_b = w < in.Wr;
  if (!is_b) w -= in.Wr;
  const int t = min(max(in.wtxn[w], 0), in.T);
  if (!fdb::flag_at(in.wvalid, w, in.flag_bytes) || pt.cfinal[t])
    return nullptr;
  if (!kClip) return (is_b ? in.wb : in.we) + (size_t)w * width;
  fdb::Row b = fdb::load_row(in.wb + (size_t)w * width, width);
  fdb::Row e = fdb::load_row(in.we + (size_t)w * width, width);
  if (!fdb::clip_range(b, e,
                       fdb::load_row(pt.lows + (size_t)k * width, width),
                       fdb::load_row(pt.highs + (size_t)k * width, width),
                       width))
    return nullptr;
  return is_b ? b.p : e.p;
}

// pass A for tile `bx` of sorted endpoints: shard k's survivors in it
// (every thread of the block gets the count)
template <bool kClip>
__device__ int part_count_tile(const In& in, const Part& pt, int bx, int k) {
  const int base = bx * SURV_TILE + threadIdx.x;
  int cnt = 0;
#pragma unroll
  for (int i = 0; i < SURV_ITEMS; ++i) {
    int p = base + i * SCAN_THREADS;
    bool is_b;
    cnt += p < pt.n && part_row<kClip>(in, pt, p, k, is_b) != nullptr;
  }
  int tot;
  fdb::block_excl_scan<false>(cnt, tot);
  return tot;
}

// pass B for tile `bx`: shard k's survivor rows of the tile in sorted
// order from slot `pre` of its 2 * Wr slots of ins_k / ins_tie (tie 6
// for a begin, 4 for an end), stripe by stripe
template <bool kClip>
__device__ void part_place_tile(const In& in, const Part& pt, int bx, int k,
                                int pre, uint32_t* __restrict__ ins_k,
                                int32_t* __restrict__ ins_tie) {
  const int width = in.width;
  const int base = bx * SURV_TILE + threadIdx.x;
  const uint32_t* row[SURV_ITEMS];
  bool bg[SURV_ITEMS];
#pragma unroll
  for (int i = 0; i < SURV_ITEMS; ++i) {
    int p = base + i * SCAN_THREADS;
    bg[i] = false;
    row[i] = p < pt.n ? part_row<kClip>(in, pt, p, k, bg[i]) : nullptr;
  }
  // stripe by stripe, so the survivors keep their sorted order
  int pos = pre;
  for (int i = 0; i < SURV_ITEMS; ++i) {
    int tot;
    int at = pos + fdb::block_excl_scan<false>(row[i] != nullptr, tot);
    pos += tot;
    if (!row[i]) continue;
    for (int w = 0; w < width; ++w)
      ins_k[(size_t)at * width + w] = row[i][w];
    ins_tie[at] = bg[i] ? 6 : 4;
  }
}

// ---- merge ------------------------------------------------------------------
// the merged sequence: position p holds history row src[p] (< cap) or
// sorted-boundary row src[p] - cap
struct Merged {
  const uint32_t* hk;
  const int32_t* hv;
  const uint32_t* ins_k;
  const int32_t* ins_tie;
  const int32_t* src;
  int cap, width, mtot;
  // shard k's slices of the [S, cap] history, the [S, mtot - cap]
  // boundaries and the [S, mtot] sequence (K3 has the one shard 0)
  __device__ Merged shard(int k) const {
    const size_t n_s = mtot - cap;
    return Merged{hk + (size_t)k * cap * width, hv + (size_t)k * cap,
                  ins_k + (size_t)k * n_s * width, ins_tie + (size_t)k * n_s,
                  src + (size_t)k * mtot, cap, width, mtot};
  }
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

// pass A of the first scan for tile `bx`: the last history-or-masked row
// (max index) and the coverage delta sum (every thread gets both)
__device__ void cover_tile_reduce(const Merged& m, int bx, int& totm,
                                  int& tots) {
  int base = bx * TILE + threadIdx.x * SCAN_ITEMS;
  int tmax = 0, tsum = 0;
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    int p = base + k;
    if (p >= m.mtot) break;
    int tie = m.tie(p);
    if (tie < 4) tmax = max(tmax, p); else tsum += tie - 5;
  }
  fdb::block_excl_scan<true>(tmax, totm);
  fdb::block_excl_scan<false>(tsum, tots);
}

// a merged row's covering version: that of the last history row at or
// before it (`runm`), raised to the commit where the row is covered
// (`runs`, the coverage count, above 0)
__device__ __forceinline__ int32_t covering(const Merged& m, int runm,
                                            int runs, int32_t commit) {
  int32_t v = m.vcol(runm);
  return runs > 0 ? max(v, commit) : v;
}

// pass B for tile `bx`, from the scans of the tiles before it: covering
// version (carry-last over history rows) and coverage (inclusive delta
// sum) per merged row; covered rows take the commit
__device__ void cover_tile_apply(const Merged& m, int bx, int pre_max,
                                 int pre_sum, int32_t commit, int32_t* mv) {
  int base = bx * TILE + threadIdx.x * SCAN_ITEMS;
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
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    int p = base + k;
    runm = max(runm, cand[k]);
    runs += d[k];
    if (p < m.mtot) mv[p] = covering(m, runm, runs, commit);
  }
}

// ---- GC ---------------------------------------------------------------------
// whether merged row p stays in the history (K3's and K8's keep_row,
// K8f's cover_keep_tile): the last of its key's run (`run_end`), not
// redundant with the row before it where that row holds another key
// (`new_key_before`; redundant: the same version `v` as that row's `pv`,
// or both below the oldest version kept), and not the +inf row
__device__ __forceinline__ bool keep_rule(bool run_end, bool new_key_before,
                                          int32_t v, int32_t pv, bool inf,
                                          int32_t oldest2) {
  if (!run_end || inf) return false;
  return !new_key_before || !(v == pv || (v < oldest2 && pv < oldest2));
}

// ---- compaction -------------------------------------------------------------
// the kept rows of tile `bx`, packed from `pre` on in merged order: one
// block scan per stripe of SCAN_THREADS consecutive rows, so the kept
// rows of a stripe are written side by side
__device__ void compact_tile(const Merged& m, const int32_t* mv,
                             const uint8_t* keepf, int bx, int pre,
                             uint32_t* __restrict__ hk_out,
                             int32_t* __restrict__ hv_out) {
  const int base = bx * TILE + threadIdx.x;
  int f[SCAN_ITEMS], at[SCAN_ITEMS];
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    int p = base + k * SCAN_THREADS;
    f[k] = p < m.mtot ? keepf[p] : 0;
  }
  int pos = pre;
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    int tot;
    at[k] = pos + fdb::block_excl_scan<false>(f[k], tot);
    pos += tot;
  }
#pragma unroll
  for (int k = 0; k < SCAN_ITEMS; ++k) {
    int p = base + k * SCAN_THREADS;
    if (f[k] && at[k] < m.cap) {
      const uint32_t* kp = m.key(p);
      for (int w = 0; w < m.width; ++w)
        hk_out[(size_t)at[k] * m.width + w] = kp[w];
      hv_out[at[k]] = mv[p];
    }
  }
}

}  // namespace
