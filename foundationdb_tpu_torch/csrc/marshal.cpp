// The packed path's per-batch host work in plain C++: the order check
// of a batch's per-range transaction ids with its too-old flags and
// window floor (fdb_marshal_check), and the fill of one pinned staging
// entry in the packed feed layout (fdb_marshal_fill,
// ops/conflict_kernel.py interval_batch_views).
//
// g++ builds this file alone for the CPU path (ops/marshal.py), and
// csrc/submit.cu includes it, so the card's library runs the same code
// inside its one-call submit. Nothing here touches the device.

#include <cstdint>
#include <cstring>
#include <ctime>

#ifndef FDB_API
#define FDB_API extern "C" __attribute__((visibility("default")))
#endif

namespace fdb_marshal {

constexpr int64_t SNAP_CLAMP = (int64_t(1) << 30) + 1;  // conflict_kernel.py

// the element type of an id array (ops/marshal.py ID_KINDS)
enum IdKind : int64_t { IDS_I32 = 0, IDS_I64 = 1, IDS_U32 = 2, IDS_U64 = 3 };

// one pass's arguments; every field 8 bytes wide (ops/marshal.py
// FillArgs mirrors it)
struct FillArgs {
  uint32_t* buf;               // the staging entry
  int64_t n, nr, nw;           // real transactions, reads, writes
  int64_t npad, nrp, nwp;      // their slots in the shape bucket
  int64_t width;               // words a key row
  int64_t commit_off, oldest_off;
  const int64_t* snapshots;    // [n] absolute versions
  int64_t base;                // the version the offsets count from
  const uint8_t* too_old;      // [n], nonzero = too old
  // [>= nr or nw, width] key rows; null where the caller encoded that
  // sub-matrix into the entry itself
  const uint32_t* rb;
  const uint32_t* re;
  const uint32_t* wb;
  const uint32_t* we;
  const void* rt;              // [nr] read txn ids
  const void* wt;              // [nw] write txn ids
  int64_t rt_kind, wt_kind;
};

inline int64_t now_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);  // time.perf_counter_ns's clock
  return int64_t(ts.tv_sec) * 1000000000 + ts.tv_nsec;
}

// an id as NumPy's cast to int64 reads it (a uint64 wraps)
inline int64_t id_at(const void* p, int64_t kind, int64_t i) {
  switch (kind) {
    case IDS_I32: return static_cast<const int32_t*>(p)[i];
    case IDS_I64: return static_cast<const int64_t*>(p)[i];
    case IDS_U32: return static_cast<const uint32_t*>(p)[i];
    default:
      return static_cast<int64_t>(static_cast<const uint64_t*>(p)[i]);
  }
}

// no early exit, so the loop vectorizes (a batch is sorted); ids
// compare as `C`, which orders them as NumPy's int64 cast does
template <typename T, typename C>
inline bool sorted_as(const T* p, int64_t n) {
  int bad = 0;
  for (int64_t i = 1; i < n; ++i)
    bad |= static_cast<C>(p[i]) < static_cast<C>(p[i - 1]);
  return !bad;
}

inline bool ids_sorted(const void* p, int64_t kind, int64_t n) {
  switch (kind) {
    case IDS_I32: return sorted_as<int32_t, int32_t>(
        static_cast<const int32_t*>(p), n);
    case IDS_I64: return sorted_as<int64_t, int64_t>(
        static_cast<const int64_t*>(p), n);
    case IDS_U32: return sorted_as<uint32_t, uint32_t>(
        static_cast<const uint32_t*>(p), n);
    default: return sorted_as<uint64_t, int64_t>(
        static_cast<const uint64_t*>(p), n);
  }
}

// the ids as the int32 words of the entry, then `pad` to `slots`
inline void fill_ids(uint32_t* dst, const void* src, int64_t kind, int64_t n,
                     int64_t slots, uint32_t pad) {
  if (kind == IDS_I32 || kind == IDS_U32) {
    if (n) std::memcpy(dst, src, size_t(n) * 4);
  } else {
    for (int64_t i = 0; i < n; ++i)
      dst[i] = static_cast<uint32_t>(id_at(src, kind, i));
  }
  for (int64_t i = n; i < slots; ++i) dst[i] = pad;
}

inline void fill_flags(uint32_t* dst, int64_t n, int64_t slots) {
  for (int64_t i = 0; i < n; ++i) dst[i] = 1;
  std::memset(dst + n, 0, size_t(slots - n) * 4);
}

// a key sub-matrix: the rows copied, the pad rows zeroed
inline void fill_keys(uint32_t* dst, const uint32_t* src, int64_t n,
                      int64_t slots, int64_t width) {
  if (!src) return;
  if (n) std::memcpy(dst, src, size_t(n * width) * 4);
  std::memset(dst + n * width, 0, size_t((slots - n) * width) * 4);
}

inline int64_t feed_words(const FillArgs& a) {
  return 2 + 2 * a.npad + (a.nrp + a.nwp) * (2 * a.width + 2);
}

}  // namespace fdb_marshal

// The order check and the too-old flags of one pre-encoded batch: 1
// when `rt` decreases, 2 when `wt` does (rt is checked first), else 0
// with too_old[t] = has_reads[t] && snapshots[t] < oldest and *floor =
// min(the least snapshot of a transaction that reads and is not too
// old, or commit_version when none, window_oldest).
FDB_API int fdb_marshal_check(const int64_t* snapshots,
                              const uint8_t* has_reads, int64_t n,
                              const void* rt, int64_t rt_kind, int64_t nr,
                              const void* wt, int64_t wt_kind, int64_t nw,
                              int64_t oldest, int64_t commit_version,
                              int64_t window_oldest, uint8_t* too_old,
                              int64_t* floor) {
  using namespace fdb_marshal;
  if (!ids_sorted(rt, rt_kind, nr)) return 1;
  if (!ids_sorted(wt, wt_kind, nw)) return 2;
  // two branch-free passes, so both vectorize: the flags, then the
  // least live snapshot (INT64_MAX while none is live)
  for (int64_t t = 0; t < n; ++t)
    too_old[t] = (has_reads[t] != 0) & (snapshots[t] < oldest);
  int64_t least = INT64_MAX;
  uint8_t any = 0;
  for (int64_t t = 0; t < n; ++t) {
    const uint8_t live = (has_reads[t] != 0) & (too_old[t] ^ 1);
    const int64_t keep = -static_cast<int64_t>(live);
    const int64_t c = (snapshots[t] & keep) | (INT64_MAX & ~keep);
    least = c < least ? c : least;
    any |= live;
  }
  const int64_t at = any ? least : commit_version;
  *floor = at < window_oldest ? at : window_oldest;
  return 0;
}

// One staging entry filled in the packed feed layout, every word of it:
// the header, the snapshot offsets clipped to [0, SNAP_CLAMP], the
// too-old flags, the four key matrices, the txn ids (pad = npad) and
// valid flags of both sides, each padded to its bucket.
FDB_API void fdb_marshal_fill(const fdb_marshal::FillArgs* a) {
  using namespace fdb_marshal;
  uint32_t* w = a->buf;
  w[0] = static_cast<uint32_t>(static_cast<int32_t>(a->commit_off));
  w[1] = static_cast<uint32_t>(static_cast<int32_t>(a->oldest_off));
  uint32_t* snap = w + 2;
  uint32_t* old = snap + a->npad;
  for (int64_t t = 0; t < a->n; ++t) {
    // NumPy's int64 subtraction wraps; so does this one
    int64_t d = static_cast<int64_t>(static_cast<uint64_t>(a->snapshots[t])
                                     - static_cast<uint64_t>(a->base));
    d = d < 0 ? 0 : (d > SNAP_CLAMP ? SNAP_CLAMP : d);
    snap[t] = static_cast<uint32_t>(d);
    old[t] = a->too_old[t] != 0;
  }
  std::memset(snap + a->n, 0, size_t(a->npad - a->n) * 4);
  std::memset(old + a->n, 0, size_t(a->npad - a->n) * 4);
  const int64_t wd = a->width;
  uint32_t* rb = old + a->npad;
  uint32_t* re = rb + a->nrp * wd;
  uint32_t* rtxn = re + a->nrp * wd;
  uint32_t* rvalid = rtxn + a->nrp;
  uint32_t* wb = rvalid + a->nrp;
  uint32_t* we = wb + a->nwp * wd;
  uint32_t* wtxn = we + a->nwp * wd;
  uint32_t* wvalid = wtxn + a->nwp;
  const uint32_t pad = static_cast<uint32_t>(a->npad);
  fill_keys(rb, a->rb, a->nr, a->nrp, wd);
  fill_keys(re, a->re, a->nr, a->nrp, wd);
  fill_ids(rtxn, a->rt, a->rt_kind, a->nr, a->nrp, pad);
  fill_flags(rvalid, a->nr, a->nrp);
  fill_keys(wb, a->wb, a->nw, a->nwp, wd);
  fill_keys(we, a->we, a->nw, a->nwp, wd);
  fill_ids(wtxn, a->wt, a->wt_kind, a->nw, a->nwp, pad);
  fill_flags(wvalid, a->nw, a->nwp);
}
