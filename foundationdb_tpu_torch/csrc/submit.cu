// The packed path's one-call submit: the host work of one batch on the
// card between the resolver's version bookkeeping and its ticket, in
// one C call instead of a chain of NumPy, torch and ctypes calls
// (models/cuda_resolver.py `_submit_one_call`). In order:
//
//   stage     the pinned staging entry filled (csrc/marshal.cpp);
//   feed      one host->device copy of it into the shape bucket's
//             device feed buffer, then the entry's event;
//   launch    the step's existing launcher, unchanged: K3
//             (fdb_resolve_packed) or K8 in lockstep
//             (fdb_resolve_sharded_packed), with the kernel profile's
//             event pair around it on a timed call;
//   readback  copies of count, conflict and read_hit (when attributed)
//             into a pinned result slot, then the slot's event.
//
// Everything is enqueued on the caller's stream, so the bucket's feed
// and output buffers are reused safely: the next batch's copy and step
// queue behind this one's. The boundary times of the four parts come
// back on CLOCK_MONOTONIC (time.perf_counter_ns), for the host spans.

#include "common.cuh"
#include "marshal.cpp"

FDB_API int fdb_resolve_packed(const uint32_t* hk, const int32_t* hv,
                               const uint32_t* buf, int cap, int T, int R,
                               int Wr, int width, int attribute,
                               uint32_t* hk_out, int32_t* hv_out,
                               int32_t* count_out, uint8_t* conflict_out,
                               uint8_t* read_hit_out, void* scratch,
                               size_t scratch_bytes, void* stream,
                               long long* launches);
FDB_API int fdb_resolve_sharded_packed(
    const uint32_t* hk, const int32_t* hv, const uint32_t* buf,
    const uint32_t* lows, const uint32_t* highs, int S, int cap, int T,
    int R, int Wr, int width, int attribute, uint32_t* hk_out,
    int32_t* hv_out, int32_t* count_out, uint8_t* conflict_out,
    uint8_t* read_hit_out, void* scratch, size_t scratch_bytes, void* stream,
    long long* launches);

namespace fdb_marshal {

// ops/marshal.py SubmitArgs mirrors it; every field 8 bytes wide
struct SubmitArgs {
  fdb_marshal::FillArgs fill;
  uint32_t* feed;            // the bucket's device feed buffer
  void* feed_event;          // the staging entry's cudaEvent_t
  int64_t sharded;           // 0: K3, 1: K8 in lockstep
  const uint32_t* hk;
  const int32_t* hv;
  uint32_t* hk_out;
  int32_t* hv_out;
  const uint32_t* lows;      // K8's shard bounds
  const uint32_t* highs;
  int64_t shards, cap, attribute;
  int32_t* count;            // the bucket's device outputs
  uint8_t* conflict;
  uint8_t* read_hit;
  void* scratch;
  int64_t scratch_bytes;
  void* stream;
  void* timed_start;         // the kernel profile's pair, or null
  void* timed_end;
  int32_t* host_count;       // the pinned result slot
  uint8_t* host_conflict;
  uint8_t* host_read_hit;
  void* result_event;        // the slot's cudaEvent_t
  long long launches[3];     // out: the launcher's K1, K2, K7 counts
                             // (it adds to them; zeroed first)
  int64_t t[5];              // out: stage, feed, launch, readback, end
};

}  // namespace fdb_marshal

FDB_API int fdb_submit_packed(fdb_marshal::SubmitArgs* a) {
  using fdb_marshal::now_ns;
  const fdb_marshal::FillArgs& f = a->fill;
  cudaStream_t st = static_cast<cudaStream_t>(a->stream);
  a->t[0] = now_ns();
  a->launches[0] = a->launches[1] = a->launches[2] = 0;
  fdb_marshal_fill(&f);

  a->t[1] = now_ns();
  cudaError_t e = cudaMemcpyAsync(
      a->feed, f.buf, size_t(fdb_marshal::feed_words(f)) * 4,
      cudaMemcpyHostToDevice, st);
  if (e == cudaSuccess)
    e = cudaEventRecord(static_cast<cudaEvent_t>(a->feed_event), st);
  if (e != cudaSuccess) return e;

  a->t[2] = now_ns();
  if (a->timed_start) {
    e = cudaEventRecord(static_cast<cudaEvent_t>(a->timed_start), st);
    if (e != cudaSuccess) return e;
  }
  const int T = int(f.npad), R = int(f.nrp), Wr = int(f.nwp);
  const int width = int(f.width), cap = int(a->cap);
  const int attr = int(a->attribute);
  int code = a->sharded
      ? fdb_resolve_sharded_packed(
            a->hk, a->hv, a->feed, a->lows, a->highs, int(a->shards), cap, T,
            R, Wr, width, attr, a->hk_out, a->hv_out, a->count, a->conflict,
            a->read_hit, a->scratch, size_t(a->scratch_bytes), st,
            a->launches)
      : fdb_resolve_packed(a->hk, a->hv, a->feed, cap, T, R, Wr, width, attr,
                           a->hk_out, a->hv_out, a->count, a->conflict,
                           a->read_hit, a->scratch, size_t(a->scratch_bytes),
                           st, a->launches);
  if (code) return code;
  if (a->timed_end) {
    e = cudaEventRecord(static_cast<cudaEvent_t>(a->timed_end), st);
    if (e != cudaSuccess) return e;
  }

  a->t[3] = now_ns();
  e = cudaMemcpyAsync(a->host_count, a->count, size_t(a->shards) * 4,
                      cudaMemcpyDeviceToHost, st);
  if (e == cudaSuccess)
    e = cudaMemcpyAsync(a->host_conflict, a->conflict, size_t(T),
                        cudaMemcpyDeviceToHost, st);
  if (e == cudaSuccess && attr)
    e = cudaMemcpyAsync(a->host_read_hit, a->read_hit, size_t(R),
                        cudaMemcpyDeviceToHost, st);
  if (e == cudaSuccess)
    e = cudaEventRecord(static_cast<cudaEvent_t>(a->result_event), st);
  a->t[4] = now_ns();
  return e;
}
