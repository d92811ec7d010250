// K9 fdb_chain_gen: one step's batch of the bench chains, made on the
// card; K10 fdb_chain_tally: the step's conflict count into the chain's
// running total, and the step counter and key advanced.
//
// Replaces the batch generation and tally inside the reference bench's
// device loops, foundationdb_tpu's bench.py:122 bench_tpu_point and
// :201 bench_tpu (jax.random.split / randint / gen_keys at :149-153 and
// :230-234, the conflict sum at :164-174 and :240-258).
//
// Both read and write a 10-word control block (ops/bench_chain.py
// C_*): the carried threefry key, the step counter i, the running
// conflict count, and the next key, kr and kw that K9 derives. K9 reads
// the key and i and writes the derived keys; K10, after the resolve
// step, commits the next key and i + 1. The host never reads i.
//
// K9 is jax.random bit for bit (JAX 0.9.0, threefry2x32,
// jax_threefry_partitionable): split(key, n) hashes the 2x32 iota (hi
// word 0, lo word the index); randint(k, (n,), 0, hi) splits k in two
// and draws offset = ((h % span) * mult + l % span) % span in uint32
// arithmetic that wraps, where h and l are the two keys' bits at the
// slot. One thread per slot: it derives the step's seven keys itself
// (seven threefry evaluations, cheaper than a barrier) and hashes its
// slot under both of its side's keys.
//
// Bound: bytes. K9 writes the rows (R + Wr rows of W+1 words, twice on
// the interval chain) and T snapshots; ~0.65 MB a point step at 16,384
// transactions, ~0.2 us at 3.35 TB/s; the hashing is ~9 x 100 integer
// operations a slot, far below the card's integer rate. K10 reads T
// flag bytes (16 KB, 0.005 us): one block of 1024 threads, one 16-byte
// load a thread at 16,384 flags and one barrier, so its time is the
// launch's own floor. It counts nonzero flag bytes, whatever their
// alignment.

#include "common.cuh"

namespace {

constexpr int32_t VERSION_STEP = 250000;  // ops/bench_chain.py
constexpr int32_t MWTLV = 5000000;
constexpr uint32_t KEY_BYTES = 16;
enum { C_KEY = 0, C_STEP = 2, C_NCONF = 3, C_NEXT = 4, C_KR = 6, C_KW = 8 };
constexpr int TALLY_THREADS = 1024;  // 32 warps: one warp sum a lane

__device__ __forceinline__ uint32_t rotl(uint32_t v, int r) {
  return (v << r) | (v >> (32 - r));
}

// threefry2x32, 20 rounds (jax/_src/prng.py _threefry2x32_lowering)
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t x0, uint32_t x1,
                                         uint32_t& y0, uint32_t& y1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int r = 0; r < 5; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[r & 1][j]);
      x1 ^= x0;
    }
    x0 += ks[(r + 1) % 3];
    x1 += ks[(r + 2) % 3] + static_cast<uint32_t>(r + 1);
  }
  y0 = x0;
  y1 = x1;
}

// row j of split(k, n): threefry of (hi 0, lo j)
__device__ __forceinline__ void split_row(const uint32_t* k, uint32_t j,
                                          uint32_t* out) {
  threefry(k[0], k[1], 0u, j, out[0], out[1]);
}

__device__ __forceinline__ uint32_t bits32(const uint32_t* k, uint32_t j) {
  uint32_t a, b;
  threefry(k[0], k[1], 0u, j, a, b);
  return a ^ b;
}

__global__ void chain_gen_kernel(uint32_t* __restrict__ ctl,
                                 uint32_t* __restrict__ rb,
                                 uint32_t* __restrict__ re,
                                 uint32_t* __restrict__ wb,
                                 uint32_t* __restrict__ we,
                                 int32_t* __restrict__ snap,
                                 int32_t* __restrict__ commit,
                                 int32_t* __restrict__ oldest, int n_reads,
                                 int n_writes, int n_txns, int width,
                                 uint32_t span, uint32_t mult) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  int total = max(n_reads + n_writes, n_txns);
  if (t >= total) return;
  const uint32_t key[2] = {ctl[C_KEY], ctl[C_KEY + 1]};
  int32_t step = static_cast<int32_t>(ctl[C_STEP]);
  int32_t v = (step + 2) * VERSION_STEP;
  if (t < n_txns) snap[t] = v - VERSION_STEP;
  if (t == 0) {
    uint32_t nk[2], kr[2], kw[2];
    split_row(key, 0u, nk);
    split_row(key, 1u, kr);
    split_row(key, 2u, kw);
    ctl[C_NEXT] = nk[0];
    ctl[C_NEXT + 1] = nk[1];
    ctl[C_KR] = kr[0];
    ctl[C_KR + 1] = kr[1];
    ctl[C_KW] = kw[0];
    ctl[C_KW + 1] = kw[1];
    *commit = v;
    *oldest = max(v - MWTLV, 0);
  }
  if (t >= n_reads + n_writes) return;
  bool read = t < n_reads;
  uint32_t j = static_cast<uint32_t>(read ? t : t - n_reads);
  uint32_t side[2], hi_key[2], lo_key[2];
  split_row(key, read ? 1u : 2u, side);
  split_row(side, 0u, hi_key);
  split_row(side, 1u, lo_key);
  uint32_t higher = bits32(hi_key, j), lower = bits32(lo_key, j);
  uint32_t off = (higher % span) * mult + lower % span;  // wraps, as JAX's
  uint32_t id = off % span;
  uint32_t* b = (read ? rb : wb) + static_cast<size_t>(j) * width;
  uint32_t* e = read ? re : we;
  for (int w = 0; w < width - 2; ++w) b[w] = 0u;
  b[width - 2] = id;
  b[width - 1] = KEY_BYTES;
  if (e) {
    e += static_cast<size_t>(j) * width;
    for (int w = 0; w < width - 2; ++w) e[w] = 0u;
    e[width - 2] = id;
    e[width - 1] = KEY_BYTES + 1;  // the end key is key + b"\x00"
  }
}

// one block of TALLY_THREADS: a thread counts the nonzero bytes of one
// 16-byte word of the flags a round (one round up to 16,384 aligned
// flags), the unaligned head and the tail (< 16 bytes each) a byte a
// thread; each warp sums with __reduce_add_sync, and the warps' sums
// meet in shared memory behind the kernel's one barrier
__global__ void __launch_bounds__(TALLY_THREADS)
    chain_tally_kernel(uint32_t* __restrict__ ctl,
                       const uint8_t* __restrict__ conflict, int n,
                       int32_t* __restrict__ per_step, int per_step_len) {
  __shared__ int warp_sum[TALLY_THREADS / 32];
  const int t = threadIdx.x;
  const int head =
      min(n, (int)((16 - (reinterpret_cast<uintptr_t>(conflict) & 15)) & 15));
  const int n_vec = (n - head) >> 4, tail = head + (n_vec << 4);
  const uint4* vec = reinterpret_cast<const uint4*>(conflict + head);
  int cnt = 0;
  for (int v = t; v < n_vec; v += TALLY_THREADS) {
    const uint4 x = vec[v];
    cnt += (__popc(__vcmpne4(x.x, 0u)) + __popc(__vcmpne4(x.y, 0u)) +
            __popc(__vcmpne4(x.z, 0u)) + __popc(__vcmpne4(x.w, 0u))) >> 3;
  }
  if (t < head) cnt += conflict[t] != 0;
  if (t < n - tail) cnt += conflict[tail + t] != 0;
  cnt = __reduce_add_sync(0xFFFFFFFFu, cnt);
  if ((t & 31) == 0) warp_sum[t >> 5] = cnt;
  __syncthreads();
  if (t >= 32) return;
  const int total = __reduce_add_sync(0xFFFFFFFFu, warp_sum[t]);
  if (t == 0) {
    uint32_t i = ctl[C_STEP];
    if (per_step && i < static_cast<uint32_t>(per_step_len))
      per_step[i] = total;
    ctl[C_NCONF] += static_cast<uint32_t>(total);
    ctl[C_STEP] = i + 1;
    ctl[C_KEY] = ctl[C_NEXT];
    ctl[C_KEY + 1] = ctl[C_NEXT + 1];
  }
}

}  // namespace

FDB_API int fdb_chain_gen(uint32_t* ctl, uint32_t* rb, uint32_t* re,
                          uint32_t* wb, uint32_t* we, int32_t* snap,
                          int32_t* commit, int32_t* oldest, int n_reads,
                          int n_writes, int n_txns, int width, unsigned span,
                          unsigned mult, void* stream) {
  if (!ctl || !rb || !wb || !snap || !commit || !oldest || n_reads < 0 ||
      n_writes < 0 || n_txns < 0 || width < 2 || span == 0u ||
      (re == nullptr) != (we == nullptr))
    return fdb::ERR_BAD_ARGS;
  int total = n_reads + n_writes > n_txns ? n_reads + n_writes : n_txns;
  chain_gen_kernel<<<fdb::blocks_for(total > 0 ? total : 1, 256), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      ctl, rb, re, wb, we, snap, commit, oldest, n_reads, n_writes, n_txns,
      width, span, mult);
  return static_cast<int>(cudaGetLastError());
}

FDB_API int fdb_chain_tally(uint32_t* ctl, const uint8_t* conflict, int n,
                            int32_t* per_step, int per_step_len,
                            void* stream) {
  if (!ctl || !conflict || n < 0 || per_step_len < 0)
    return fdb::ERR_BAD_ARGS;
  chain_tally_kernel<<<1, TALLY_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      ctl, conflict, n, per_step, per_step_len);
  return static_cast<int>(cudaGetLastError());
}
