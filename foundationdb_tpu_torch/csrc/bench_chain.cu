// K9 fdb_chain_gen: one step's batch of the bench chains, made on the
// card; K10 fdb_chain_tally: the step's conflict count into the chain's
// running total, and the step counter and key advanced.
//
// Replaces the batch generation and tally inside the reference bench's
// device loops, foundationdb_tpu's bench.py:122 bench_tpu_point and
// :201 bench_tpu (jax.random.split / randint / gen_keys at :149-153 and
// :230-234, the conflict sum at :164-174 and :240-258).
//
// Both read and write an 18-word control block (ops/bench_chain.py
// C_*): the carried threefry key, the step counter i, the running
// conflict count, the next key, kr and kw that K9 derives, and the four
// randint keys of the carried key (RK: kr's two halves, kw's two). K9
// reads i and RK and writes the derived keys; K10, after the resolve
// step, commits the next key and i + 1 and derives the next key's RK.
// The host never reads i.
//
// K9 is jax.random bit for bit (JAX 0.9.0, threefry2x32,
// jax_threefry_partitionable): split(key, n) hashes the 2x32 iota (hi
// word 0, lo word the index); randint(k, (n,), 0, hi) splits k in two
// and draws offset = ((h % span) * mult + l % span) % span in uint32
// arithmetic that wraps, where h and l are the two keys' bits at the
// slot. The keys every slot of a side shares come from RK, so a slot's
// critical path is two independent threefry evaluations, one deep, and
// each thread takes two slots (four independent evaluations to hide
// each other's latency). `% span` is a multiply-high by the host's
// magic floor(2^32 / span) and one correction, exact for every uint32.
// A block takes a contiguous chunk of one side's slots (blockIdx.y is
// the side). With `whole` false it stores only what changes: the id
// word of each row, the snapshots and the versions; the zero words and
// the length word are written once, when the chain makes its buffers
// (or by a call with `whole` true, which stages the chunk's ids in
// shared memory and stores whole rows as contiguous words).
//
// Bound: operations. K9 hashes every slot twice (77 integer operations
// a threefry evaluation) and writes ~0.1-0.7 MB; a launch's own floor
// (~1.5-2 us traced on the H100) is far above both. K10 reads T flag
// bytes (16 KB, 0.005 us): one block of 1024 threads, one 16-byte load
// a thread at 16,384 flags and one barrier, so its time is the launch's
// own floor; its first warp derives RK while the loads are in flight.
// It counts nonzero flag bytes, whatever their alignment.

#include "common.cuh"

namespace {

constexpr int32_t VERSION_STEP = 250000;  // ops/bench_chain.py
constexpr int32_t MWTLV = 5000000;
constexpr uint32_t KEY_BYTES = 16;
// C_NEXT: split(key, 3), six words (the next key, kr, kw)
enum { C_KEY = 0, C_STEP = 2, C_NCONF = 3, C_NEXT = 4, C_RK = 10 };
constexpr int GEN_THREADS = 128;
constexpr int GEN_SLOTS = 2 * GEN_THREADS;  // two slots a thread
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
__device__ __forceinline__ void split_row(uint32_t k0, uint32_t k1,
                                          uint32_t j, uint32_t& y0,
                                          uint32_t& y1) {
  threefry(k0, k1, 0u, j, y0, y1);
}

__device__ __forceinline__ uint32_t bits32(uint32_t k0, uint32_t k1,
                                           uint32_t j) {
  uint32_t a, b;
  threefry(k0, k1, 0u, j, a, b);
  return a ^ b;
}

// x % d for every uint32 x, with magic = floor(2^32 / d) (d >= 2) or
// 2^32 - 1 (d = 1): the quotient estimate is floor(x / d) or one less
__device__ __forceinline__ uint32_t mod_by(uint32_t x, uint32_t d,
                                           uint32_t magic) {
  const uint32_t r = x - __umulhi(x, magic) * d;
  return r >= d ? r - d : r;
}

template <bool kWhole>
__global__ void __launch_bounds__(GEN_THREADS)
    chain_gen_kernel(uint32_t* ctl, uint32_t* __restrict__ rb,
                     uint32_t* __restrict__ re, uint32_t* __restrict__ wb,
                     uint32_t* __restrict__ we, int32_t* __restrict__ snap,
                     int32_t* __restrict__ commit,
                     int32_t* __restrict__ oldest, int n_reads,
                     int n_writes, int n_txns, int width, uint32_t span,
                     uint32_t magic, uint32_t mult) {
  const int t = threadIdx.x;
  const int gt = (blockIdx.y * gridDim.x + blockIdx.x) * GEN_THREADS + t;
  const int32_t v = (static_cast<int32_t>(ctl[C_STEP]) + 2) * VERSION_STEP;
  for (int s = gt; s < n_txns; s += gridDim.x * gridDim.y * GEN_THREADS)
    snap[s] = v - VERSION_STEP;
  if (gt < 3) {
    // the next key, kr and kw: split(key, 3), read by K10 only
    uint32_t y0, y1;
    split_row(ctl[C_KEY], ctl[C_KEY + 1], gt, y0, y1);
    ctl[C_NEXT + 2 * gt] = y0;
    ctl[C_NEXT + 2 * gt + 1] = y1;
    if (gt == 0) {
      *commit = v;
      *oldest = max(v - MWTLV, 0);
    }
  }
  const int side = blockIdx.y;
  const int n = side ? n_writes : n_reads;
  const int base = blockIdx.x * GEN_SLOTS;
  if (base >= n) return;  // the whole block
  const uint32_t* rk = ctl + C_RK + 4 * side;
  const uint32_t h0 = rk[0], h1 = rk[1], l0 = rk[2], l1 = rk[3];
  uint32_t id[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const uint32_t j = static_cast<uint32_t>(base + t + u * GEN_THREADS);
    const uint32_t higher = bits32(h0, h1, j), lower = bits32(l0, l1, j);
    // wraps, as JAX's uint32 arithmetic does
    const uint32_t off =
        mod_by(higher, span, magic) * mult + mod_by(lower, span, magic);
    id[u] = mod_by(off, span, magic);
  }
  uint32_t* b = side ? wb : rb;
  uint32_t* e = side ? we : re;
  if constexpr (kWhole) {
    __shared__ uint32_t ids[GEN_SLOTS];
    ids[t] = id[0];
    ids[t + GEN_THREADS] = id[1];
    __syncthreads();
    const int words = min(GEN_SLOTS, n - base) * width;
    b += static_cast<size_t>(base) * width;
    if (e) e += static_cast<size_t>(base) * width;
    for (int w = t; w < words; w += GEN_THREADS) {
      const int s = w / width, col = w - s * width;
      const uint32_t x = col == width - 2 ? ids[s]
                         : col == width - 1 ? KEY_BYTES : 0u;
      b[w] = x;
      // the end key is key + b"\x00"
      if (e) e[w] = col == width - 1 ? KEY_BYTES + 1 : x;
    }
  } else {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int j = base + t + u * GEN_THREADS;
      if (j >= n) break;
      const size_t at = static_cast<size_t>(j) * width + width - 2;
      b[at] = id[u];
      if (e) e[at] = id[u];
    }
  }
}

// one block of TALLY_THREADS: a thread counts the nonzero bytes of one
// 16-byte word of the flags a round (one round up to 16,384 aligned
// flags), the unaligned head and the tail (< 16 bytes each) a byte a
// thread; each warp sums with __reduce_add_sync, and the warps' sums
// meet in shared memory behind the kernel's one barrier. Lanes 0-3 of
// the first warp derive the next key's RK meanwhile: lane l hashes the
// next key into side l / 2's key, then that into its half l % 2.
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
  // the first round's load is issued before the hashing, which hides it
  const uint4 first = t < n_vec ? vec[t] : make_uint4(0u, 0u, 0u, 0u);
  uint32_t rk0 = 0, rk1 = 0;
  if (t < 4) {
    uint32_t s0, s1;
    split_row(ctl[C_NEXT], ctl[C_NEXT + 1], 1u + (t >> 1), s0, s1);
    split_row(s0, s1, t & 1, rk0, rk1);
  }
  int cnt = 0;
  for (int v = t; v < n_vec; v += TALLY_THREADS) {
    const uint4 x = v == t ? first : vec[v];
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
  if (t < 4) {
    ctl[C_RK + 2 * t] = rk0;
    ctl[C_RK + 2 * t + 1] = rk1;
  }
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
                          unsigned magic, unsigned mult, int whole,
                          void* stream) {
  if (!ctl || !rb || !wb || !snap || !commit || !oldest || n_reads < 0 ||
      n_writes < 0 || n_txns < 0 || width < 2 || span == 0u ||
      (re == nullptr) != (we == nullptr))
    return fdb::ERR_BAD_ARGS;
  const int most = n_reads > n_writes ? n_reads : n_writes;
  const dim3 grid(most > 0 ? fdb::blocks_for(most, GEN_SLOTS) : 1, 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (whole)
    chain_gen_kernel<true><<<grid, GEN_THREADS, 0, st>>>(
        ctl, rb, re, wb, we, snap, commit, oldest, n_reads, n_writes, n_txns,
        width, span, magic, mult);
  else
    chain_gen_kernel<false><<<grid, GEN_THREADS, 0, st>>>(
        ctl, rb, re, wb, we, snap, commit, oldest, n_reads, n_writes, n_txns,
        width, span, magic, mult);
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
