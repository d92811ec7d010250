"""The bench entry's device-driven chains: the batch generator (K9),
the conflict tally (K10) and the point and interval chains built on
them, each kernel beside its plain PyTorch version.

Replaces the reference bench's `bench_tpu_point` and `bench_tpu`
(bench.py:122 and :201): a `lax.fori_loop` of `n_batches` resolve
steps in one dispatch, each step making its own batch on the device.
A step of chain `i` is

  key, kr, kw = split(key, 3)
  read rows  = gen_rows(kr, R)     (uint32 [R, W+1]; end rows: length 17)
  write rows = gen_rows(kw, Wr)
  commit = (i + 2) * VERSION_STEP, oldest = max(commit - MWTLV, 0),
  snapshots = commit - VERSION_STEP
  (state, conflict) = K5 or K3 step
  nconf += sum(conflict)

where `split` and `gen_rows` are `jax.random.split` and
`jax.random.randint` bit for bit (JAX 0.9.0, threefry2x32 with
`jax_threefry_partitionable` True, the default): a chain started from
`PRNGKey(7)` draws the reference bench's batches and counts its
conflicts. The port holds its whole step counter on the card: K9
reads the carried key and `i` from a small control block, K10 adds the
step's conflicts and advances both, so the host loop only enqueues and
never learns `i`. The control block also carries the four randint
keys of the carried key (`C_RK`, the keys every slot of a step hashes
under), which K10 derives when it advances the key: K9's slots hash
their index and nothing else. `chain_ctl` makes a well-formed block.

The plain versions compute in int64 with `& 0xFFFFFFFF` after every
operation (PyTorch's uint32 lacks shifts and wrapping products on some
builds). `randint`'s multiplier, product and sum wrap modulo 2^32
before its last `%`, as JAX's uint32 arithmetic does: with a keyspace
above 2^16 64-bit arithmetic would give other ids.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import device as _device
from . import conflict_kernel as _ck
from . import point_kernel as _pk
from .keys import next_pow2

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

KEY_BYTES = 16
N_WORDS = KEY_BYTES // 4
MWTLV = 5_000_000
VERSION_STEP = 250_000
WINDOW_BATCHES = MWTLV // VERSION_STEP

# the control block K9 and K10 share (uint32 words): the carried key,
# the step counter, the conflict count, split(key, 3) as K9 derives it,
# and the randint keys of the carried key (kr's two halves, kw's two)
C_KEY, C_STEP, C_NCONF, C_NEXT, C_KR, C_KW, C_RK, C_WORDS = \
    0, 2, 3, 4, 6, 8, 10, 18

launches = {"chain_gen": 0, "chain_tally": 0}


# ---------------------------------------------------------------------------
# jax.random's threefry, split and randint in plain PyTorch
# ---------------------------------------------------------------------------

def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32, 20 rounds (jax/_src/prng.py
    `_threefry2x32_lowering`); int64 tensors or ints holding uint32
    values; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & M32
    x2 = (x2 + ks[1]) & M32
    for r in range(5):
        for rot in _ROTATIONS[r % 2]:
            x1 = (x1 + x2) & M32
            x2 = ((x2 << rot) & M32) | (x2 >> (32 - rot))
            x2 = x1 ^ x2
        x1 = (x1 + ks[(r + 1) % 3]) & M32
        x2 = (x2 + ks[(r + 2) % 3] + r + 1) & M32
    return x1, x2


def _iota_hash(key, n: int):
    """threefry of the key over the 2x32 iota of shape (n,): the hi
    word 0, the lo word the index (on the key's device)."""
    k = torch.as_tensor(key).to(torch.int64).reshape(2) & M32
    lo = torch.arange(n, dtype=torch.int64, device=k.device)
    return threefry2x32(k[0], k[1], torch.zeros_like(lo), lo)


def split(key, n: int = 2) -> torch.Tensor:
    """`jax.random.split(key, n)` (the fold-like split): uint32 [n, 2]."""
    b1, b2 = _iota_hash(key, n)
    return torch.stack([b1, b2], dim=1).to(torch.uint32)


def random_bits32(key, n: int) -> torch.Tensor:
    """`jax.random.bits(key, (n,), uint32)`: int64 [n] of uint32 values."""
    b1, b2 = _iota_hash(key, n)
    return b1 ^ b2


def randint_span(lo: int, hi: int):
    """randint's `span` and `multiplier` for [lo, hi) in int32. The
    square wraps modulo 2^32 as JAX's uint32 product does: above a span
    of 2^16 it is 2^32, so the multiplier is 0."""
    span = (hi - lo) & M32 if hi > lo else 1
    m = 65536 % span
    return span, ((m * m) & M32) % span


def mod_magic(span: int) -> int:
    """K9's multiplier for `x % span` (csrc/bench_chain.cu `mod_by`):
    floor(2^32 / span), or 2^32 - 1 for a span of 1. Then
    q = (x * magic) >> 32 is floor(x / span) or one less for every
    uint32 x, so x - q * span needs at most one subtraction of span."""
    if not 0 < span < 1 << 32:
        raise ValueError("span must lie in [1, 2^32)")
    return M32 if span == 1 else (1 << 32) // span


def randint(key, n: int, lo: int, hi: int) -> torch.Tensor:
    """`jax.random.randint(key, (n,), lo, hi, int32)`: int32 [n]."""
    k = split(key, 2)
    higher = random_bits32(k[0], n)
    lower = random_bits32(k[1], n)
    span, mult = randint_span(lo, hi)
    off = ((((higher % span) * mult) & M32) + lower % span) & M32
    val = (lo + off % span) & M32
    return (val - ((val >> 31) << 32)).to(torch.int32)


def _rows64(key, slots, keyspace, n_words, length):
    rows = torch.zeros((slots, n_words + 1), dtype=torch.int64,
                       device=torch.as_tensor(key).device)
    rows[:, n_words - 1] = randint(key, slots, 0, keyspace).to(
        torch.int64) & M32
    rows[:, n_words] = length
    return rows


def gen_rows(key, slots: int, keyspace: int, n_words: int = N_WORDS,
             length: int = KEY_BYTES) -> torch.Tensor:
    """The reference bench's `gen_keys` (bench.py:149-153): uint32
    [slots, n_words+1] rows, the randint id in word n_words-1, the
    length word `length` (16 for begin rows, 17 for end rows)."""
    return _rows64(key, slots, keyspace, n_words, length).to(torch.uint32)


def randint_keys(key) -> torch.Tensor:
    """The four keys a chain step's `randint` draws hash under, from the
    step's key: split(kr, 2) then split(kw, 2), where (_, kr, kw) =
    split(key, 3); int64 [8] of uint32 values (the control block's
    `C_RK` words)."""
    _nk, kr, kw = split(key, 3).to(torch.int64)
    return torch.cat([split(kr, 2).reshape(-1),
                      split(kw, 2).reshape(-1)]).to(torch.int64)


def chain_ctl(key, step: int = 0) -> torch.Tensor:
    """A well-formed control block (CPU, uint32 [C_WORDS]) at step
    `step` with the carried key `key` and its randint keys; the other
    words 0."""
    c = torch.zeros(C_WORDS, dtype=torch.int64)
    c[C_KEY:C_KEY + 2] = torch.as_tensor(key).to(torch.int64).reshape(2) \
        & M32
    c[C_STEP] = step
    c[C_RK:C_RK + 8] = randint_keys(c[C_KEY:C_KEY + 2])
    return c.to(torch.uint32)


def key_from_jax(key) -> torch.Tensor:
    """A JAX threefry key (`jax.random.key_data`, numpy uint32 [2]) as
    the port's key: uint32 [2]. `jax.random.PRNGKey(7)` is [0, 7]."""
    k = np.asarray(key, dtype=np.uint32).reshape(2)
    return torch.from_numpy(k.copy())


def prng_key(seed: int) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)` for 0 <= seed < 2^31: [0, seed]."""
    if not 0 <= seed < 1 << 31:
        raise ValueError("seed must lie in [0, 2^31)")
    return torch.tensor([0, seed], dtype=torch.int64).to(torch.uint32)


# ---------------------------------------------------------------------------
# K9, the batch generator, and K10, the tally (csrc/bench_chain.cu)
# ---------------------------------------------------------------------------

def chain_gen_plain(ctl, rb, re, wb, we, snap, commit, oldest,
                    keyspace: int) -> None:
    """K9's plain version, in place: from the carried key and step
    counter in `ctl`, the next key, kr and kw, the read and write rows
    (the end rows when `re`/`we` are given; always whole) and the
    step's versions. It derives every key from the carried key, where
    the kernel reads the randint keys from `C_RK`: on a well-formed
    block (`chain_ctl`, then K10's) the two agree. It runs on the
    tensors' device (on the card it reads the step counter back, a
    sync)."""
    c = ctl.to(torch.int64)
    key = c[C_KEY:C_KEY + 2]
    nk, kr, kw = split(key, 3).to(torch.int64)
    n_words = rb.shape[1] - 1
    for k, b, e in ((kr, rb, re), (kw, wb, we)):
        rows = _rows64(k, b.shape[0], keyspace, n_words, KEY_BYTES)
        b.copy_(rows.to(torch.uint32))
        if e is not None:
            rows[:, n_words] = KEY_BYTES + 1
            e.copy_(rows.to(torch.uint32))
    i = int(c[C_STEP])
    v = (i + 2) * VERSION_STEP
    commit.fill_(v)
    oldest.fill_(max(v - MWTLV, 0))
    snap.fill_(v - VERSION_STEP)
    ctl[C_NEXT:C_NEXT + 6] = torch.cat([nk, kr, kw]).to(torch.uint32)


def chain_tally_plain(ctl, conflict, n_txns: int, per_step=None) -> None:
    """K10's plain version, in place: nconf += sum(conflict[:n_txns]),
    per_step[i] = that sum (when given and i fits), i += 1, the key K9
    made becomes the carried key, and its randint keys go to `C_RK`."""
    c = ctl.to(torch.int64)
    total = int(conflict[:n_txns].to(torch.int64).sum())
    i = int(c[C_STEP])
    if per_step is not None and i < per_step.shape[0]:
        per_step[i] = total
    c[C_NCONF] = (c[C_NCONF] + total) & M32
    c[C_STEP] = (i + 1) & M32
    c[C_KEY:C_KEY + 2] = c[C_NEXT:C_NEXT + 2]
    c[C_RK:C_RK + 8] = randint_keys(c[C_KEY:C_KEY + 2])
    ctl.copy_(c.to(torch.uint32))


def _check_rows(t, n, width, dev, what):
    if t is None:
        return 0
    if t.dtype != torch.uint32 or tuple(t.shape) != (n, width) \
            or not t.is_contiguous() or t.device != dev:
        raise ValueError(f"{what} must be contiguous uint32 [{n}, {width}] "
                         "rows on the control block's device")
    return t.data_ptr()


def _check_ctl(ctl):
    if ctl.dtype != torch.uint32 or tuple(ctl.shape) != (C_WORDS,) \
            or not ctl.is_contiguous():
        raise ValueError(f"the control block must be contiguous uint32 "
                         f"[{C_WORDS}]")


def chain_gen(ctl, rb, re, wb, we, snap, commit, oldest,
              keyspace: int, whole: bool = True) -> None:
    """K9 on CUDA tensors, its plain version on CPU tensors; writes
    every output in place. `re`/`we` are None on the point chain. With
    `whole` False the kernel stores only each row's id word: the rows'
    other words must already hold zeros and the length (16, 17 for end
    rows), as `BenchChain`'s buffers do."""
    _check_ctl(ctl)
    if not _device.is_cuda(ctl):
        return chain_gen_plain(ctl, rb, re, wb, we, snap, commit, oldest,
                               keyspace)
    from ._build import check, lib
    dev = ctl.device
    width = rb.shape[1]
    n_reads, n_writes = rb.shape[0], wb.shape[0]
    ptrs = [_check_rows(t, n, width, dev, what) for t, n, what in (
        (rb, n_reads, "read rows"), (re, n_reads, "read end rows"),
        (wb, n_writes, "write rows"), (we, n_writes, "write end rows"))]
    if (re is None) != (we is None):
        raise ValueError("end rows go with both the reads and the writes")
    for t, shape in ((snap, (snap.shape[0],)), (commit, ()), (oldest, ())):
        if t.dtype != torch.int32 or tuple(t.shape) != shape \
                or t.device != dev or not t.is_contiguous():
            raise ValueError("snapshots, commit and oldest must be int32 "
                             "on the control block's device")
    if not 0 < keyspace < 1 << 31:
        raise ValueError("keyspace must lie in [1, 2^31)")
    span, mult = randint_span(0, keyspace)
    check(lib().fdb_chain_gen(
        ctl.data_ptr(), *[p or None for p in ptrs], snap.data_ptr(),
        commit.data_ptr(), oldest.data_ptr(), n_reads, n_writes,
        snap.shape[0], width, span, mod_magic(span), mult, int(whole),
        _device.stream_handle(dev)),
        "chain_gen")
    launches["chain_gen"] += 1


def chain_tally(ctl, conflict, n_txns: int, per_step=None) -> None:
    """K10 on CUDA tensors, its plain version on CPU tensors."""
    _check_ctl(ctl)
    if not _device.is_cuda(ctl):
        return chain_tally_plain(ctl, conflict, n_txns, per_step)
    from ._build import check, lib
    dev = ctl.device
    if conflict.dtype != torch.bool or conflict.dim() != 1 \
            or conflict.shape[0] < n_txns or conflict.device != dev \
            or not conflict.is_contiguous():
        raise ValueError("conflict must be a contiguous bool vector of at "
                         "least n_txns flags on the control block's device")
    if per_step is not None and (per_step.dtype != torch.int32
                                 or per_step.dim() != 1
                                 or per_step.device != dev):
        raise ValueError("per_step must be an int32 vector beside ctl")
    check(lib().fdb_chain_tally(
        ctl.data_ptr(), conflict.data_ptr(), n_txns,
        None if per_step is None else per_step.data_ptr(),
        0 if per_step is None else per_step.shape[0],
        _device.stream_handle(dev)), "chain_tally")
    launches["chain_tally"] += 1


# ---------------------------------------------------------------------------
# the chains
# ---------------------------------------------------------------------------

class BenchChain:
    """One device-driven bench chain: `kind` "point" (K5 steps, the
    reference's `bench_tpu_point`) or "interval" (K3 steps, `bench_tpu`)
    at the reference's sizes, with its initial state, its constant
    inputs and every per-step buffer allocated once. `step()` enqueues
    K9, the resolve step and K10 and nothing else: no sync and no
    allocation on the card. `record` keeps the first `record` steps'
    conflict counts on the card (`per_step`); `cap` replaces the
    reference's capacity (the tests take small ones)."""

    def __init__(self, kind: str, n_txns: int, keyspace: int, key=None,
                 device=None, reads_per_txn: int = 1, record: int = 0,
                 cap: int | None = None):
        if kind not in ("point", "interval"):
            raise ValueError(f"unknown chain kind {kind!r}")
        dev = _device.resolve(device)
        self.kind, self.device, self.keyspace = kind, dev, int(keyspace)
        n = self.n_txns = next_pow2(n_txns)
        nr = self.n_reads = next_pow2(n * reads_per_txn)
        if kind == "point":
            nw = n
            cap_ref = next_pow2((WINDOW_BATCHES + 2) * n + 2)
            self.slack = 2
        else:
            nw = next_pow2(n)
            cap_ref = max(1 << 17, next_pow2(3 * WINDOW_BATCHES * n))
            self.slack = 2 * n + 2
        self.n_writes, self.cap = nw, cap if cap is not None else cap_ref
        width = N_WORDS + 1
        hk0 = torch.full((self.cap, width), M32, dtype=torch.int64)
        hv0 = torch.full((self.cap,), -(1 << 30), dtype=torch.int32)
        if kind == "interval":
            hk0[0] = 0
            hv0[0] = 0
        self._init = (hk0.to(torch.uint32).to(dev), hv0.to(dev))

        def rows(k, length=KEY_BYTES):
            # the words K9 leaves alone: zeros and the length word
            r = torch.zeros((k, width), dtype=torch.uint32, device=dev)
            r[:, N_WORDS] = length
            return r

        self.rb, self.wb = rows(nr), rows(nw)
        self.re, self.we = ((rows(nr, KEY_BYTES + 1), rows(nw, KEY_BYTES + 1))
                            if kind == "interval" else (None, None))
        i32 = torch.int32
        self.snap = torch.zeros(n, dtype=i32, device=dev)
        self.commit = torch.zeros((), dtype=i32, device=dev)
        self.oldest = torch.zeros((), dtype=i32, device=dev)
        self.init_off = torch.zeros((), dtype=i32, device=dev)
        ar = np.arange(nr)
        self.rt = torch.from_numpy(np.minimum(ar // reads_per_txn, n)
                                   .astype(np.int32)).to(dev)
        self.wt = torch.from_numpy(np.minimum(np.arange(nw), n)
                                   .astype(np.int32)).to(dev)
        self.rvalid = torch.from_numpy(ar < n * reads_per_txn).to(dev)
        self.wvalid = torch.from_numpy(np.arange(nw) < n).to(dev)
        self.too_old = torch.zeros(n, dtype=torch.bool, device=dev)
        self.ctl = torch.zeros(C_WORDS, dtype=torch.uint32, device=dev)
        self.per_step = (torch.zeros(record, dtype=i32, device=dev)
                         if record else None)
        self._ctl0 = chain_ctl(prng_key(7) if key is None else key).to(dev)
        cuda = dev.type == "cuda"
        self._pairs = [(torch.empty_like(self._init[0]),
                        torch.empty_like(self._init[1]))
                       for _ in range(2 if cuda else 1)]
        self._count = torch.zeros((), dtype=i32, device=dev)
        self._conflict = torch.zeros(n, dtype=torch.bool, device=dev)
        self.reset()

    def reset(self) -> None:
        """A fresh copy of the initial state, key and counters (device
        copies only)."""
        self.state = self._pairs[0]
        self.state[0].copy_(self._init[0])
        self.state[1].copy_(self._init[1])
        self.ctl.copy_(self._ctl0)
        if self.per_step is not None:
            self.per_step.zero_()
        self.steps = 0
        self.count = self._count
        self.conflict = self._conflict

    def _resolve(self, out):
        hk, hv = self.state
        if self.kind == "point":
            return _pk.point_resolve_step(
                hk, hv, self.snap, self.too_old, self.rb, self.rt,
                self.rvalid, self.wb, self.wt, self.wvalid, self.commit,
                self.oldest, self.init_off, attribute=False, out=out)
        return _ck.resolve_step(
            hk, hv, self.snap, self.too_old, self.rb, self.re, self.rt,
            self.rvalid, self.wb, self.we, self.wt, self.wvalid,
            self.commit, self.oldest, attribute=False, out=out)

    def step(self) -> torch.Tensor:
        """Enqueue one step; returns its conflict flags (a buffer the
        next step overwrites on the card)."""
        chain_gen(self.ctl, self.rb, self.re, self.wb, self.we, self.snap,
                  self.commit, self.oldest, self.keyspace, whole=False)
        out = None
        if len(self._pairs) == 2:
            nxt = self._pairs[1] if self.state[0] is self._pairs[0][0] \
                else self._pairs[0]
            out = (*nxt, self._count, self._conflict)
        hk, hv, count, conflict, _hit = self._resolve(out)
        self.state, self.count, self.conflict = (hk, hv), count, conflict
        chain_tally(self.ctl, conflict, self.n_txns, self.per_step)
        self.steps += 1
        return conflict

    def run(self, n_steps: int, enqueue_s=None, spans=None) -> None:
        """Enqueue `n_steps` steps. `enqueue_s` (a list) gets each step's
        host enqueue time; `spans` (a list, card only) gets a pair of
        CUDA events around each step."""
        for _ in range(n_steps):
            if spans is not None:
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            self.step()
            if enqueue_s is not None:
                enqueue_s.append(time.perf_counter() - t0)
            if spans is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                spans.append((start, end))

    def conflicts(self) -> int:
        """The running conflict count (waits for the card)."""
        return int(self.ctl[C_NCONF].to(torch.int64))

    def key(self) -> np.ndarray:
        """The carried key, uint32 [2] (waits for the card)."""
        return self.ctl[C_KEY:C_KEY + 2].cpu().numpy()

    def step_counts(self) -> list:
        return [] if self.per_step is None else \
            self.per_step.cpu().tolist()[:self.steps]

    def audit(self) -> int:
        """The reference's capacity audit (`probe_count`,
        bench.py:179-190 and :266-269): one step past the chain on the
        final state (two on the point chain, whose probe runs a body
        step first); its live-row count must stay within cap - slack.
        Raises on overflow; returns the count."""
        for _ in range(2 if self.kind == "point" else 1):
            self.step()
        count = int(self.count)
        if count > self.cap - self.slack:
            raise RuntimeError(
                f"bench state capacity overflow: count {count} vs cap "
                f"{self.cap} - rows would silently drop; raise cap sizing")
        return count


def _check_batches(n_batches: int) -> None:
    if (n_batches + 4) * VERSION_STEP >= 1 << 30:
        raise ValueError("FDBTPU_BENCH_BATCHES too large: device versions "
                         "are int32 offsets and the bench loop never rebases")


def _run_chain(kind, n_txns, n_batches, keyspace, key, device,
               reads_per_txn):
    _check_batches(n_batches)
    chain = BenchChain(kind, n_txns, keyspace, key, device, reads_per_txn)
    chain.run(n_batches)
    n_conflicts = chain.conflicts()
    chain.audit()
    return n_conflicts, chain


def run_point_chain(n_txns: int, n_batches: int, keyspace: int, key=None,
                    device=None, reads_per_txn: int = 1):
    """The reference's `bench_tpu_point` chain once, untimed: returns
    (total conflicts, the chain after its capacity audit)."""
    return _run_chain("point", n_txns, n_batches, keyspace, key, device,
                      reads_per_txn)


def run_interval_chain(n_txns: int, n_batches: int, keyspace: int, key=None,
                       device=None, reads_per_txn: int = 1):
    """The reference's `bench_tpu` chain once, untimed: returns (total
    conflicts, the chain after its capacity audit)."""
    return _run_chain("interval", n_txns, n_batches, keyspace, key, device,
                      reads_per_txn)


def measure_chain(kind: str, n_txns: int, n_batches: int, keyspace: int,
                  repeats: int = 4, device=None, reads_per_txn: int = 1):
    """The reference's `_measure_device_run` on the port: a 2-step
    warm-up, then the best of `repeats` runs of `n_batches` steps, each
    from a fresh copy of the initial state, timed by CUDA events around
    the whole chain and by the host clock (the card is local: no sync
    floor is taken off), then the capacity audit. Returns a dict."""
    _check_batches(n_batches)
    chain = BenchChain(kind, n_txns, keyspace, None, device, reads_per_txn)
    cuda = chain.device.type == "cuda"
    chain.run(2)
    _device.synchronize(chain.device)
    best = None
    for _ in range(max(1, repeats)):
        chain.reset()
        enq = []
        _device.synchronize(chain.device)
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        chain.run(n_batches, enqueue_s=enq)
        if cuda:
            end.record()
            end.synchronize()
        wall = time.perf_counter() - t0
        dev_ms = start.elapsed_time(end) if cuda else None
        n_conflicts = chain.conflicts()
        if best is None or wall < best["wall_s"]:
            best = {"wall_s": wall, "device_ms": dev_ms,
                    "enqueue_ms_per_step": 1e3 * sum(enq) / len(enq),
                    "conflicts": n_conflicts}
    best["audit_rows"] = chain.audit()
    best["cap"] = chain.cap
    best["txn_per_s"] = n_batches * chain.n_txns / best["wall_s"]
    best["ms_per_batch"] = 1e3 * best["wall_s"] / n_batches
    return best

