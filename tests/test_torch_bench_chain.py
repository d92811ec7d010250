"""Port parity for ops/bench_chain.py: the plain threefry2x32, split,
random bits, randint and row generator equal jax.random bit for bit;
the CPU point and interval chains count exactly the reference bench's
conflicts (bench.py `bench_tpu_point` / `bench_tpu`) and, step by step,
give the state, conflict flags and key of a JAX loop over the
reference's resolve cores; the control block carries jax.random's
randint keys; K9's remainder by a multiplier is exact for every uint32;
K10's plain version counts the set flags
at lengths around a 16-byte word and around 16,384, with and
without per_step; K9 and K10 equal their plain versions on the card
(CUDA-marked; K10 also at those lengths on a view one byte off
alignment)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.extend.random as jex_random  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from foundationdb_tpu_torch.ops import bench_chain as bc  # noqa: E402

SEEDS = (7, 0, 1234567, 2**31 - 1)
SLOTS = (1, 7, 256, 16384)
KEYSPACES = (1, 8192, 4_000_000, 2**31 - 1)
N_WORDS, KEY_BYTES, VERSION_STEP, MWTLV = 4, 16, 250_000, 5_000_000


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain chains run on small tensors: one intra-op thread is
    faster here and leaves the other test workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_threefry_partitionable_is_the_default():
    assert jax.config.jax_threefry_partitionable is True, (
        "jax_threefry_partitionable is off: jax.random draws other bits "
        "and the port's generator (which follows the partitionable "
        "split and bits) no longer matches it")


def keys_under_test():
    """PRNGKey(seed) for each seed, and keys split off them."""
    out = []
    for seed in SEEDS:
        k = jax.random.PRNGKey(seed)
        out.append(k)
        out.extend(jax.random.split(k, 2))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    assert np.array_equal(bc.prng_key(seed).numpy(),
                          np.asarray(jax.random.PRNGKey(seed)))
    assert np.array_equal(bc.key_from_jax(jax.random.PRNGKey(seed)).numpy(),
                          np.asarray(jax.random.PRNGKey(seed)))


def test_threefry2x32_matches_jax():
    rng = np.random.default_rng(11)
    x = rng.integers(0, 2**32, 2 * 4096, dtype=np.uint64).astype(np.uint32)
    for k1, k2 in ((0, 7), (0xFFFFFFFF, 0), (123, 0x1BD11BDA)):
        want = np.asarray(jex_random.threefry_2x32(
            (np.uint32(k1), np.uint32(k2)), jnp.asarray(x)))
        y1, y2 = bc.threefry2x32(k1, k2,
                                 torch.from_numpy(x[:4096].astype(np.int64)),
                                 torch.from_numpy(x[4096:].astype(np.int64)))
        got = torch.cat([y1, y2]).numpy().astype(np.uint32)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("n", (1, 2, 3, 7, 16))
def test_split_matches_jax(n):
    for key in keys_under_test():
        want = np.asarray(jax.random.split(key, n))
        got = bc.split(bc.key_from_jax(key), n).numpy()
        assert np.array_equal(got, want)


@pytest.mark.parametrize("n", SLOTS)
def test_random_bits_match_jax(n):
    for key in keys_under_test():
        want = np.asarray(jax.random.bits(key, (n,), jnp.uint32))
        got = bc.random_bits32(bc.key_from_jax(key), n).numpy()
        assert np.array_equal(got.astype(np.uint32), want)


@pytest.mark.parametrize("keyspace", KEYSPACES)
@pytest.mark.parametrize("n", SLOTS)
def test_randint_matches_jax(n, keyspace):
    for key in keys_under_test():
        want = np.asarray(jax.random.randint(key, (n,), 0, keyspace,
                                             dtype=jnp.int32))
        got = bc.randint(bc.key_from_jax(key), n, 0, keyspace).numpy()
        assert got.dtype == np.int32
        assert np.array_equal(got, want)


def test_randint_empty_and_offset_ranges_match_jax():
    key = jax.random.PRNGKey(3)
    for lo, hi in ((5, 5), (9, 2), (-100, 100), (-(2**31), 2**31 - 1),
                   (1000, 1000 + 2**16 + 1)):
        want = np.asarray(jax.random.randint(key, (300,), lo, hi,
                                             dtype=jnp.int32))
        got = bc.randint(bc.key_from_jax(key), 300, lo, hi).numpy()
        assert np.array_equal(got, want), (lo, hi)


def jax_gen_keys(key, slots, keyspace, n_words=N_WORDS):
    """The reference bench's gen_keys (bench.py:149-153)."""
    idx = jax.random.randint(key, (slots,), 0, keyspace, dtype=jnp.int32)
    k = jnp.zeros((slots, n_words + 1), jnp.uint32)
    k = k.at[:, n_words - 1].set(idx.astype(jnp.uint32))
    return k.at[:, n_words].set(KEY_BYTES)


@pytest.mark.parametrize("keyspace", (8192, 4_000_000))
def test_gen_rows_matches_reference_gen_keys(keyspace):
    for key in keys_under_test()[:6]:
        want = np.array(jax_gen_keys(key, 512, keyspace))
        got = bc.gen_rows(bc.key_from_jax(key), 512, keyspace).numpy()
        assert np.array_equal(got, want)
        end = bc.gen_rows(bc.key_from_jax(key), 512, keyspace,
                          length=KEY_BYTES + 1).numpy()
        want[:, N_WORDS] = KEY_BYTES + 1
        assert np.array_equal(end, want)


@pytest.mark.parametrize("interval", (False, True))
def test_chain_gen_plain_is_one_reference_step(interval):
    """K9's plain version from a control block at step 5: the split,
    the rows and the versions of the reference body at i = 5."""
    key = jax.random.PRNGKey(99)
    ctl = torch.zeros(bc.C_WORDS, dtype=torch.uint32)
    ctl[0:2] = bc.key_from_jax(key)
    ctl[bc.C_STEP] = 5
    n, nr, nw = 16, 16, 16
    rb = torch.zeros((nr, N_WORDS + 1), dtype=torch.uint32)
    wb = torch.zeros_like(rb)
    re = torch.zeros_like(rb) if interval else None
    we = torch.zeros_like(wb) if interval else None
    snap = torch.zeros(n, dtype=torch.int32)
    commit = torch.zeros((), dtype=torch.int32)
    oldest = torch.zeros((), dtype=torch.int32)
    bc.chain_gen(ctl, rb, re, wb, we, snap, commit, oldest, 8192)
    nk, kr, kw = jax.random.split(key, 3)
    assert np.array_equal(ctl[bc.C_NEXT:bc.C_NEXT + 6].numpy(),
                          np.concatenate([np.asarray(x) for x in (nk, kr,
                                                                  kw)]))
    want_r = np.array(jax_gen_keys(kr, nr, 8192))
    assert np.array_equal(rb.numpy(), want_r)
    assert np.array_equal(wb.numpy(), np.asarray(jax_gen_keys(kw, nw, 8192)))
    if interval:
        want_r[:, N_WORDS] = KEY_BYTES + 1
        assert np.array_equal(re.numpy(), want_r)
    assert int(commit) == 7 * VERSION_STEP
    assert int(oldest) == 0
    assert (snap.numpy() == 6 * VERSION_STEP).all()
    conflict = torch.zeros(n + 3, dtype=torch.bool)
    conflict[[1, 4, n + 1]] = True          # the slot past n is not counted
    per_step = torch.zeros(8, dtype=torch.int32)
    bc.chain_tally(ctl, conflict, n, per_step)
    assert int(ctl[bc.C_NCONF]) == 2 and int(ctl[bc.C_STEP]) == 6
    assert per_step.tolist() == [0, 0, 0, 0, 0, 2, 0, 0]
    assert np.array_equal(ctl[0:2].numpy(), np.asarray(nk))


def test_chains_count_the_reference_bench_conflicts(monkeypatch):
    """The CPU chains at (256 txns, 24 batches, keyspace 8192) count the
    reference bench's conflicts; the two chains agree with each other."""
    import bench
    monkeypatch.setenv("FDBTPU_BENCH_REPEATS", "1")
    want_point = bench.bench_tpu_point(256, 24, 8192)[1]
    want_interval = bench.bench_tpu(256, 24, 8192)[1]
    got_point, _ = bc.run_point_chain(256, 24, 8192, device="cpu")
    got_interval, _ = bc.run_interval_chain(256, 24, 8192, device="cpu")
    assert got_point == want_point
    assert got_interval == want_interval
    assert got_point == got_interval > 0


def jax_chain(kind, n, keyspace, cap, steps):
    """A JAX loop over the reference's resolve core, the body of
    bench.py's chains step by step: (state, [conflict], key)."""
    from foundationdb_tpu.ops.conflict_kernel import make_resolve_core
    from foundationdb_tpu.ops.point_kernel import make_point_resolve_core
    width = N_WORDS + 1
    rt = jnp.arange(n, dtype=jnp.int32)
    valid = jnp.ones(n, bool)
    too_old = jnp.zeros(n, bool)
    hk = np.full((cap, width), 0xFFFFFFFF, np.uint32)
    hv = np.full((cap,), -(1 << 30), np.int32)
    if kind == "point":
        core = jax.jit(make_point_resolve_core(cap, n, n, n, N_WORDS,
                                               attribute=False))
    else:
        core = jax.jit(make_resolve_core(cap, n, n, n, N_WORDS,
                                         attribute=False))
        hk[0] = 0
        hv[0] = 0
    hk, hv = jnp.asarray(hk), jnp.asarray(hv)
    key = jax.random.PRNGKey(7)
    conflicts = []
    for i in range(steps):
        key, kr, kw = jax.random.split(key, 3)
        rb = jax_gen_keys(kr, n, keyspace)
        wb = jax_gen_keys(kw, n, keyspace)
        commit = jnp.int32((i + 2) * VERSION_STEP)
        snap = jnp.full((n,), 1, jnp.int32) * (commit - VERSION_STEP)
        oldest = jnp.maximum(commit - MWTLV, 0)
        if kind == "point":
            hk, hv, _c, conflict = core(hk, hv, snap, too_old, rb, rt, valid,
                                        wb, rt, valid, commit, oldest,
                                        jnp.int32(0))
        else:
            re = rb.at[:, N_WORDS].set(KEY_BYTES + 1)
            we = wb.at[:, N_WORDS].set(KEY_BYTES + 1)
            hk, hv, _c, conflict = core(hk, hv, snap, too_old, rb, re, rt,
                                        valid, wb, we, rt, valid, commit,
                                        oldest)
        conflicts.append(np.asarray(conflict))
    return (np.asarray(hk), np.asarray(hv)), conflicts, np.asarray(key)


@pytest.mark.parametrize("kind,cap", (("point", 512), ("interval", 1024)))
def test_chain_steps_match_a_jax_loop(kind, cap):
    """Six steps at a small cap and a small keyspace (so the batches
    conflict): the state, every step's conflict flags, the per-step
    counts and the carried key equal the JAX loop's."""
    n, keyspace, steps = 32, 64, 6
    (want_k, want_v), want_c, want_key = jax_chain(kind, n, keyspace, cap,
                                                   steps)
    chain = bc.BenchChain(kind, n, keyspace, device="cpu", record=8,
                          cap=cap)
    got_c = [chain.step().clone().numpy() for _ in range(steps)]
    for g, w in zip(got_c, want_c):
        assert np.array_equal(g, w)
    assert np.array_equal(chain.state[0].numpy(), want_k)
    assert np.array_equal(chain.state[1].numpy(), want_v)
    assert np.array_equal(chain.key(), want_key)
    counts = [int(c.sum()) for c in want_c]
    assert chain.step_counts() == counts and sum(counts) > 0
    assert chain.conflicts() == sum(counts)


def jax_randint_keys(key):
    """The four keys a reference step's two randint calls hash under:
    split(kr, 2) and split(kw, 2) of (_, kr, kw) = split(key, 3)."""
    k = jax.random.wrap_key_data(np.asarray(key, np.uint32),
                                 impl="threefry2x32")
    _nk, kr, kw = jax.random.split(k, 3)
    return np.concatenate([np.asarray(jax.random.key_data(
        jax.random.split(x, 2))).reshape(-1) for x in (kr, kw)]
    ).astype(np.int64)


@pytest.mark.parametrize("step", (0, 9))
def test_chain_ctl_carries_the_randint_keys(step):
    """A fresh control block holds the key, the step and the randint
    keys of the key (what K9 hashes every slot under), nothing else."""
    for key in keys_under_test()[:6]:
        ctl = bc.chain_ctl(bc.key_from_jax(key), step).numpy()
        assert ctl.dtype == np.uint32 and ctl.shape == (bc.C_WORDS,)
        assert np.array_equal(ctl[bc.C_KEY:bc.C_KEY + 2], np.asarray(key))
        assert ctl[bc.C_STEP] == step
        assert np.array_equal(ctl[bc.C_RK:bc.C_RK + 8].astype(np.int64),
                              jax_randint_keys(key))
        rest = np.delete(ctl, list(range(bc.C_RK, bc.C_RK + 8))
                         + [bc.C_KEY, bc.C_KEY + 1, bc.C_STEP])
        assert not rest.any()


@pytest.mark.parametrize("span", (1, 2, 3, 7, 1000, 2**16 + 1, 4_000_000,
                                  2**31 - 1, 2**31, 2**32 - 1))
def test_mod_magic_gives_the_remainder_of_every_uint32(span):
    """K9's `% span` (csrc/bench_chain.cu `mod_by`) emulated in uint64:
    q = (x * magic) >> 32, r = x - q * span, less span once if r >=
    span, equals x % span at the edges and on random words."""
    magic = bc.mod_magic(span)
    rng = np.random.default_rng(span)
    x = np.concatenate([
        rng.integers(0, 2**32, 1 << 16, dtype=np.uint64),
        np.arange(0, 64, dtype=np.uint64),
        2**32 - 1 - np.arange(0, 64, dtype=np.uint64),
        np.uint64(span) * np.arange(1, 64, dtype=np.uint64) % 2**32,
        (np.uint64(span) * np.arange(1, 64, dtype=np.uint64) - 1) % 2**32,
    ]).astype(np.uint64)
    q = (x * np.uint64(magic)) >> np.uint64(32)
    r = x - q * np.uint64(span)
    assert (r < 2 * span).all()
    r = np.where(r >= span, r - span, r)
    assert np.array_equal(r, x % np.uint64(span))
    with pytest.raises(ValueError):
        bc.mod_magic(0)


@pytest.mark.parametrize("kind", ("point", "interval"))
def test_chain_buffers_hold_the_constant_words(kind):
    """The chain's row buffers hold their zero words and length words
    from the start (the kernel stores only the id words a step), and
    a step's rows are the whole rows of `gen_rows`."""
    chain = bc.BenchChain(kind, 16, 8192, device="cpu", cap=512)
    ends = (chain.re, chain.we) if kind == "interval" else ()
    for rows, length in [(chain.rb, KEY_BYTES), (chain.wb, KEY_BYTES)] + \
            [(r, KEY_BYTES + 1) for r in ends]:
        assert (rows[:, N_WORDS] == length).all()
        assert not rows[:, :N_WORDS].to(torch.int64).any()
    chain.step()
    _nk, kr, kw = bc.split(bc.prng_key(7), 3)
    assert torch.equal(chain.rb, bc.gen_rows(kr, chain.n_reads, 8192))
    assert torch.equal(chain.wb, bc.gen_rows(kw, chain.n_writes, 8192))


# K10's edge lengths: one flag, a 16-byte word's neighbours, and
# either side of the chains' 16,384 (one 16-byte load a thread)
TALLY_LENGTHS = (1, 15, 16, 17, 16383, 16385)


def tally_case(n, offset=0):
    """A control block mid-chain and n + 8 flag bytes, about half of
    them set, as a bool view of n flags starting `offset` bytes in."""
    rng = np.random.default_rng(n)
    ctl = torch.from_numpy(rng.integers(0, 2**32, bc.C_WORDS,
                                        dtype=np.uint64).astype(np.uint32))
    ctl[bc.C_STEP] = 3
    raw = (rng.random(n + 8) < 0.5).astype(np.uint8)
    flags = torch.from_numpy(raw).view(torch.bool)[offset:offset + n]
    return ctl, raw[offset:offset + n], flags


@pytest.mark.parametrize("per_step_len", (None, 8, 3))
@pytest.mark.parametrize("n", TALLY_LENGTHS)
def test_chain_tally_plain_counts_nonzero_flags(n, per_step_len):
    """K10's plain version: nconf grows by the count of set flags
    (numpy's count of nonzero bytes), per_step[i] takes it where i = 3
    fits (not in a per_step of 3), the step counter advances, the next
    key becomes the carried key and its randint keys (jax.random's
    split of its kr and kw) fill C_RK; no other word changes."""
    ctl, raw, flags = tally_case(n)
    want = ctl.numpy().astype(np.int64)
    count = int(np.count_nonzero(raw))
    per_step = None if per_step_len is None else \
        torch.full((per_step_len,), -1, dtype=torch.int32)
    bc.chain_tally_plain(ctl, flags, n, per_step)
    want[bc.C_NCONF] = (want[bc.C_NCONF] + count) & 0xFFFFFFFF
    want[bc.C_STEP] = 4
    want[bc.C_KEY:bc.C_KEY + 2] = want[bc.C_NEXT:bc.C_NEXT + 2]
    want[bc.C_RK:bc.C_RK + 8] = jax_randint_keys(want[bc.C_NEXT:bc.C_NEXT + 2])
    np.testing.assert_array_equal(ctl.numpy().astype(np.int64), want)
    if per_step is not None:
        expect = [-1] * per_step_len
        if per_step_len > 3:
            expect[3] = count
        assert per_step.tolist() == expect


@pytest.mark.cuda
@pytest.mark.parametrize("offset", (0, 1))
@pytest.mark.parametrize("n", TALLY_LENGTHS)
def test_chain_tally_kernel_matches_plain_at_edges(cuda, n, offset):
    """K10 against its plain version at the edge lengths, on flags that
    start 16-byte aligned and one byte off, with a per_step that holds
    the step and one that is too short."""
    for per_step_len in (8, 3):
        outs = []
        for dev in ("cpu", cuda):
            ctl, _raw, flags = tally_case(n, offset)
            if dev != "cpu":
                ctl, flags = ctl.to(dev), _offset_on(flags, offset, dev)
            per_step = torch.full((per_step_len,), -1, dtype=torch.int32,
                                  device=dev)
            before = bc.launches["chain_tally"]
            bc.chain_tally(ctl, flags, n, per_step)
            assert bc.launches["chain_tally"] == before + (dev != "cpu")
            outs.append((ctl.cpu(), per_step.cpu()))
        assert torch.equal(outs[0][0], outs[1][0])
        assert torch.equal(outs[0][1], outs[1][1])


def _offset_on(flags, offset, dev):
    """The flags on the card as a view `offset` bytes into a buffer
    whose start is 16-byte aligned."""
    buf = torch.zeros(flags.shape[0] + 32, dtype=torch.bool, device=dev)
    assert buf.data_ptr() % 16 == 0
    view = buf[offset:offset + flags.shape[0]]
    view.copy_(flags.to(dev))
    assert view.data_ptr() % 16 == offset
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("interval", (False, True))
def test_chain_kernels_match_plain_on_the_card(cuda, interval):
    """K9 and K10 bit-exact against their plain versions over 8 chained
    steps from a well-formed control block, at 1, 7, 300 and 16,384
    slots and keyspaces 1, 2^16+1, 2^31-1: K9 storing whole rows into
    fresh buffers on the first step, then only the id words."""
    for slots, keyspace in ((1, 1), (7, 2**16 + 1), (300, 4_000_000),
                            (16384, 4_000_000), (16384, 2**31 - 1)):
        width = N_WORDS + 1
        ctl = bc.chain_ctl(bc.prng_key(7))
        outs = {}
        for dev in ("cpu", cuda):
            c = ctl.clone().to(dev)
            rows = [torch.zeros((slots, width), dtype=torch.uint32,
                                device=dev) for _ in range(4)]
            if not interval:
                rows[1] = rows[3] = None
            snap = torch.zeros(slots, dtype=torch.int32, device=dev)
            commit = torch.zeros((), dtype=torch.int32, device=dev)
            oldest = torch.zeros((), dtype=torch.int32, device=dev)
            per_step = torch.zeros(8, dtype=torch.int32, device=dev)
            seen = []
            for step in range(8):
                bc.chain_gen(c, rows[0], rows[1], rows[2], rows[3], snap,
                             commit, oldest, keyspace, whole=step == 0)
                conflict = (rows[0][:, width - 2].to(torch.int64) & 1) == 1
                bc.chain_tally(c, conflict, slots, per_step)
                seen.append([t.cpu().clone() for t in rows if t is not None]
                            + [snap.cpu().clone(), commit.cpu().clone(),
                               oldest.cpu().clone(), c.cpu().clone()])
            outs[str(dev)] = (seen, per_step.cpu())
        (a, pa), (b, pb) = outs.values()
        for sa, sb in zip(a, b):
            for x, y in zip(sa, sb):
                assert torch.equal(x, y)
        assert torch.equal(pa, pb)
