"""The per-device sharded resolver on the card: K8e and K8f (B11's step
split at its cross-shard combine, csrc/shard_step.cu) against their plain versions
on the adversarial batch kinds of `foundationdb_tpu_torch.testing` at
four shards and on the clip-edge kind at three key widths, packed and
unpacked, attributed and not, fresh and one step on; and four logical
devices of one card ([cuda:0] * 4) against the lockstep K8 over a
pipelined stream under both feeds, with the port's `dryrun_multichip`
there. Every output is integer or boolean: equality is exact. Every
case needs a card and skips without one; the CPU cases, which hold the
port to the reference package, are in test_torch_sharded_devices.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import testing as tg  # noqa: E402
from foundationdb_tpu_torch.flow.knobs import SERVER_KNOBS  # noqa: E402
from foundationdb_tpu_torch.models import ResolverTransaction  # noqa: E402
from foundationdb_tpu_torch.ops import conflict_kernel as ck  # noqa: E402
from foundationdb_tpu_torch.ops import keys, rmq  # noqa: E402
from foundationdb_tpu_torch.parallel import (  # noqa: E402
    ShardedCudaConflictSet,
    dryrun_multichip,
)
from foundationdb_tpu_torch.testing import rand_batches  # noqa: E402

KIND_SHAPE = (1024, 32, 64, 64)  # cap, T, R, Wr


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def knobs():
    saved = {k: int(getattr(SERVER_KNOBS, k)) for k in
             ("interval_packed_feed", "resolve_pipeline_depth")}
    yield SERVER_KNOBS
    for k, v in saved.items():
        SERVER_KNOBS.set(k, v)


def kind_case(kind, n_shards, n_words=2, seed=0):
    """A kind's batch on its history sharded at the quantiles of the
    kind's keys: (HK[S], HV[S], lows, highs, arrays, T, R, Wr)."""
    cap, T, R, Wr = KIND_SHAPE
    splits = tg.split_ids(4 * T, n_shards)
    hk, hv, arrays = tg.adversarial_batch(
        np.random.default_rng(seed), kind, cap, T, R, Wr, n_words,
        splits=splits or None)
    lows, highs = tg.shard_bounds(splits, n_words)
    shk, shv = tg.shard_history(hk, hv, lows, highs)
    return shk, shv, lows, highs, arrays, T, R, Wr


def _run_pipelined(cs, batches, window=4):
    got, pending = [], []
    for b, v, o in batches:
        pending.append(cs.submit(b, v, o, attribute=True))
        if len(pending) >= window:
            got.append(cs.drain_with_attribution(pending.pop(0)))
    got.extend(cs.drain_with_attribution(t) for t in pending)
    return got


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _split_on_card(cuda, case):
    """K8e and K8f on the card, packed and unpacked, attributed and not,
    against their plain versions, one shard a logical device of the
    card, fresh and one step on; each K8e and K8f counted once, and K1,
    K2 and K7, whose work K8e runs inside its own kernel, not at all."""
    shk, shv, lows, highs, arrays, T, R, Wr = case
    n = shk.shape[0]
    lows_t, highs_t = torch.from_numpy(lows), torch.from_numpy(highs)
    for attribute in (True, False):
        state = (torch.from_numpy(shk), torch.from_numpy(shv))
        for commit in (tg.COMMIT, tg.COMMIT + 20):
            buf = torch.from_numpy(ck.pack_interval_batch(*arrays, commit,
                                                          tg.OLDEST))
            unpacked = ck.interval_unpack(buf, T, R, Wr, shk.shape[-1] - 1)
            want_ext = torch.stack([ck.resolve_shard_ext_plain(
                state[0][i], state[1][i], *unpacked, lows_t[i], highs_t[i])
                for i in range(n)])
            want = [ck.resolve_shard_finish_plain(
                state[0][i], state[1][i], *unpacked, lows_t[i], highs_t[i],
                want_ext, attribute) for i in range(n)]
            dk, dv = state[0].to(cuda), state[1].to(cuda)
            dl, dh = lows_t.to(cuda), highs_t.to(cuda)
            dbuf = buf.to(cuda)
            dun = [x.to(cuda) for x in unpacked]
            for packed in (True, False):
                before = dict(ck.launches)
                fused = (keys.launches["searchsorted_i32"],
                         rmq.launches["range_max"],
                         keys.launches["shard_clip"])
                exts = []
                scr = [ck.shard_scratch(dk[i], T, R, Wr) for i in range(n)]
                for i in range(n):
                    if packed:
                        exts.append(ck.resolve_shard_ext_packed(
                            dk[i], dv[i], dbuf, dl[i], dh[i], T, R, Wr,
                            scratch=scr[i]))
                    else:
                        exts.append(ck.resolve_shard_ext(
                            dk[i], dv[i], *dun, dl[i], dh[i],
                            scratch=scr[i]))
                ext_all = torch.stack(exts)
                assert torch.equal(ext_all.cpu(), want_ext)
                for i in range(n):
                    if packed:
                        got = ck.resolve_shard_finish_packed(
                            dk[i], dv[i], dbuf, dl[i], dh[i], ext_all, T, R,
                            Wr, attribute=attribute, scratch=scr[i])
                    else:
                        got = ck.resolve_shard_finish(
                            dk[i], dv[i], *dun, dl[i], dh[i], ext_all,
                            attribute=attribute, scratch=scr[i])
                    for g, w in zip(got, want[i]):
                        assert (g is None) == (w is None)
                        if g is not None:
                            assert torch.equal(g.cpu(), w)
                assert ck.launches["resolve_shard_ext"] == \
                    before["resolve_shard_ext"] + n
                assert ck.launches["resolve_shard_finish"] == \
                    before["resolve_shard_finish"] + n
                assert (keys.launches["searchsorted_i32"],
                        rmq.launches["range_max"],
                        keys.launches["shard_clip"]) == fused
            state = (torch.stack([w[0] for w in want]),
                     torch.stack([w[1] for w in want]))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", tg.KINDS)
def test_split_kernels_match_plain_on_kinds(cuda, kind):
    _split_on_card(cuda, kind_case(kind, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("n_words", [4, 12, 40])
def test_split_kernels_match_plain_at_clip_edges(cuda, n_words):
    _split_on_card(cuda, kind_case("clip_edges", 4, n_words, seed=n_words))


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [1, 0], ids=["packed", "unpacked"])
def test_logical_devices_match_lockstep_on_card(cuda, packed, knobs):
    knobs.set("interval_packed_feed", packed)
    knobs.set("resolve_pipeline_depth", 4)
    batches = [([ResolverTransaction(*t) for t in b], v, o)
               for b, v, o in rand_batches(5, 30)]
    lock = ShardedCudaConflictSet(n_shards=4, device=cuda)
    card = ShardedCudaConflictSet(devices=[cuda] * 4)
    want = [lock.resolve_with_attribution(b, v, o) for b, v, o in batches]
    before = dict(ck.launches)
    assert _run_pipelined(card, batches) == want
    n = sum(1 for b, _v, _o in batches if b)
    assert ck.launches["resolve_shard_ext"] - before["resolve_shard_ext"] \
        == 4 * n
    hk, hv = card._host_state()
    assert np.array_equal(hk, lock._hk.cpu().numpy())
    assert np.array_equal(hv, lock._hv.cpu().numpy())
    assert card.kernel_stats()["platform"] == "gpu"
    assert dryrun_multichip(4, devices=[cuda] * 4) >= 126
