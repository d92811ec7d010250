"""The slice as a whole at a small size: the commit leg
(`foundationdb_tpu_torch.testing.commit_leg`) run once over the port
(its `Resolver` on `cuda` at `device="cpu"`, its TLog, storage servers
and engines) and once over the reference (its `Resolver` on `tpu`, JAX
on the CPU, and its TLog, storage servers and engines), each under its
own scheduler in turn, at the same seed: 6 batches of 64 transactions
over 3,000 keys, 2 storage tags, a power loss of the log's and every
storage machine. Inside each run every read is held to the plain dict
of that run's verdicts; here the verdicts, the TLog's commit replies,
the durable versions, the log's versions left after the pops, every
read reply and every read after the recovery must be equal between the
packages. The `cuda`-marked twin runs the port's resolver on the card.
"""

import importlib
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from foundationdb_tpu_torch import testing as tg  # noqa: E402

REF = "foundationdb_tpu"
N_BATCHES, N_TXNS, N_KEYS = 6, 64, 3000
# 2,000,000 versions a batch: the default 5,000,000-version durability
# lag then lets the storage servers make the first batches durable and
# pop the log within the 6 batches
STEP = 2_000_000
SEED = int(np.random.default_rng(20261017 + 12).integers(1, 2**31 - 1))


def ref_package():
    mod = importlib.import_module
    return SimpleNamespace(
        flow=mod(f"{REF}.flow"), rpc=mod(f"{REF}.rpc"),
        types=mod(f"{REF}.server.types"), tlog=mod(f"{REF}.server.tlog"),
        storage=mod(f"{REF}.server.storage"),
        kvstore=mod(f"{REF}.server.kvstore"),
        proxy=mod(f"{REF}.server.proxy"),
        role=mod(f"{REF}.server.resolver_role"), models=mod(f"{REF}.models"))


def leg(P, backend, **kw):
    ids = np.random.default_rng(SEED).integers(
        0, N_KEYS, size=(N_BATCHES, 2 * N_TXNS), dtype=np.int64)
    versions = [STEP * (i + 1) for i in range(N_BATCHES)]
    return tg.commit_leg(P, backend, ids, versions, STEP,
                         split_ids=[N_KEYS // 2], read_at=N_BATCHES - 3,
                         n_sample=256, page_rows=100, seed=SEED, **kw)


def check_against_reference(device):
    ref = leg(ref_package(), "tpu")
    port = leg(tg.leg_package(), "cuda",
               resolver_kwargs={"device": device})
    assert port["log"] == ref["log"]
    assert port["committed"] == ref["committed"] < N_BATCHES * N_TXNS
    log = ref["log"]
    assert min(log["durable"]) >= STEP     # storage made batches durable
    assert len(log["log_left"]) < N_BATCHES   # ... and popped the log
    assert log["recovered"] == log["reads"]
    assert len([kv for rows in log["reads"][0] for kv in rows]) == \
        port["rows"] > 0
    fo = port["resolver"].failover_stats()
    assert not fo.get("failovers") and not fo.get("device_faults")


def test_leg_matches_reference_read_for_read():
    check_against_reference("cpu")


def test_leg_catches_a_lost_write(monkeypatch):
    """The leg's own check fails when storage drops a committed write:
    a StorageServer that skips every 50th mutation it pulls."""
    from foundationdb_tpu_torch.server import storage
    orig = storage.StorageServer._partition
    seen = [0]

    def lossy(self, version, mutations):
        out = []
        for m in orig(self, version, mutations):
            seen[0] += 1
            if seen[0] % 50:
                out.append(m)
        return tuple(out)

    monkeypatch.setattr(storage.StorageServer, "_partition", lossy)
    with pytest.raises(AssertionError, match="commit leg reads"):
        leg(tg.leg_package(), "cuda", resolver_kwargs={"device": "cpu"})


def test_leg_keys_and_model():
    keys = tg.leg_keys([0, 1, 2**40 + 7], 16)
    assert keys == [bytes(16), bytes(15) + b"\x01",
                    bytes(10) + b"\x01" + bytes(4) + b"\x07"]
    assert sorted(keys) == keys
    P = tg.leg_package()
    ids = np.array([[5, 9, 6, 9, 9, 7]], np.int64)
    reqs = tg.leg_requests(P, ids, [100], 10, 16)
    COMMITTED = P.models.COMMITTED
    other = 1 - COMMITTED
    (k9,) = tg.leg_keys([9], 16)
    stamp = P.proxy.make_versionstamp
    # a later transaction's write wins within a batch
    assert tg.leg_model(reqs, [[COMMITTED] * 3], COMMITTED, 0)[k9] == \
        stamp(100, 1)
    # a conflicted transaction's write is not there
    model = tg.leg_model(reqs, [[COMMITTED, other, other]], COMMITTED, 0)
    assert model == {k9: stamp(100, 0)}
    assert reqs[0].transactions[1].read_conflict_ranges == (
        (tg.leg_keys([6], 16)[0], tg.leg_keys([6], 16)[0] + b"\x00"),)


@pytest.mark.cuda
def test_leg_on_card_matches_reference():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    check_against_reference(None)
